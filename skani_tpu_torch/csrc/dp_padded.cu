// Banded chaining DP over the padded, transposed chunk layout (sm_90a).
//
// skt_dp_chain replaces skani_tpu/kernels/dp_pallas.py dp_chain (K10:
// _dp_pallas, _dp_kernel) and skt_dp_chain_packed replaces dp_chain_packed
// (K9: _dp_pallas_packed, _dp_kernel_packed).  Arrays are (L, RC): row t
// is the anchor index within a chunk, column ("lane") one chunk.  The
// recurrence follows the TPU kernels step for step (reference:
// src/chain.rs:838-896), in wrapping int32:
//
//   unpacked: d_q = qp_i - qp_j; same contig and orientation =
//             (rcv_i >> 1) == (rcv_j >> 1); valid = bit 0 of rcv
//   packed:   d_q = (qprv_i >> 2) - (qprv_j >> 2); same orientation = equal
//             bit 1 of qprv; valid = bit 0 of qprv; the ref contig rides in
//             rprc = rc << 25 | rp, so a contig change fails the d_r tests
//   d_r  = +-(rp_i - rp_j) by rev_i
//   ok   = same AND both valid, 0 != d_q <= pcl, rp_i != rp_j,
//          d_q, d_r <= D_MAX_LIN_LENGTH, d_r > 0, |d_r - d_q| <= max_gap,
//          slot_j >= max(t - band, 0)
//   comb = ok ? (anchor_score - gap + dp_j) * RING + rel_j : NEGI,
//          rel_j = slot_j - (t - RING)
//   best = max(comb); take = (best >> RING_SHIFT) > 0; the unique best slot
//          (the most recent among equal scores) donates root and depth; an
//          anchor that does not take is its own root (its row t).
//   out  = unpacked: dd = dp << DBITS | depth, root;
//          packed:   dp << 2*EBITS | depth << EBITS | root.
// Every (t, lane) is written, invalid anchors too (dp 0, depth 0, root t).
//
// Bound: a lane is a sequential chain of L steps with a ring of candidates
// per step: the issue rate of the per-step int32 work, not bytes.  Both
// kernels give a lane one WARP and a block 8 adjacent lanes; in the
// transposed layout a lane's anchors are RC words apart, so the block moves
// 32 rows at a time through shared memory: a row of 8 lanes is one 32-byte
// sector, read and written whole.  The next 32-row tile is copied into the
// other half of a double buffer with cp.async while the current tile's
// steps run.
//
// Both run the wide ring and step of dp_ring.cuh (a band-sized ring of
// ceil(band / 32) registers a thread, steps for valid anchors only, the
// TPU's winner), under a layout policy each:
//   K10 (dp_chain_kernel): a = qp, b = rp, c = rcv; same contig,
//       orientation and both valid is one equality rcv_j == rcv_i (rcv_i
//       valid); root and depth carried apart.
//   K9 (dp_chain_packed_kernel): a = qprv, b = rprc, no third plane; same
//       orientation and slot j valid is ((qprv_i ^ qprv_j) & 3) == 0
//       (qprv_i valid); root and depth ride in one word, depth << EBITS |
//       root, one hop deeper by adding 1 << EBITS.
#include "dp_ring.cuh"

namespace {

using namespace skt;

constexpr int kLanes = 8;       // lanes (warps) per block
constexpr int kRows = 32;       // rows per shared-memory tile
constexpr int kPad = kLanes + 1;  // row stride: column reads hit 32 banks

// 4-byte asynchronous copy global -> shared; `in` false fills a zero
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K10's layout policy: a = qp, b = rp, c = rcv
struct Padded {
  static constexpr int kPlanes = 3, kOuts = 2;
  struct Pay {
    int root, dep;
    static __device__ __forceinline__ Pay own(int root) { return {root, 0}; }
    __device__ __forceinline__ Pay next(int src, const StepConst&) const {
      return {__shfl_sync(kFull, root, src),
              __shfl_sync(kFull, dep, src) + 1};
    }
  };
  static __device__ __forceinline__ int qp(int a) { return a; }
  static __device__ __forceinline__ bool rev(int, int c) {
    return (c & 2) != 0;
  }
  static __device__ __forceinline__ bool valid(int, int c) {
    return (c & 1) != 0;
  }
  static __device__ __forceinline__ bool same(int, int c_i, int, int c_j) {
    return c_j == c_i;
  }
  static __device__ __forceinline__ void clear(int&, int& c) { c = 0; }
  // dd = dp << DBITS | depth, root
  static __device__ __forceinline__ void put(int32_t* s0, int32_t* s1, int i,
                                             int dp, const Pay& pay,
                                             int bits) {
    s0[i] = wshl(dp, bits) | pay.dep;
    s1[i] = pay.root;
  }
};

// K9's layout policy: a = qprv, b = rprc (no third plane)
struct Packed {
  static constexpr int kPlanes = 2, kOuts = 1;
  struct Pay {
    int w;  // depth << EBITS | root
    static __device__ __forceinline__ Pay own(int root) { return {root}; }
    __device__ __forceinline__ Pay next(int src, const StepConst& g) const {
      return {wadd(__shfl_sync(kFull, w, src), g.pay_one)};
    }
  };
  static __device__ __forceinline__ int qp(int a) { return a >> 2; }
  static __device__ __forceinline__ bool rev(int a, int) {
    return (a & 2) != 0;
  }
  static __device__ __forceinline__ bool valid(int a, int) {
    return (a & 1) != 0;
  }
  static __device__ __forceinline__ bool same(int a_i, int, int a_j, int) {
    return ((a_i ^ a_j) & 3) == 0;
  }
  static __device__ __forceinline__ void clear(int& a, int&) { a = 0; }
  // ddr = dp << 2*EBITS | depth << EBITS | root
  static __device__ __forceinline__ void put(int32_t* s0, int32_t*, int i,
                                             int dp, const Pay& pay,
                                             int bits) {
    s0[i] = wshl(dp, 2 * bits) | pay.w;
  }
};

// One block: 8 lanes (a warp each), NREG registers of ring slots a thread
// (ring length 32 * NREG >= band), the planes and outputs of policy P.
template <int NREG, class P>
__device__ __forceinline__ void padded_dp(
    const int32_t* __restrict__ p0, const int32_t* __restrict__ p1,
    const int32_t* __restrict__ p2, int32_t* __restrict__ o0,
    int32_t* __restrict__ o1, int L, int RC, const StepConst& g, int bits) {
  constexpr int NP = P::kPlanes, NO = P::kOuts;
  __shared__ int32_t s_in[2][NP][kRows * kPad];
  __shared__ int32_t s_out[NO][kRows * kPad];
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int lane0 = blockIdx.x * kLanes;
  const int c_row = threadIdx.x / kLanes;
  const int c_lane = threadIdx.x % kLanes;
  const bool c_ok = lane0 + c_lane < RC;
  const int si = c_row * kPad + c_lane;
  const int ri = lid * kPad + warp;
  const int32_t* planes[3] = {p0, p1, p2};
  int32_t* outs[2] = {o0, o1};

  // copy rows t0 .. t0+31 of the block's lanes into buffer b
  auto fetch = [&](int t0, int b) {
    const int t = t0 + c_row;
    const bool in = c_ok && t < L;
    const int64_t off = in ? (int64_t)t * RC + lane0 + c_lane : 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) cp_async4(&s_in[b][p][si], planes[p] + off, in);
    cp_async_commit();
  };

  Ring<NREG, P> rg;

  fetch(0, 0);
  for (int tq = 0; tq < L; tq += kRows * NREG) {
#pragma unroll
    for (int K = 0; K < NREG; ++K) {
      const int t0 = tq + kRows * K;
      if (t0 >= L) break;  // uniform
      const int b = (t0 / kRows) & 1;
      // the copy into the other buffer starts once the previous tile's
      // second barrier has ended every read of it
      if (t0 + kRows < L) {
        fetch(t0 + kRows, b ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int ca = s_in[b][0][ri];
      const int cc = NP > 2 ? s_in[b][NP - 1][ri] : 0;
      int out_s;
      typename P::Pay out;
      rg.tile(K, lid, min(kRows, L - t0), ca, s_in[b][1][ri], cc,
              P::valid(ca, cc), g, t0, out_s, out);
      P::put(s_out[0], s_out[NO - 1], ri, out_s, out, bits);
      __syncthreads();
      const int t = t0 + c_row;
      if (c_ok && t < L) {
        const int64_t off = (int64_t)t * RC + lane0 + c_lane;
#pragma unroll
        for (int o = 0; o < NO; ++o) outs[o][off] = s_out[o][si];
      }
    }
  }
}

// K10: planes qp, rp, rcv; outputs dd and root
template <int NREG>
__global__ void __launch_bounds__(kLanes * 32)
dp_chain_kernel(const int32_t* __restrict__ qp,
                const int32_t* __restrict__ rp,
                const int32_t* __restrict__ rcv, int32_t* __restrict__ dd,
                int32_t* __restrict__ root, int L, int RC, int band, int pcl,
                int max_gap, int anchor_score, int bits, int ring,
                int ring_shift) {
  padded_dp<NREG, Padded>(
      qp, rp, rcv, dd, root, L, RC,
      step_const(band, pcl, max_gap, anchor_score, ring, ring_shift), bits);
}

// K9: planes qprv, rprc; output ddr
template <int NREG>
__global__ void __launch_bounds__(kLanes * 32)
dp_chain_packed_kernel(const int32_t* __restrict__ qprv,
                       const int32_t* __restrict__ rprc,
                       int32_t* __restrict__ ddr, int L, int RC, int band,
                       int pcl, int max_gap, int anchor_score, int ebits,
                       int ring, int ring_shift) {
  padded_dp<NREG, Packed>(
      qprv, rprc, nullptr, ddr, nullptr, L, RC,
      step_const(band, pcl, max_gap, anchor_score, ring, ring_shift,
                 1 << ebits),
      ebits);
}

}  // namespace

extern "C" int skt_dp_chain(const void* qp, const void* rp, const void* rcv,
                            void* dd, void* root, int L, int RC, int band,
                            int pcl, int max_gap, int anchor_score,
                            int dbits, int ring, int ring_shift, int nreg,
                            void* stream) {
  // refused, never run
  if (ring > 256 || !nreg_ok(nreg, band)) return (int)cudaErrorInvalidValue;
  if (L <= 0 || RC <= 0) return (int)cudaGetLastError();
  const int blocks = (RC + kLanes - 1) / kLanes;
#define SKT_CHAIN(N)                                                       \
  case N:                                                                  \
    dp_chain_kernel<N><<<blocks, kLanes * 32, 0, (cudaStream_t)stream>>>(  \
        (const int32_t*)qp, (const int32_t*)rp, (const int32_t*)rcv,       \
        (int32_t*)dd, (int32_t*)root, L, RC, band, pcl, max_gap,           \
        anchor_score, dbits, ring, ring_shift);                            \
    break
  switch (nreg) {
    SKT_CHAIN(1); SKT_CHAIN(2); SKT_CHAIN(3); SKT_CHAIN(4);
    SKT_CHAIN(5); SKT_CHAIN(6); SKT_CHAIN(7); SKT_CHAIN(8);
  }
#undef SKT_CHAIN
  return (int)cudaGetLastError();
}

extern "C" int skt_dp_chain_packed(const void* qprv, const void* rprc,
                                   void* ddr, int L, int RC, int band,
                                   int pcl, int max_gap, int anchor_score,
                                   int ebits, int ring, int ring_shift,
                                   int nreg, void* stream) {
  // refused, never run
  if (ring > 256 || !nreg_ok(nreg, band)) return (int)cudaErrorInvalidValue;
  if (L <= 0 || RC <= 0) return (int)cudaGetLastError();
  const int blocks = (RC + kLanes - 1) / kLanes;
#define SKT_PACKED(N)                                                      \
  case N:                                                                  \
    dp_chain_packed_kernel<N>                                              \
        <<<blocks, kLanes * 32, 0, (cudaStream_t)stream>>>(                \
            (const int32_t*)qprv, (const int32_t*)rprc, (int32_t*)ddr, L,  \
            RC, band, pcl, max_gap, anchor_score, ebits, ring, ring_shift); \
    break
  switch (nreg) {
    SKT_PACKED(1); SKT_PACKED(2); SKT_PACKED(3); SKT_PACKED(4);
    SKT_PACKED(5); SKT_PACKED(6); SKT_PACKED(7); SKT_PACKED(8);
  }
#undef SKT_PACKED
  return (int)cudaGetLastError();
}
