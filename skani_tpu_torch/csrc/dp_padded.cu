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
// sector, read and written whole.  An invalid anchor has no transition, so
// its step skips the candidates, and a 32-row tile with no valid anchor in
// the lane skips its steps (it only marks its ring slots invalid).
//
// K9 (packed) keeps the ring of RING slots in registers as dp_compact.cu's
// K3 does (slot s in thread s & 31, register s >> 5; a step updates its
// slot by selects over every register) and loads each tile synchronously.
//
// K10 (unpacked) runs the wide ring and step of dp_ring.cuh (band-sized
// ring, valid rows only, the same winner) on the slot words a = qp, b = rp,
// c = rcv (same contig, orientation and both valid is one equality rcv_j ==
// rcv_i, rcv_i being valid), root and depth carried apart; the next 32-row
// tile is copied into the other half of a double buffer with cp.async
// while the current tile's steps run.
#include "dp_ring.cuh"

namespace {

using namespace skt;

constexpr int kLanes = 8;       // lanes (warps) per block
constexpr int kRows = 32;       // rows per shared-memory tile
constexpr int kPad = kLanes + 1;  // row stride: column reads hit 32 banks

// K9: planes qprv, rprc, one output (ddr)
template <int SLOTS>
__global__ void __launch_bounds__(kLanes * 32)
dp_packed_kernel(const int32_t* __restrict__ pa,
                 const int32_t* __restrict__ pb, int32_t* __restrict__ out0,
                 int L, int RC, int band, int pcl, int max_gap,
                 int anchor_score, int bits, int ring, int ring_shift) {
  __shared__ int32_t s_in[2][kRows * kPad];
  __shared__ int32_t s_out[kRows * kPad];
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int lane0 = blockIdx.x * kLanes;
  // the cooperative tile copy: thread -> (row, lane) of the tile
  const int c_row = threadIdx.x / kLanes;
  const int c_lane = threadIdx.x % kLanes;
  const bool c_ok = lane0 + c_lane < RC;
  // ring < 32 only with SLOTS == 1: the upper threads hold no slot
  const bool holds = lid < ring;

  // this thread's ring slots: register k holds slot k * 32 + lid; the
  // valid bit is bit 0 of aw
  int dpw[SLOTS], aw[SLOTS], bw[SLOTS], rootw[SLOTS], depw[SLOTS],
      slotw[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    dpw[k] = aw[k] = bw[k] = rootw[k] = depw[k] = 0;
    slotw[k] = -(1 << 29);
  }

  for (int t0 = 0; t0 < L; t0 += kRows) {
    {
      const int t = t0 + c_row;
      const bool in = c_ok && t < L;
      const int64_t off = (int64_t)t * RC + lane0 + c_lane;
      const int si = c_row * kPad + c_lane;
      s_in[0][si] = in ? pa[off] : 0;
      s_in[1][si] = in ? pb[off] : 0;
    }
    __syncthreads();
    const int ri = lid * kPad + warp;
    const int ac = s_in[0][ri];
    const int bc = s_in[1][ri];
    const int nsteps = min(kRows, L - t0);
    const unsigned any_valid = __ballot_sync(kFull, lid < nsteps && (ac & 1));
    int out_a = 0;
    if (any_valid == 0) {
      // no valid anchor in this lane's tile: every step is dp 0, depth 0,
      // root t, and the tile's ring slots turn invalid (32 consecutive
      // slots: one register of every thread, or the whole short ring)
      const int k_tile = (t0 & (ring - 1)) >> 5;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (k == k_tile) aw[k] = 0;
      }
      out_a = t0 + lid;
    } else {
      for (int j = 0; j < nsteps; ++j) {
        const int t = t0 + j;
        const int a_i = __shfl_sync(kFull, ac, j);
        const int b_i = __shfl_sync(kFull, bc, j);
        int dp_t = 0, root_t = t, dep_t = 0;
        if (a_i & 1) {  // uniform across the warp
          const int qp_i = a_i >> 2;
          const bool rev_i = (a_i >> 1) & 1;
          const int lo_slot = max(t - band, 0);
          int my_best = kNegI, my_root = 0, my_dep = 0;
          bool my_ok = false;
#pragma unroll
          for (int k = 0; k < SLOTS; ++k) {
            const int qp_j = aw[k] >> 2;
            const int d_q = wsub(qp_i, qp_j);
            const int d_r_f = wsub(b_i, bw[k]);
            const int d_r = rev_i ? wsub(0, d_r_f) : d_r_f;
            const int gap = wabs(wsub(d_r, d_q));
            const bool same =
                ((aw[k] ^ a_i) & 2) == 0 && (aw[k] & a_i & 1) == 1;
            const bool ok = holds && same
                && d_q <= pcl && d_q != 0
                && b_i != bw[k]
                && d_q <= kDMaxLin && d_r <= kDMaxLin
                && d_r > 0
                && gap <= max_gap
                && slotw[k] >= lo_slot;
            const int rel = wsub(slotw[k], t - ring);
            const int cand = wadd(wsub(anchor_score, gap), dpw[k]);
            const int comb = ok ? wadd(wmul(cand, ring), rel) : kNegI;
            // comb is unique among ok slots (rel is), so > keeps one winner
            if (ok && (!my_ok || comb > my_best)) {
              my_best = comb;
              my_root = rootw[k];
              my_dep = depw[k];
              my_ok = true;
            }
          }
          const int best = __reduce_max_sync(kFull, my_best);
          const int best_val = best >> ring_shift;
          const bool take = best_val > 0;
          const unsigned win_mask =
              __ballot_sync(kFull, my_ok && my_best == best);
          const int win = win_mask ? __ffs(win_mask) - 1 : 0;
          const int root_w = __shfl_sync(kFull, my_root, win);
          const int dep_w = __shfl_sync(kFull, my_dep, win);
          dp_t = take ? best_val : 0;
          root_t = take ? root_w : t;
          dep_t = take ? dep_w + 1 : 0;
        }
        if (lid == j) {
          out_a = wshl(dp_t, 2 * bits) | wshl(dep_t, bits) | root_t;
        }
        // the step's slot: selects, not branches, so the unrolled
        // registers are never indexed dynamically
        const int slot = t & (ring - 1);
        const bool mine = lid == (slot & 31);
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
          const bool w = mine && k == (slot >> 5);
          dpw[k] = w ? dp_t : dpw[k];
          aw[k] = w ? a_i : aw[k];
          bw[k] = w ? b_i : bw[k];
          rootw[k] = w ? root_t : rootw[k];
          depw[k] = w ? dep_t : depw[k];
          slotw[k] = w ? t : slotw[k];
        }
      }
    }
    s_out[ri] = out_a;
    __syncthreads();
    {
      const int t = t0 + c_row;
      if (c_ok && t < L) {
        const int64_t off = (int64_t)t * RC + lane0 + c_lane;
        out0[off] = s_out[c_row * kPad + c_lane];
      }
    }
  }
}

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
  struct Pay {
    int root, dep;
    static __device__ __forceinline__ Pay own(int root) { return {root, 0}; }
    __device__ __forceinline__ Pay next(int src) const {
      return {__shfl_sync(kFull, root, src),
              __shfl_sync(kFull, dep, src) + 1};
    }
  };
  static __device__ __forceinline__ int qp(int a) { return a; }
  static __device__ __forceinline__ bool rev(int, int c) {
    return (c & 2) != 0;
  }
  static __device__ __forceinline__ bool same(int, int c_i, int, int c_j) {
    return c_j == c_i;
  }
  static __device__ __forceinline__ void clear(int&, int& c) { c = 0; }
};

// K10: planes qp, rp, rcv; outputs dd and root.  NREG registers of ring
// slots a thread, ring length 32 * NREG >= band.
template <int NREG>
__global__ void __launch_bounds__(kLanes * 32)
dp_chain_kernel(const int32_t* __restrict__ qp,
                const int32_t* __restrict__ rp,
                const int32_t* __restrict__ rcv, int32_t* __restrict__ dd,
                int32_t* __restrict__ root, int L, int RC, int band, int pcl,
                int max_gap, int anchor_score, int bits, int ring,
                int ring_shift) {
  __shared__ int32_t s_in[2][3][kRows * kPad];
  __shared__ int32_t s_out[2][kRows * kPad];
  const int warp = threadIdx.x >> 5;
  const int lid = threadIdx.x & 31;
  const int lane0 = blockIdx.x * kLanes;
  const int c_row = threadIdx.x / kLanes;
  const int c_lane = threadIdx.x % kLanes;
  const bool c_ok = lane0 + c_lane < RC;
  const int si = c_row * kPad + c_lane;
  const int ri = lid * kPad + warp;

  // copy rows t0 .. t0+31 of the block's lanes into buffer b
  auto fetch = [&](int t0, int b) {
    const int t = t0 + c_row;
    const bool in = c_ok && t < L;
    const int64_t off = in ? (int64_t)t * RC + lane0 + c_lane : 0;
    cp_async4(&s_in[b][0][si], qp + off, in);
    cp_async4(&s_in[b][1][si], rp + off, in);
    cp_async4(&s_in[b][2][si], rcv + off, in);
    cp_async_commit();
  };

  const StepConst g =
      step_const(band, pcl, max_gap, anchor_score, ring, ring_shift);
  Ring<NREG, Padded> rg;

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
      const int cc = s_in[b][2][ri];
      int out_s;
      Padded::Pay out;
      rg.tile(K, lid, min(kRows, L - t0), s_in[b][0][ri], s_in[b][1][ri], cc,
              (cc & 1) != 0, g, t0, out_s, out);
      s_out[0][ri] = wshl(out_s, bits) | out.dep;
      s_out[1][ri] = out.root;
      __syncthreads();
      const int t = t0 + c_row;
      if (c_ok && t < L) {
        const int64_t off = (int64_t)t * RC + lane0 + c_lane;
        dd[off] = s_out[0][si];
        root[off] = s_out[1][si];
      }
    }
  }
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
                                   void* stream) {
  if (L <= 0 || RC <= 0) return (int)cudaGetLastError();
  const int blocks = (RC + kLanes - 1) / kLanes;
#define SKT_PACKED(SLOTS)                                                  \
  dp_packed_kernel<SLOTS><<<blocks, kLanes * 32, 0, (cudaStream_t)stream>>>( \
      (const int32_t*)qprv, (const int32_t*)rprc, (int32_t*)ddr, L, RC,    \
      band, pcl, max_gap, anchor_score, ebits, ring, ring_shift)
  if (ring <= 32) SKT_PACKED(1);
  else if (ring == 64) SKT_PACKED(2);
  else if (ring == 128) SKT_PACKED(4);
  else if (ring == 256) SKT_PACKED(8);
  else return (int)cudaErrorInvalidValue;  // RING > 256: refused, never run
#undef SKT_PACKED
  return (int)cudaGetLastError();
}
