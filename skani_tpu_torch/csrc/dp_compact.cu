// Banded chaining DP over the compact anchor stream (sm_90a).
//
// skt_dp_chain_compact replaces skani_tpu/kernels/dp_compact.py
// dp_chain_compact (K3: _kernel and the _run_compact layout), and
// skt_dp_chain_compact_wide replaces dp_chain_compact_wide (K8:
// _kernel_wide).  Semantics follow the recurrence of the TPU kernels step
// for step (reference: src/chain.rs:838-896):
//
//   2 planes: d_q = qp_i - qp_j over 24-bit positions; same chunk and
//             orientation = equal cid tag (w1 bits 26-30) and rev bit
//   3 planes: d_q = (w1_i >> 2) - (w1_j >> 2), unmasked; same chunk and
//             ref contig = w3_i == w3_j, same orientation = equal rev bit
//   d_r  = +-(w2_i - w2_j) by rev_i
//   ok   = same chunk AND orientation, both valid, 0 != d_q <= pcl,
//          w2_i != w2_j, d_q, d_r <= D_MAX_LIN_LENGTH, d_r > 0,
//          |d_r - d_q| <= max_gap, slot_j >= max(t - band, 0)
//   comb = ok ? (anchor_score - gap + dp_j) * RING + rel_j : NEGI,
//          rel_j = slot_j - (t - RING)
//   best = max(comb); take = (best >> RING_SHIFT) > 0; the unique best
//          slot (the most recent among equal scores) donates root and
//          depth; an anchor that does not take is its own root (its
//          global column).
//
// Layout: as on the TPU, each row's A columns split into A/S segments of
// S columns; lane = (segment, row) scans its S columns and then H = min(
// l_cap, S) halo columns of the next segment.  A column whose chunk starts
// in an earlier segment (col_in_chunk > column % S) takes the previous
// lane's halo value, or zero when no halo covers it; the kernels write each
// column exactly once from the lane that owns its final value.
//
// Bound: a lane is a sequential dependency chain of steps, each one ring of
// candidates wide, so the kernels are bound by the issue rate of the
// per-step int32 compare-and-select work, not by bytes.
//
// K3 (2 planes, band < 32, ring <= 32): one WARP per lane, one ring slot
// per thread (slot s in thread s); each step broadcasts the new anchor with
// __shfl_sync, takes the warp max with __reduce_max_sync, finds the one
// winning thread with __ballot_sync and hands its root and depth over with
// __shfl_sync.  It walks all S + H steps.
//
// K8 (3 planes, any band <= 255) keeps the warp per lane, runs the wide
// ring and step of dp_ring.cuh (band-sized ring, valid anchors only, the
// same winner), and cuts the columns a lane scans:
//   * halo stop: one coalesced look-ahead over the next segment's H
//     col_in_chunk words (a warp max) finds the last halo column that the
//     write rule stores (col_in_chunk > its offset); the scan ends there.
//     Exact for any col_in_chunk: no later step feeds a written column.
//   * a tile without a valid anchor costs its loads and stores; an invalid
//     anchor's output is dp 0, its own column as root, depth 0.
//   * the slot words: a = w1 (orientation and valid bits one test on (w1_i
//     ^ w1_j) & 3), b = w2, c = w3 (chunk and contig, one equality); depth
//     and root travel packed (depth << 20 | root, the output word).
//   * inputs stream through registers one tile ahead: the next tile's four
//     coalesced loads are issued before the current tile's steps.
#include "dp_ring.cuh"

namespace {

using namespace skt;

constexpr int kQpMask = (1 << 24) - 1;
constexpr int kCidMask = 0x1F << 26;
constexpr int kRootBits = 20;
constexpr int kThreads = 128;

// K3: 2 planes, band < 32, one ring slot a thread (slot s in thread s).
// Its statements keep the order of the body that K3 once shared with the
// former 3-plane kernel: the generated step changes with that order.
__global__ void dp_compact_kernel(const int32_t* __restrict__ w1,
                                  const int32_t* __restrict__ w2,
                                  const int32_t* __restrict__ cic,
                                  int32_t* __restrict__ score,
                                  int32_t* __restrict__ dr,
                                  int R, int A, int S, int H, int band,
                                  int pcl, int max_gap, int anchor_score,
                                  int ring, int ring_shift) {
  const int lane = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x)
                         >> 5);
  const int lid = threadIdx.x & 31;
  const int nseg = A / S;
  if (lane >= nseg * R) return;  // uniform across the warp
  const int seg = lane / R;
  const int row = lane % R;
  const int64_t rbase = (int64_t)row * A;
  const int base_col = seg * S;
  const int T = S + H;
  // ring < 32: the upper threads hold no slot
  const bool holds = lid < ring;

  int dpw = 0, w1w = 0, w2w = 0, rootw = 0, depw = 0;
  int slotw = -(1 << 29);

  for (int t0 = 0; t0 < T; t0 += 32) {
    const int col = base_col + t0 + lid;
    int w1c = 0, w2c = 0, cicc = 0;
    if (col < A) {
      w1c = w1[rbase + col];
      w2c = w2[rbase + col];
      cicc = cic[rbase + col];
    }
    const int nsteps = min(32, T - t0);
    int out_s = 0, out_dr = 0;
    for (int j = 0; j < nsteps; ++j) {
      const int t = t0 + j;
      const int w1_i = __shfl_sync(kFull, w1c, j);
      const int w2_i = __shfl_sync(kFull, w2c, j);
      const int qp_i = (w1_i >> 2) & kQpMask;
      const bool rev_i = (w1_i >> 1) & 1;
      const int lo_slot = max(t - band, 0);
      int my_best = kNegI, my_root = 0, my_dep = 0;
      bool my_ok = false;
      {
        const int qp_j = (w1w >> 2) & kQpMask;
        const int d_q = wsub(qp_i, qp_j);
        const int d_r_f = wsub(w2_i, w2w);
        const int d_r = rev_i ? wsub(0, d_r_f) : d_r_f;
        const int gap = wabs(wsub(d_r, d_q));
        const bool same = ((w1w ^ w1_i) & (kCidMask | 2)) == 0;
        const bool ok = holds && same
            && (w1w & w1_i & 1) == 1
            && d_q <= pcl && d_q != 0
            && w2_i != w2w
            && d_q <= kDMaxLin && d_r <= kDMaxLin
            && d_r > 0
            && gap <= max_gap
            && slotw >= lo_slot;
        const int rel = wsub(slotw, t - ring);
        const int cand = wadd(wsub(anchor_score, gap), dpw);
        const int comb = ok ? wadd(wmul(cand, ring), rel) : kNegI;
        // comb is unique among ok slots (rel is), so > keeps one winner
        if (ok && (!my_ok || comb > my_best)) {
          my_best = comb;
          my_root = rootw;
          my_dep = depw;
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
      const int dp_t = take ? best_val : 0;
      const int root_t = take ? root_w : base_col + t;
      const int dep_t = take ? dep_w + 1 : 0;
      if (lid == j) {
        out_s = dp_t;
        out_dr = (dep_t << kRootBits) | root_t;
      }
      // the step's slot (thread slot & 31 of register slot >> 5, the only
      // one), by selects
      const int slot = t & (ring - 1);
      const bool mine = lid == (slot & 31);
      {
        const bool w = mine && 0 == (slot >> 5);
        dpw = w ? dp_t : dpw;
        w1w = w ? w1_i : w1w;
        w2w = w ? w2_i : w2w;
        rootw = w ? root_t : rootw;
        depw = w ? dep_t : depw;
        slotw = w ? t : slotw;
      }
    }
    if (lid < nsteps) {
      const int t = t0 + lid;
      if (t < S) {
        // own segment: keep unless the column's chunk began in an earlier
        // segment, whose lane owns it; with no halo covering the column
        // (first segment, or beyond the H halo columns) the value is 0
        if (cicc <= t) {
          score[rbase + col] = out_s;
          dr[rbase + col] = out_dr;
        } else if (seg == 0 || t >= H) {
          score[rbase + col] = 0;
          dr[rbase + col] = 0;
        }
      } else if (seg + 1 < nseg && col < A && cicc > t - S) {
        // halo column of the next segment whose chunk this lane owns
        score[rbase + col] = out_s;
        dr[rbase + col] = out_dr;
      }
    }
  }
}

// K8's layout policy: a = w1, b = w2, c = w3
struct Wide {
  struct Pay {
    int dr;  // depth << 20 | root
    static __device__ __forceinline__ Pay own(int root) { return {root}; }
    __device__ __forceinline__ Pay next(int src) const {
      return {wadd(__shfl_sync(kFull, dr, src), 1 << kRootBits)};
    }
  };
  static __device__ __forceinline__ int qp(int a) { return a >> 2; }
  static __device__ __forceinline__ bool rev(int a, int) {
    return (a & 2) != 0;
  }
  static __device__ __forceinline__ bool same(int a_i, int c_i, int a_j,
                                              int c_j) {
    return ((a_i ^ a_j) & 3) == 0 && c_j == c_i;
  }
  static __device__ __forceinline__ void clear(int& a, int&) { a = 0; }
};

// K8: NREG registers of ring slots a thread, ring length 32 * NREG >= band
template <int NREG>
__global__ void __launch_bounds__(kThreads)
dp_wide_kernel(const int32_t* __restrict__ w1, const int32_t* __restrict__ w2,
               const int32_t* __restrict__ w3,
               const int32_t* __restrict__ cic, int32_t* __restrict__ score,
               int32_t* __restrict__ dr, int R, int A, int S, int H,
               int band, int pcl, int max_gap, int anchor_score, int ring,
               int ring_shift) {
  const int lane = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x)
                         >> 5);
  const int lid = threadIdx.x & 31;
  const int nseg = A / S;
  if (lane >= nseg * R) return;  // uniform across the warp
  const int seg = lane / R;
  const int row = lane % R;
  const int64_t rbase = (int64_t)row * A;
  const int base_col = seg * S;

  // halo look-ahead: the last halo column u whose value this lane writes
  // (col_in_chunk > u); the scan ends right after it
  int last = -1;
  if (seg + 1 < nseg) {
    const int32_t* hc = cic + rbase + base_col + S;
    for (int u = lid; u < H; u += 32) {
      if (hc[u] > u) last = u;
    }
    last = __reduce_max_sync(kFull, last);
  }
  const int T = S + last + 1;

  const StepConst g =
      step_const(band, pcl, max_gap, anchor_score, ring, ring_shift);
  Ring<NREG, Wide> rg;

  // the next tile's inputs, one tile ahead of the steps
  int n1 = 0, n2 = 0, n3 = 0, nc = 0;
  {
    const int col = base_col + lid;
    if (col < A) {
      n1 = w1[rbase + col];
      n2 = w2[rbase + col];
      n3 = w3[rbase + col];
      nc = cic[rbase + col];
    }
  }
  for (int tq = 0; tq < T; tq += 32 * NREG) {
#pragma unroll
    for (int K = 0; K < NREG; ++K) {
      const int t0 = tq + 32 * K;
      if (t0 >= T) break;  // uniform
      const int c1 = n1, c2 = n2, c3 = n3, cc = nc;
      const int col = base_col + t0 + lid;
      if (t0 + 32 < T) {
        const int ncol = col + 32;
        n1 = n2 = n3 = nc = 0;
        if (ncol < A) {
          n1 = w1[rbase + ncol];
          n2 = w2[rbase + ncol];
          n3 = w3[rbase + ncol];
          nc = cic[rbase + ncol];
        }
      }
      const int nsteps = min(32, T - t0);
      int out_s;
      Wide::Pay out;
      rg.tile(K, lid, nsteps, c1, c2, c3, (c1 & 1) != 0, g, base_col + t0,
              out_s, out);
      if (lid < nsteps) {
        const int t = t0 + lid;
        if (t < S) {
          if (cc <= t) {
            score[rbase + col] = out_s;
            dr[rbase + col] = out.dr;
          } else if (seg == 0 || t >= H) {
            score[rbase + col] = 0;
            dr[rbase + col] = 0;
          }
        } else if (cc > t - S) {  // a halo column (T > S only with a halo)
          score[rbase + col] = out_s;
          dr[rbase + col] = out.dr;
        }
      }
    }
  }
}

}  // namespace

extern "C" int skt_dp_chain_compact(const void* w1, const void* w2,
                                    const void* cic, void* score, void* dr,
                                    int R, int A, int S, int H, int band,
                                    int pcl, int max_gap, int anchor_score,
                                    int ring, int ring_shift, void* stream) {
  if (ring > 32) return (int)cudaErrorInvalidValue;  // cid tag: band < 32
  const int64_t lanes = (int64_t)(A / S) * R;
  if (lanes > 0) {
    const int64_t blocks = (lanes * 32 + kThreads - 1) / kThreads;
    dp_compact_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)w1, (const int32_t*)w2, (const int32_t*)cic,
        (int32_t*)score, (int32_t*)dr, R, A, S, H, band, pcl, max_gap,
        anchor_score, ring, ring_shift);
  }
  return (int)cudaGetLastError();
}

extern "C" int skt_dp_chain_compact_wide(
    const void* w1, const void* w2, const void* w3, const void* cic,
    void* score, void* dr, int R, int A, int S, int H, int band, int pcl,
    int max_gap, int anchor_score, int ring, int ring_shift, int nreg,
    void* stream) {
  // refused, never run
  if (ring > 256 || !nreg_ok(nreg, band)) return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)(A / S) * R;
  if (lanes == 0) return (int)cudaGetLastError();
  const int blocks = (int)((lanes * 32 + kThreads - 1) / kThreads);
#define SKT_WIDE(N)                                                        \
  case N:                                                                  \
    dp_wide_kernel<N><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(      \
        (const int32_t*)w1, (const int32_t*)w2, (const int32_t*)w3,        \
        (const int32_t*)cic, (int32_t*)score, (int32_t*)dr, R, A, S, H,    \
        band, pcl, max_gap, anchor_score, ring, ring_shift);               \
    break
  switch (nreg) {
    SKT_WIDE(1); SKT_WIDE(2); SKT_WIDE(3); SKT_WIDE(4);
    SKT_WIDE(5); SKT_WIDE(6); SKT_WIDE(7); SKT_WIDE(8);
  }
#undef SKT_WIDE
  return (int)cudaGetLastError();
}
