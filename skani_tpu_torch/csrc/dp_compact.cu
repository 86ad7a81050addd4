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
// K3 (2 planes, band < 32, ring <= 32): one WARP per lane, which walks its
// columns in 32-column tiles, one target column a thread.  The candidate
// test and the part of comb that needs no DP value depend only on the input
// words: for target t and source j = t - k (1 <= k <= band),
//   comb = term_tk + dp_j * RING,
//   term_tk = (anchor_score - gap_tj) * RING + RING - k   (INT32_MIN where
//             the candidate fails),
// in wrapping int32, bit for bit the reference's word.  So a tile runs in
// two phases:
//   * phase 1, in parallel: each thread forms its target's band terms, one
//     age k at a time (the source words come from a 64-column window in
//     shared memory, the previous tile and this one).  A source in the
//     previous tile already has its dp: its comb folds into the target's
//     running best at once.  A source in this tile leaves its term in a
//     32 x 32 table (source row, target column).
//   * phase 2, the loop-carried chain: for each source column r = 0..30, in
//     order, thread r's best is final; shuffles send its dp * RING (best &
//     -RING) and its depth << 20 | root, and every thread folds
//     table[r][lid] + dp * RING.  Rounds go in pairs: source r + 1's best,
//     word and term for source r come by shuffle too, so every thread forms
//     r + 1's state after round r itself, and one shuffle latency carries
//     two rounds (the chain of a pair: a shuffle and six ALU operations).
//     A round for an invalid source folds only INT32_MIN terms, so all 31
//     run, without a branch; the table row is in registers first.
// The running best starts at RING - 1, so only a taking candidate (comb >=
// RING) is ever adopted and dp = best >> log2(RING) on every column; a
// failed candidate or a table entry outside the band (INT32_MIN + dp *
// RING < 0) never is.  comb is unique among passing candidates (comb mod
// RING = RING - k), so the fold's order does not change the winner: the
// largest score, and among equal scores the most recent source.  A winner
// in the previous tile gives depth << 20 | root (its word plus 1 << 20)
// after phase 1, one in this tile with its round.  The halo stops after the
// last halo column that the lane writes, as K8's does; a tile without a
// valid anchor runs neither phase.  With 759 lanes at the default batch
// (about six warps an SM) its time is set by latency, the pairs' chain and
// each phase's dependent shared loads, more than by issue.
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

// K3: 2 planes, band < 32
constexpr int kKeyMask = kCidMask | 3;  // cid tag, rev and valid bits
constexpr int kI32Min = -2147483647 - 1;
constexpr int kK3Group = 4;  // band candidates a thread forms together

__global__ void __launch_bounds__(32)
dp_compact_kernel(const int32_t* __restrict__ w1,
                  const int32_t* __restrict__ w2,
                  const int32_t* __restrict__ cic, int32_t* __restrict__ score,
                  int32_t* __restrict__ dr, int R, int A, int S, int H,
                  int band, int pcl, int max_gap, int anchor_score, int ring,
                  int ring_shift) {
  // the source window: qp, w2, key (w1 & kKeyMask) and dp * RING of the
  // previous tile's columns at [0, 32) and this tile's at [32, 64) (dp not
  // yet known there); the previous tile's depth << 20 | root; the term table
  __shared__ int4 win[64];
  __shared__ int wdr[32];
  __shared__ int term[32 * 32];
  const int lane = blockIdx.x;
  const int lid = threadIdx.x;
  const int nseg = A / S;
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

  // entries outside the band stay INT32_MIN; phase 1 rewrites the band's
  // every tile.  Each thread owns its target column of the table
  for (int r = 0; r < 32; ++r) term[r * 32 + lid] = kI32Min;
  const int lim_q = min(pcl, kDMaxLin);
  const int nring = wsub(0, ring);  // -RING, also the mask of dp * RING
  const int u0 = wmul(wadd(anchor_score, 1), ring);
  // this thread's column of the previous tile (none before the first: key
  // 0 never matches a valid target) and its depth << 20 | root
  int4 prev = make_int4(0, 0, 0, 0);
  int pdr = 0;

  // the next tile's inputs, one tile ahead
  int n1 = 0, n2 = 0, nc = 0;
  if (base_col + lid < A) {
    n1 = w1[rbase + base_col + lid];
    n2 = w2[rbase + base_col + lid];
    nc = cic[rbase + base_col + lid];
  }
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int c1 = n1, c2 = n2, cc = nc;
    const int col = base_col + t0 + lid;
    if (t0 + 32 < T) {
      const int ncol = col + 32;
      n1 = n2 = nc = 0;
      if (ncol < A) {
        n1 = w1[rbase + ncol];
        n2 = w2[rbase + ncol];
        nc = cic[rbase + ncol];
      }
    }
    const int nsteps = min(32, T - t0);
    const bool valid = lid < nsteps && (c1 & 1) != 0;
    const int qp = (c1 >> 2) & kQpMask;
    const int key = c1 & kKeyMask;
    const int tkey = valid ? key : -1;  // -1 matches no source
    win[lid] = prev;
    wdr[lid] = pdr;
    win[32 + lid] = make_int4(qp, c2, key, 0);
    __syncwarp();
    const unsigned vmask = __ballot_sync(kFull, valid);
    int b = ring - 1;  // the running best
    int odr = col;     // depth << 20 | root of this column as it stands
    constexpr int kStep = 1 << kRootBits;  // one hop deeper
    if (vmask) {       // uniform
      // phase 1: the band terms of this thread's target, four ages k at a
      // time (independent work for the issue slots; the band test is part
      // of `ok`, the break comes between groups); a source in the previous
      // tile folds at once, into one running best per age of the group
      const bool rev = (c1 & 2) != 0;
      const int sgn = rev ? 1 : -1;
      const int off = rev ? ~c2 : wsub(c2, 1);  // d_r - 1 = w2_j * sgn + off
      int bk[kK3Group], ik[kK3Group];
#pragma unroll
      for (int u = 0; u < kK3Group; ++u) bk[u] = b, ik[u] = 0;
#pragma unroll
      for (int k0 = 1; k0 < 32; k0 += kK3Group) {
        if (k0 > band) break;  // uniform
        // the group's source records first: a table store may not pass a
        // window load, so loads interleaved with stores run one at a time
        int4 sv[kK3Group];
#pragma unroll
        for (int u = 0; u < kK3Group; ++u) sv[u] = win[32 + lid - k0 - u];
#pragma unroll
        for (int u = 0; u < kK3Group; ++u) {
          const int k = k0 + u;
          const int4 s = sv[u];
          const int d_q = wsub(qp, s.x);
          const int d_r1 = wadd(wmul(s.y, sgn), off);
          const int gap = wabs(wsub(wsub(d_q, d_r1), 1));
          const bool ok = k <= band && s.z == tkey && d_q <= lim_q
              && d_q != 0 && (unsigned)d_r1 < (unsigned)kDMaxLin
              && gap <= max_gap;
          const int tk = ok ? wadd(wmul(gap, nring), wsub(u0, k)) : kI32Min;
          if (lid >= k) term[(lid - k) * 32 + lid] = tk;
          // a source in the previous tile: its dp is final
          const int comb = lid < k ? wadd(tk, s.w) : kI32Min;
          if (comb > bk[u]) {
            bk[u] = comb;
            ik[u] = 32 + lid - k;
          }
        }
      }
      int idx = 0;
#pragma unroll
      for (int u = 0; u < kK3Group; ++u) {
        if (bk[u] > b) {
          b = bk[u];
          idx = ik[u];
        }
      }
      if (b >= ring) odr = wadd(wdr[idx], kStep);
      // phase 2: the chain over the tile's sources r = 0..30, in order, two
      // a shuffle's latency: every thread gets source r's dp * RING and
      // word, and source r + 1's best, word and term for source r, so it
      // forms r + 1's state after round r itself.  A round for an invalid
      // source, or one past the last valid column, folds only INT32_MIN
      // terms and changes nothing, so every round runs, without a branch.
      // The table row is in registers first; shuffle lanes and rows are
      // constants
      int tv[31];
#pragma unroll
      for (int r = 0; r < 31; ++r) tv[r] = term[r * 32 + lid];
#pragma unroll
      for (int r = 0; r < 31; r += 2) {
        const int pj0 = __shfl_sync(kFull, b & nring, r);
        const int d0 = __shfl_sync(kFull, odr, r);
        const int c0 = wadd(tv[r], pj0);
        int d1 = 0, pj1 = 0;
        if (r + 1 < 31) {
          const int x = __shfl_sync(kFull, b, r + 1);
          const int y = __shfl_sync(kFull, tv[r], r + 1);
          const int o1 = __shfl_sync(kFull, odr, r + 1);
          const int c1s = wadd(y, pj0);  // source r + 1's candidate r
          pj1 = max(x, c1s) & nring;
          d1 = c1s > x ? wadd(d0, kStep) : o1;
        }
        if (c0 > b) odr = wadd(d0, kStep);
        b = max(b, c0);
        if (r + 1 < 31) {
          const int c1 = wadd(tv[r + 1], pj1);
          if (c1 > b) odr = wadd(d1, kStep);
          b = max(b, c1);
        }
      }
    }
    const int out_s = b >> ring_shift;
    prev = make_int4(qp, c2, key, b & nring);
    pdr = odr;
    __syncwarp();  // the window is read; the next tile rewrites it
    if (lid < nsteps) {
      // own segment: keep unless the column's chunk began in an earlier
      // segment, whose lane owns it; with no halo covering the column
      // (first segment, or beyond the H halo columns) the value is 0.  A
      // halo column (T > S only with a halo): the lane owns its chunk
      const int t = t0 + lid;
      const bool keep = t < S ? cc <= t : cc > t - S;
      const bool zero = t < S && !keep && (seg == 0 || t >= H);
      if (keep || zero) {
        score[rbase + col] = keep ? out_s : 0;
        dr[rbase + col] = keep ? odr : 0;
      }
    }
  }
}

// K8's layout policy: a = w1, b = w2, c = w3
struct Wide {
  struct Pay {
    int dr;  // depth << 20 | root
    static __device__ __forceinline__ Pay own(int root) { return {root}; }
    __device__ __forceinline__ Pay next(int src, const StepConst&) const {
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
  // the cid tag needs band < 32; ring is a power of two above the band
  if (ring > 32 || band < 0 || band >= ring)
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)(A / S) * R;
  if (lanes > 0) {
    // a block a lane: the lanes spread evenly over the SMs
    dp_compact_kernel<<<(int)lanes, 32, 0, (cudaStream_t)stream>>>(
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
