// The ring and the step of the wide banded chaining DPs (sm_90a), shared by
// dp_compact.cu's K8 (dp_wide_kernel, the compact stream) and dp_padded.cu's
// K10 and K9 (dp_chain_kernel and dp_chain_packed_kernel, the padded
// layout), and the wrapping int32 helpers of every DP kernel.
//
// One WARP per lane; NREG registers of ring slots a thread (ring length
// 32 * NREG >= band; the wrappers pass NREG, kernels/dp_compact.py
// ring_regs); the lane steps only through its valid anchors.
//   * slots: step t lives in thread t & 31, register (t >> 5) % NREG.  The
//     kernels walk 32-step tiles with the tile loop unrolled NREG times, so
//     tile K writes register K, a compile-time register: a step updates its
//     slot with predicated moves, not a select over every register.
//   * ages: a slot's age t - t_j is a per-register base fixed at each tile
//     start (-lid once the slot is rewritten), so the band window is one
//     compare and the ring needs no power of two.
//   * skipping invalid anchors keeps the time order: a tile's steps run
//     over the ballot of its valid anchors; before step j the slots of
//     invalid anchors before j turn empty (their old contents, NREG tiles
//     back, were candidates only for earlier steps), after the tile every
//     invalid anchor's slot.
//   * one candidate: with the anchor's sign s_i and offset o_i hoisted,
//     d_r - 1 = r_j * s_i + o_i, so 1 <= d_r <= D_MAX_LIN_LENGTH is one
//     unsigned compare (and implies r_i != r_j); |d_r - d_q| is taken as
//     |d_q - d_r|, the same word for every int32.
//   * the same winner: comb = pj_j - gap * RING - age_j + U_t with pj_j =
//     dp_j * RING stored and U_t = (anchor_score + 1) * RING - j, in
//     wrapping int32, equals the TPU kernels' (anchor_score - gap + dp_j) *
//     RING + (RING - age_j) bit for bit: the largest score wins and, among
//     equal scores, the smallest age (the most recent slot).  comb is unique
//     among passing slots, so the warp max names one winner.
//
// A layout policy P says what the three stored words a, b, c mean:
//   P::qp(a)          the query position of word a
//   P::rev(a, c)      the anchor's orientation bit
//   P::same(a_i, c_i, a_j, c_j)  same chunk, contig and orientation, and the
//                     slot valid (the anchor is)
//   P::clear(a, c)    marks a slot empty
//   P::Pay            root and depth: Pay::own(root) for an anchor that does
//                     not take, pay.next(src, g) the winner's (in thread
//                     src) one hop deeper (g.pay_one: one hop in a policy
//                     whose depth field sits at a launch's bit offset)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace skt {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNegI = -(1 << 29);
constexpr int kDMaxLin = 5000;  // D_MAX_LIN_LENGTH

// int32 arithmetic with two's-complement wrap-around, as XLA defines it
// (signed overflow is undefined in C++)
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}
__device__ __forceinline__ int wshl(int a, int s) {
  return (int)((unsigned)a << s);
}

// the ring's widest register count (ring 256) and the dispatchers' refusal
// of an NREG that does not cover the band
constexpr int kMaxNreg = 8;
inline bool nreg_ok(int nreg, int band) {
  return nreg >= 1 && nreg <= kMaxNreg && 32 * nreg >= band;
}

// terms of every step, fixed for a launch
struct StepConst {
  int band, lim_q, max_gap, nring, u0, ring, ring_shift, pay_one;
};

__device__ __forceinline__ StepConst step_const(int band, int pcl,
                                                int max_gap,
                                                int anchor_score, int ring,
                                                int ring_shift,
                                                int pay_one = 0) {
  return {band, min(pcl, kDMaxLin), max_gap, wsub(0, ring),
          wmul(wadd(anchor_score, 1), ring), ring, ring_shift, pay_one};
}

template <int NREG, class P>
struct Ring {
  using Pay = typename P::Pay;
  // slot words, dp * RING, age bases, payload; all zero is an empty slot
  int a[NREG], b[NREG], c[NREG], pj[NREG], age[NREG];
  Pay pay[NREG];

  __device__ __forceinline__ Ring() {
#pragma unroll
    for (int k = 0; k < NREG; ++k) {
      a[k] = b[k] = c[k] = pj[k] = 0;
      pay[k] = Pay{};
    }
  }

  // Steps the valid anchors of tile K (register K): thread lid holds step
  // lid's words ca, cb, cc and its valid bit; nsteps steps are live; root0
  // + j is step j's own root.  Sets the thread's own step's dp and payload
  // (0 and Pay::own(root0 + lid) where its anchor is invalid).
  __device__ __forceinline__ void tile(const int K, const int lid,
                                       const int nsteps, const int ca,
                                       const int cb, const int cc,
                                       const bool valid, const StepConst& g,
                                       const int root0, int& out_s,
                                       Pay& out_pay) {
    // register k holds the tile (K - k) mod NREG tiles back; K itself NREG
    // tiles back until a step rewrites the slot
#pragma unroll
    for (int k = 0; k < NREG; ++k) {
      age[k] = 32 * (k == K ? NREG : (K - k + NREG) % NREG) - lid;
    }
    unsigned todo = __ballot_sync(kFull, lid < nsteps && valid);
    out_s = 0;
    out_pay = Pay::own(root0 + lid);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int a_i = __shfl_sync(kFull, ca, j);
      const int b_i = __shfl_sync(kFull, cb, j);
      const int c_i = __shfl_sync(kFull, cc, j);
      if (lid < j && !valid) P::clear(a[K], c[K]);
      const int qp_i = P::qp(a_i);
      const bool rev_i = P::rev(a_i, c_i);
      const int sgn = rev_i ? 1 : -1;
      const int off = rev_i ? ~b_i : wsub(b_i, 1);
      const int lim_age = g.band - j;
      const int u = wsub(g.u0, j);
      int my_best = kNegI;
      Pay my_pay{};
#pragma unroll
      for (int k = 0; k < NREG; ++k) {
        const int d_q = wsub(qp_i, P::qp(a[k]));
        const int d_r1 = wadd(wmul(b[k], sgn), off);  // d_r - 1
        const int gap = wabs(wsub(wsub(d_q, d_r1), 1));
        const bool ok = P::same(a_i, c_i, a[k], c[k])
            && d_q <= g.lim_q && d_q != 0
            && (unsigned)d_r1 < (unsigned)kDMaxLin
            && gap <= g.max_gap && age[k] <= lim_age;
        const int comb =
            wadd(wsub(wadd(wmul(gap, g.nring), pj[k]), age[k]), u);
        if (ok && comb > my_best) {
          my_best = comb;
          my_pay = pay[k];
        }
      }
      const int best = __reduce_max_sync(kFull, my_best);
      const int best_val = best >> g.ring_shift;
      int dp_t = 0;
      Pay pay_t = Pay::own(root0 + j);
      if (best_val > 0) {  // uniform; one passing slot holds best
        const int win = __ffs(__ballot_sync(kFull, my_best == best)) - 1;
        dp_t = best_val;
        pay_t = my_pay.next(win, g);
      }
      if (lid == j) {
        out_s = dp_t;
        out_pay = pay_t;
        a[K] = ca;
        b[K] = cb;
        c[K] = cc;
        pj[K] = wmul(dp_t, g.ring);
        pay[K] = pay_t;
        age[K] = -lid;
      }
    }
    if (!valid) P::clear(a[K], c[K]);
  }
};

}  // namespace skt
