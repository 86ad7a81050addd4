"""The schedules of the Hopper kernels for dp_chain_compact (K3),
dp_chain_compact_wide (K8), dp_chain (K10) and dp_chain_packed (K9),
emulated in numpy on the CPU and held bit for bit, on every column, against the plain versions and the
JAX package's kernels (Pallas in interpret mode, and the lax.scan reference
of the padded DP).

The K3 emulation follows csrc/dp_compact.cu dp_compact_kernel lane by lane
(vectorised over lanes), a 32-column tile at a time:

  * the halo look-ahead, as K8's;
  * phase 1, no DP value needed: each target column's band candidates as
    terms (anchor_score - gap) * RING + RING - k, or INT32_MIN where the
    candidate fails; a source in the previous tile adds its final dp * RING
    and folds into the target's running best at once, a source in the tile
    leaves its term in a 32 x 32 table;
  * phase 2, the chain: rounds r = 0..30 in order, each sending source
    r's dp * RING (its best & -RING) to every thread, which folds table
    term + dp * RING (the kernel runs two rounds a shuffle; a round for an
    invalid source folds only INT32_MIN terms);
  * the running best starts at RING - 1, so only a taking candidate is
    ever adopted: dp = best >> log2(RING) on every column, and a failed
    candidate (INT32_MIN + dp * RING < 0) never is;
  * root and depth (depth << 20 | root): a winner in the previous tile
    gives its word plus 1 << 20 after phase 1; a round sends the source's
    word beside its best.  Phase 1's fold order (the kernel keeps one
    running best per age of a group of four) does not change the winner:
    comb mod RING = RING - k is unique among a column's candidates.

The K8, K10 and K9 emulations follow csrc/dp_compact.cu dp_wide_kernel
and csrc/dp_padded.cu dp_chain_kernel and dp_chain_packed_kernel lane by
lane (vectorised over lanes; K9 is K10's schedule under the packed layout
policy):

  * the halo look-ahead: a compact lane stops after the last halo column
    whose col_in_chunk exceeds its offset;
  * only valid anchors step; a 32-column tile without one steps nothing
    and empties its ring slots;
  * the band-sized ring: NREG = ceil(band / 32) registers of 32 slots, the
    slot of step t in register (t >> 5) % NREG, slot t & 31, ages from
    per-register bases fixed at each tile start;
  * the tie-break encoding comb = pj - gap * RING - base + U_t in wrapping
    int32, the winner the one slot whose comb is the warp maximum.

It is test code only: the package holds the plain versions and the
kernels.  The CUDA kernels are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skani_tpu.kernels.dp_compact import dp_chain_compact as jax_dp
from skani_tpu.kernels.dp_compact import \
    dp_chain_compact_wide as jax_dp_wide
from skani_tpu.kernels.dp_pallas import (_dp_pallas, _dp_pallas_packed,
                                         _dp_scan, _dp_scan_packed)
from skani_tpu_torch import synth
from skani_tpu_torch.kernels import dp_compact, dp_pallas
from skani_tpu_torch.kernels.dp_compact import (CID_MASK, NEGI, QP_MASK,
                                                ROOT_BITS, ring_regs,
                                                ring_size, seg_len)

torch.set_num_threads(1)

PCL, MAX_GAP, SCORE = 2500, 300, 20
DMAX = 5000
I32 = np.int32
LID = np.arange(32, dtype=I32)
I32MIN = I32(-(1 << 31))


def _ages(n, nreg, K):
    """Per-register age bases at a tile's first step: register k holds the
    tile (K - k) mod NREG tiles back, register K itself NREG tiles back."""
    base = np.array([32 * (nreg if k == K else (K - k) % nreg)
                     for k in range(nreg)], I32)
    return np.broadcast_to(base[:, None] - LID[None, :],
                           (n, nreg, 32)).copy()


def _candidates(ok, comb, shift):
    """The warp's choice among (lane, register, slot) candidates: the best
    comb over slots that pass (and beat NEGI), take when its score > 0, and
    the one winning slot as a flat index; also whether two passing slots
    tie on the score of the winner."""
    n = ok.shape[0]
    ok = ok & (comb > I32(NEGI))
    combm = np.where(ok, comb, I32(NEGI)).reshape(n, -1)
    best = combm.max(axis=1)
    best_val = best >> I32(shift)
    win = np.argmax(ok.reshape(n, -1) & (combm == best[:, None]), axis=1)
    ties = ((ok.reshape(n, -1) & ((combm >> I32(shift))
                                  == best_val[:, None])).sum(1) > 1)
    return best_val, best_val > 0, win, ties


def _halo_stop(cic, S, H, nseg, seg, row):
    """The halo look-ahead: the last halo column that each lane writes
    (col_in_chunk > its offset), -1 for none."""
    last = np.full(seg.size, -1)
    for i in range(seg.size):
        if seg[i] + 1 < nseg:
            hc = cic[row[i], (seg[i] + 1) * S:(seg[i] + 1) * S + H]
            hit = np.nonzero(hc > np.arange(H))[0]
            last[i] = hit.max() if hit.size else -1
    return last


def _write_rule(score, dr, writes, out_s, out_dr, cc, t0, nsteps, active,
                seg, row, base_col, S, H):
    """Each column from the lane that owns it: its own segment unless the
    column's chunk began in an earlier segment (0 where no halo covers it),
    and the halo columns whose chunk the lane owns."""
    n = seg.size
    t = np.broadcast_to(t0 + LID, (n, 32))
    live = active[:, None] & (LID[None, :] < nsteps[:, None])
    own = live & (t < S)
    keep = own & (cc <= t)
    zero = own & (cc > t) & ((seg[:, None] == 0) | (t >= H))
    halo = live & (t >= S) & (cc > t - S)
    rr = np.broadcast_to(row[:, None], (n, 32))
    col = base_col[:, None] + t
    for m, s_v, d_v in ((keep | halo, out_s, out_dr),
                        (zero, 0 * out_s, 0 * out_dr)):
        score[rr[m], col[m]] = s_v[m]
        dr[rr[m], col[m]] = d_v[m]
        np.add.at(writes, (rr[m], col[m]), 1)


def emulate_compact(w1, w2, cic, band, pcl, max_gap, anchor_score, l_cap):
    """dp_compact_kernel's schedule: returns (score, dr, stats)."""
    R, A = w1.shape
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    RING = ring_size(band)
    shift = int(np.log2(RING))
    nseg = A // S
    n = nseg * R
    seg = np.arange(n) // R
    row = np.arange(n) % R
    base_col = (seg * S).astype(I32)
    last = _halo_stop(cic, S, H, nseg, seg, row)
    T = S + last + 1
    Tmax = int(T.max())
    Tpad = (Tmax + 31) // 32 * 32

    def marshal(x):
        xp = np.concatenate([x, np.zeros((R, S + H + 32), I32)], axis=1)
        return np.stack([xp[row[i], base_col[i]:base_col[i] + Tpad]
                         for i in range(n)])

    m1, m2, mc = (marshal(x) for x in (w1, w2, cic))
    lim_q = I32(min(pcl, DMAX))
    nring = I32(-RING)                       # also the mask of dp * RING
    u0 = I32(np.int64((anchor_score + 1) * RING).astype(I32))
    # the (source r, target i) term table: entries outside the band stay
    # INT32_MIN from the start; the band's are rewritten every tile
    term = np.full((n, 32, 32), I32MIN)
    # the previous tile's source records: qp, w2, key, dp * RING, dr (all
    # zero before the first tile: key 0 never matches a valid target)
    pqp, pw2, pkey, ppj, pdr = (np.zeros((n, 32), I32) for _ in range(5))
    score = np.zeros((R, A), I32)
    dr = np.zeros((R, A), I32)
    writes = np.zeros((R, A), np.int64)
    stats = {"rounds": np.zeros(n, np.int64),
             "tiles_stepped": 0, "tiles_skipped": 0, "ties": 0,
             "prev_winners": 0, "tile_winners": 0, "lanes": n,
             "halo_steps": last + 1}
    ln = np.arange(n)[:, None]
    for t0 in range(0, Tmax, 32):
        active = t0 < T
        nsteps = np.clip(T - t0, 0, 32)
        c1, c2, cc = (m[:, t0:t0 + 32] for m in (m1, m2, mc))
        live = active[:, None] & (LID[None, :] < nsteps[:, None])
        valid = live & ((c1 & 1) != 0)
        qp = (c1 >> I32(2)) & I32(QP_MASK)
        key = c1 & I32(CID_MASK | 3)
        tkey = np.where(valid, key, I32(-1))
        wqp, ww2, wkey, wpj = (np.concatenate([p, c], axis=1) for p, c in (
            (pqp, qp), (pw2, c2), (pkey, key), (ppj, np.zeros_like(qp))))
        run = valid.any(1)
        stats["tiles_stepped"] += int(run.sum())
        stats["tiles_skipped"] += int((active & ~run).sum())
        b = np.full((n, 32), I32(RING - 1))
        idx = np.zeros((n, 32), I32)       # the winner's window index
        # equal-score candidates at the best score (statistics only)
        bs = np.full((n, 32), -1, np.int64)
        nb = np.zeros((n, 32), np.int64)

        def tally(comb, m):
            sc = np.where(m & (comb >= RING), comb >> I32(shift), -1)
            up = sc > bs
            nb[:] = np.where(up, 1, np.where((sc == bs) & (sc >= 0),
                                             nb + 1, nb))
            bs[:] = np.maximum(bs, sc)

        # phase 1: terms, and the previous tile's sources folded at once
        rev = (c1 & 2) != 0
        sgn = np.where(rev, I32(1), I32(-1))
        off = np.where(rev, ~c2, c2 - I32(1))
        lanes = run[:, None]
        for k in range(1, band + 1):
            pos = 32 + LID - k
            sq, sw2, skey, spj = (x[:, pos] for x in (wqp, ww2, wkey, wpj))
            d_q = qp - sq
            d_r1 = sw2 * sgn + off
            gap = np.abs(d_q - d_r1 - I32(1))
            ok = (skey == tkey) & (d_q <= lim_q) & (d_q != 0) \
                & (d_r1.view(np.uint32) < DMAX) & (gap <= I32(max_gap))
            tk = np.where(ok, gap * nring + (u0 - I32(k)), I32MIN)
            tile = LID >= k
            li, ti = np.nonzero(lanes & tile[None, :])
            term[li, ti - k, ti] = tk[li, ti]
            comb = np.where(tile[None, :], I32MIN, tk + spj)
            tally(comb, lanes & ~tile[None, :] & ok)
            adopt = lanes & (comb > b)
            b = np.where(adopt, comb, b)
            idx = np.where(adopt, pos, idx)
        # the winner of phase 1 lies in the previous tile
        own = base_col[:, None] + I32(t0) + LID[None, :]
        step = I32(1 << ROOT_BITS)
        odr = np.where(b >= RING, pdr[ln, idx & 31] + step, own)
        # phase 2: the chain, rounds r = 0..30 in pairs: source r's best
        # and word, and source r + 1's state after round r, formed by every
        # thread from source r + 1's best, word and term for source r
        stats["rounds"] += 31 * run
        for r in range(0, 31, 2):
            pj0, d0 = b[:, r] & nring, odr[:, r] + step
            c0 = term[:, r, :] + pj0[:, None]
            pair = r + 1 < 31
            if pair:
                x, y, o1 = b[:, r + 1], term[:, r, r + 1], odr[:, r + 1]
                c1s = y + pj0
                pj1 = np.maximum(x, c1s) & nring
                d1 = np.where(c1s > x, d0, o1) + step
            tally(c0, lanes & (term[:, r, :] != I32MIN))
            a0 = lanes & (c0 > b)
            odr = np.where(a0, d0[:, None], odr)
            b = np.where(lanes, np.maximum(b, c0), b)
            if pair:
                c1 = term[:, r + 1, :] + pj1[:, None]
                tally(c1, lanes & (term[:, r + 1, :] != I32MIN))
                a1 = lanes & (c1 > b)
                odr = np.where(a1, d1[:, None], odr)
                b = np.where(lanes, np.maximum(b, c1), b)
        out_s = b >> I32(shift)
        take = b >= RING
        stats["ties"] += int((take & (nb > 1)).sum())
        # the winner's column from its age (comb mod RING = RING - k)
        src = LID[None, :] - (I32(RING) - (b & I32(RING - 1)))
        stats["prev_winners"] += int((take & (src < 0)).sum())
        stats["tile_winners"] += int((take & (src >= 0)).sum())
        out_dr = odr
        pqp, pw2, pkey, ppj, pdr = qp, c2, key, b & nring, out_dr
        _write_rule(score, dr, writes, out_s, out_dr, cc, t0, nsteps,
                    active, seg, row, base_col, S, H)
    assert (writes == 1).all(), "every column is written exactly once"
    return score, dr, stats


def emulate_compact_wide(w1, w2, w3, cic, band, pcl, max_gap, anchor_score,
                         l_cap):
    """dp_wide_kernel's schedule: returns (score, dr, stats)."""
    R, A = w1.shape
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    RING = ring_size(band)
    shift = int(np.log2(RING))
    nreg = ring_regs(band)
    nseg = A // S
    n = nseg * R
    seg = np.arange(n) // R
    row = np.arange(n) % R
    base_col = (seg * S).astype(I32)
    last = _halo_stop(cic, S, H, nseg, seg, row)
    T = S + last + 1
    Tmax = int(T.max())
    Tpad = (Tmax + 31) // 32 * 32

    def marshal(x):
        xp = np.concatenate([x, np.zeros((R, S + H + 32), I32)], axis=1)
        return np.stack([xp[row[i], base_col[i]:base_col[i] + Tpad]
                         for i in range(n)])

    m1, m2, m3, mc = (marshal(x) for x in (w1, w2, w3, cic))
    z = lambda: np.zeros((n, nreg, 32), I32)
    kw1, kw2, kw3, kpj, kdr = z(), z(), z(), z(), z()
    lim_q = I32(min(pcl, DMAX))
    nring = I32(-RING)
    u0 = I32(np.int64((anchor_score + 1) * RING).astype(I32))
    score = np.zeros((R, A), I32)
    dr = np.zeros((R, A), I32)
    writes = np.zeros((R, A), np.int64)
    stats = {"anchor_steps": np.zeros(n, np.int64), "tiles_stepped": 0,
             "tiles_skipped": 0, "ties": 0, "lanes": n,
             "halo_steps": last + 1}
    for t0 in range(0, Tmax, 32):
        K = (t0 // 32) % nreg
        kage = _ages(n, nreg, K)
        active = t0 < T
        nsteps = np.clip(T - t0, 0, 32)
        c1, c2, c3, cc = (m[:, t0:t0 + 32] for m in (m1, m2, m3, mc))
        mine_valid = (c1 & 1) != 0
        todo = active[:, None] & (LID[None, :] < nsteps[:, None]) \
            & mine_valid
        stats["tiles_stepped"] += int(todo.any(1).sum())
        stats["tiles_skipped"] += int((active & ~todo.any(1)).sum())
        out_s = np.zeros((n, 32), I32)
        out_dr = (base_col[:, None] + t0 + LID[None, :]).astype(I32)
        for j in range(32):
            idx = np.nonzero(todo[:, j])[0]
            if idx.size == 0:
                continue
            stats["anchor_steps"][idx] += 1
            inv = ~mine_valid[idx] & (LID[None, :] < j)
            kw1[idx, K] = np.where(inv, I32(0), kw1[idx, K])
            w1_i, w2_i, w3_i = (c[idx, j][:, None, None]
                                for c in (c1, c2, c3))
            rev = (w1_i & 2) != 0
            sgn = np.where(rev, I32(1), I32(-1))
            off = np.where(rev, ~w2_i, w2_i - I32(1))
            a1, a2, a3, apj, adr, age = (x[idx] for x in
                                         (kw1, kw2, kw3, kpj, kdr, kage))
            d_q = (w1_i >> I32(2)) - (a1 >> I32(2))
            d_r1 = a2 * sgn + off
            gap = np.abs(d_q - d_r1 - I32(1))
            ok = (((w1_i ^ a1) & 3) == 0) & (a3 == w3_i) & (d_q <= lim_q) \
                & (d_q != 0) & (d_r1.view(np.uint32) < DMAX) \
                & (gap <= I32(max_gap)) & (age <= I32(band - j))
            comb = gap * nring + apj - age + (u0 - I32(j))
            best_val, take, win, ties = _candidates(ok, comb, shift)
            stats["ties"] += int((ties & take).sum())
            dr_w = adr.reshape(idx.size, -1)[np.arange(idx.size), win]
            dp_t = np.where(take, best_val, I32(0))
            dr_t = np.where(take, dr_w + I32(1 << ROOT_BITS),
                            base_col[idx] + I32(t0 + j))
            out_s[idx, j], out_dr[idx, j] = dp_t, dr_t
            kw1[idx, K, j], kw2[idx, K, j], kw3[idx, K, j] = \
                c1[idx, j], c2[idx, j], c3[idx, j]
            kpj[idx, K, j] = dp_t * I32(RING)
            kdr[idx, K, j] = dr_t
            kage[idx, K, j] = -j
        kw1[:, K] = np.where(active[:, None] & ~mine_valid, I32(0),
                             kw1[:, K])
        _write_rule(score, dr, writes, out_s, out_dr, cc, t0, nsteps,
                    active, seg, row, base_col, S, H)
    assert (writes == 1).all(), "every column is written exactly once"
    return score, dr, stats


def emulate_chain(planes, band, pcl, max_gap, anchor_score, ebits=None):
    """The padded DP kernels' schedule: dp_chain_kernel's on three planes
    (qp, rp, rcv), returning (dd, root, stats), or with `ebits`
    dp_chain_packed_kernel's on two (qprv, rprc), returning (ddr, stats).

    The layout policies (csrc/dp_padded.cu Padded and Packed):
      * unpacked: a = qp, b = rp, c = rcv; valid = c & 1; rev = c & 2;
        same = c_j == c_i; an emptied slot clears c; root and depth apart;
      * packed: a = qprv, b = rprc, no c; qp = a >> 2; valid = a & 1; rev
        = a & 2; same = ((a_i ^ a_j) & 3) == 0; an emptied slot clears a;
        one payload word depth << EBITS | root, one hop deeper by adding
        1 << EBITS."""
    packed = ebits is not None
    L, RC = planes[0].shape
    RING = ring_size(band)
    shift = int(np.log2(RING))
    bits = dp_pallas.dbits(L)
    nreg = ring_regs(band)
    Lpad = (L + 31) // 32 * 32
    # lane-major, zero rows past L (the asynchronous copy's zero fill)
    pad = lambda x: np.concatenate([x.T, np.zeros((RC, Lpad - L), I32)], 1)
    ma, mb = pad(planes[0]), pad(planes[1])
    mc = np.zeros_like(ma) if packed else pad(planes[2])
    z = lambda: np.zeros((RC, nreg, 32), I32)
    ka, kb, kc, kpj, kroot, kdep = z(), z(), z(), z(), z(), z()
    lim_q = I32(min(pcl, DMAX))
    nring = I32(-RING)
    u0 = I32(np.int64((anchor_score + 1) * RING).astype(I32))
    dd = np.zeros((Lpad, RC), I32)
    root = np.zeros((Lpad, RC), I32)
    stats = {"anchor_steps": np.zeros(RC, np.int64), "tiles_stepped": 0,
             "tiles_skipped": 0, "ties": 0, "lanes": RC}
    for t0 in range(0, L, 32):
        K = (t0 // 32) % nreg
        kage = _ages(RC, nreg, K)
        nsteps = min(32, L - t0)
        ac, bc, cc = (m[:, t0:t0 + 32] for m in (ma, mb, mc))
        mine_valid = ((ac if packed else cc) & 1) != 0
        todo = (LID[None, :] < nsteps) & mine_valid
        stats["tiles_stepped"] += int(todo.any(1).sum())
        stats["tiles_skipped"] += int((~todo.any(1)).sum())
        out_b = np.broadcast_to(I32(t0) + LID, (RC, 32)).copy()
        # a step that does not run: dp 0 (and depth 0), root t
        out_a = out_b.copy() if packed else np.zeros((RC, 32), I32)
        for j in range(nsteps):
            idx = np.nonzero(todo[:, j])[0]
            if idx.size == 0:
                continue
            stats["anchor_steps"][idx] += 1
            inv = ~mine_valid[idx] & (LID[None, :] < j)
            clr = ka if packed else kc
            clr[idx, K] = np.where(inv, I32(0), clr[idx, K])
            a_i, b_i, c_i = (c[idx, j][:, None, None] for c in (ac, bc, cc))
            rev = ((a_i if packed else c_i) & 2) != 0
            sgn = np.where(rev, I32(1), I32(-1))
            off = np.where(rev, ~b_i, b_i - I32(1))
            a_, b_, c_, pj, rt, dp_, age = (x[idx] for x in (
                ka, kb, kc, kpj, kroot, kdep, kage))
            if packed:
                d_q = (a_i >> I32(2)) - (a_ >> I32(2))
                same = ((a_i ^ a_) & I32(3)) == 0
            else:
                d_q = a_i - a_
                same = c_ == c_i
            d_r1 = b_ * sgn + off
            gap = np.abs(d_q - d_r1 - I32(1))
            ok = same & (d_q <= lim_q) & (d_q != 0) \
                & (d_r1.view(np.uint32) < DMAX) & (gap <= I32(max_gap)) \
                & (age <= I32(band - j))
            comb = gap * nring + pj - age + (u0 - I32(j))
            best_val, take, win, ties = _candidates(ok, comb, shift)
            stats["ties"] += int((ties & take).sum())
            sel = lambda x: x.reshape(idx.size, -1)[np.arange(idx.size), win]
            dp_t = np.where(take, best_val, I32(0))
            if packed:
                # kroot holds the payload word; kdep stays unused
                pay_t = np.where(take, sel(rt) + I32(1 << ebits),
                                 I32(t0 + j))
                out_a[idx, j] = (dp_t << I32(2 * ebits)) | pay_t
                kroot[idx, K, j] = pay_t
            else:
                root_t = np.where(take, sel(rt), I32(t0 + j))
                dep_t = np.where(take, sel(dp_) + I32(1), I32(0))
                out_a[idx, j] = (dp_t << I32(bits)) | dep_t
                out_b[idx, j] = root_t
                kroot[idx, K, j], kdep[idx, K, j] = root_t, dep_t
            ka[idx, K, j], kb[idx, K, j], kc[idx, K, j] = \
                ac[idx, j], bc[idx, j], cc[idx, j]
            kpj[idx, K, j] = dp_t * I32(RING)
            kage[idx, K, j] = -j
        clr = ka if packed else kc
        clr[:, K] = np.where(~mine_valid, I32(0), clr[:, K])
        dd[t0:t0 + 32] = out_a.T
        root[t0:t0 + 32] = out_b.T
    if packed:
        return dd[:L], stats
    return dd[:L], root[:L], stats


# --- K3: the 2-plane compact stream ---

# (seed, R, A, l_cap, band, edges): bands 8, 20 (the default preset) and
# 31 (the widest that the mod-32 cid tag allows) at per-chunk caps 257
# and 512; `edges` as in _WIDE below, on the 2-plane words
_COMPACT = [
    (11, 3, 8192, 257, 8, False),
    (12, 3, 8192, 512, 8, True),
    (13, 3, 8192, 512, 20, False),
    (14, 3, 8192, 257, 20, True),
    (15, 3, 8192, 512, 20, True),
    (16, 3, 8192, 257, 31, False),
    (17, 3, 8192, 512, 31, True),
]


@pytest.mark.parametrize("seed,R,A,l_cap,band,edges", _COMPACT)
def test_compact_schedule_matches_plain_and_pallas(seed, R, A, l_cap, band,
                                                   edges):
    w1, w2, colc = synth.dp_stream(np.random.default_rng(seed), R, A, l_cap,
                                   edges=edges)
    s, d, st = emulate_compact(w1, w2, colc, band, PCL, MAX_GAP, SCORE,
                               l_cap)
    ps, pd = dp_compact.dp_chain_compact_plain(
        *map(torch.from_numpy, (w1, w2, colc)), band, PCL, MAX_GAP, SCORE,
        l_cap)
    np.testing.assert_array_equal(s, ps.numpy())
    np.testing.assert_array_equal(d, pd.numpy())
    js, jd = jax_dp(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(colc),
                    band, PCL, MAX_GAP, SCORE, l_cap, interpret=True)
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(d, np.asarray(jd))
    # the schedule did what it is for on these streams
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    assert (d >> ROOT_BITS).max() > 3                     # chains formed
    assert st["tiles_skipped"] > 0                        # invalid tails
    assert st["prev_winners"] > 0 and st["tile_winners"] > 0
    assert st["halo_steps"].max() <= H
    assert (st["halo_steps"][:-R] < H).any()              # halo stopped
    # both phases only on tiles with a valid anchor
    assert st["rounds"].sum() == 31 * st["tiles_stepped"]
    assert st["tiles_stepped"] * 32 < st["lanes"] * (S + H)
    if edges:
        assert st["ties"] > 0                             # equal scores
        assert (st["rounds"][::R] == 0).all()             # all-invalid lane
        cols = np.arange(A)
        assert (s[0] == 0).all()
        assert (d[0] == np.where((cols < S) | (cols % S < H), cols, 0)).all()


def test_compact_schedule_chunk_longer_than_segment():
    """The 2-plane edge row: a chunk longer than S restarts mid-chunk in the
    next lane (its columns there take the halo value up to H and 0 after
    it), and the previous lane's halo reaches exactly its end."""
    seed, R, A, l_cap, band, edges = _COMPACT[4]
    w1, w2, colc = synth.dp_stream(np.random.default_rng(seed), R, A, l_cap,
                                   edges=edges)
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    s, d, st = emulate_compact(w1, w2, colc, band, PCL, MAX_GAP, SCORE,
                               l_cap)
    ps, pd = dp_compact.dp_chain_compact_plain(
        *map(torch.from_numpy, (w1, w2, colc)), band, PCL, MAX_GAP, SCORE,
        l_cap)
    np.testing.assert_array_equal(s, ps.numpy())
    np.testing.assert_array_equal(d, pd.numpy())
    c1 = colc[1, S:2 * S]
    past = (c1 > np.arange(S)) & (np.arange(S) >= H)
    assert past.any() and (s[1, S:2 * S][past] == 0).all()
    lane0, lane1 = 0 * R + 1, 1 * R + 1
    assert st["halo_steps"][lane0] == H
    assert 0 < st["halo_steps"][lane1] <= H


# --- K8: the compact stream ---

# (seed, R, A, l_cap, band, tag, edges): the tag packing at band 20, the
# medium, slow, -c 20 and widest bands; bands 32, 64 and 96 (-c 78 / 39 /
# 26), where the 32 * ring_regs(band) slots equal the band exactly, and 160
# and 192 (5 and 6 registers); `edges` puts an all-invalid lane in row 0
# and, in row 1, a chunk longer than S crossing two segment boundaries, a
# chunk longer than l_cap (the halo) and equal-score runs
_WIDE = [
    (1, 3, 8192, 256, 20, True, True),
    (2, 3, 8192, 256, 35, False, True),
    (3, 3, 8192, 1024, 83, False, True),
    (4, 3, 8192, 256, 125, False, True),
    (5, 3, 8192, 256, 200, False, True),
    (6, 2, 8192, 512, 83, False, False),
    (7, 3, 8192, 256, 32, False, True),
    (8, 3, 8192, 512, 64, False, True),
    (9, 3, 8192, 256, 96, False, True),
    (10, 3, 8192, 256, 160, False, True),
    (18, 3, 8192, 256, 192, False, True),
]


def _wide_case(seed, R, A, l_cap, tag, edges):
    rng = np.random.default_rng(seed)
    return synth.dp_stream_wide(rng, R, A, l_cap, tag=tag, edges=edges)


@pytest.mark.parametrize("seed,R,A,l_cap,band,tag,edges", _WIDE)
def test_compact_wide_schedule_matches_plain_and_pallas(seed, R, A, l_cap,
                                                        band, tag, edges):
    w1, w2, w3, colc = _wide_case(seed, R, A, l_cap, tag, edges)
    s, d, st = emulate_compact_wide(w1, w2, w3, colc, band, PCL, MAX_GAP,
                                    SCORE, l_cap)
    ps, pd = dp_compact.dp_chain_compact_wide(
        *map(torch.from_numpy, (w1, w2, w3, colc)), band, PCL, MAX_GAP,
        SCORE, l_cap)
    np.testing.assert_array_equal(s, ps.numpy())
    np.testing.assert_array_equal(d, pd.numpy())
    js, jd = jax_dp_wide(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3),
                         jnp.asarray(colc), band, PCL, MAX_GAP, SCORE, l_cap,
                         interpret=True)
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(d, np.asarray(jd))
    # the schedule did what it is for on these streams
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    assert (d >> ROOT_BITS).max() > 3                     # chains formed
    assert st["tiles_skipped"] > 0                        # invalid tails
    assert st["halo_steps"].max() <= H
    assert (st["halo_steps"][:-R] < H).any()              # halo stopped
    assert st["anchor_steps"].sum() < st["lanes"] * (S + H)
    if edges:
        assert st["ties"] > 0                             # equal scores
        assert (st["anchor_steps"][::R] == 0).all()       # all-invalid lane
        # its own column as root, or 0 where no halo covers the column
        cols = np.arange(A)
        assert (s[0] == 0).all()
        assert (d[0] == np.where((cols < S) | (cols % S < H), cols, 0)).all()


def test_compact_wide_schedule_chunk_longer_than_segment():
    """Row 1 of the edge streams: a chunk longer than S restarts mid-chunk
    in the next lane (its columns there take the halo value up to H and 0
    after it), and the previous lane's halo reaches exactly its end."""
    seed, R, A, l_cap, band, tag, edges = _WIDE[2]
    w1, w2, w3, colc = _wide_case(seed, R, A, l_cap, tag, edges)
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    s, d, st = emulate_compact_wide(w1, w2, w3, colc, band, PCL, MAX_GAP,
                                    SCORE, l_cap)
    ps, pd = dp_compact.dp_chain_compact_wide_plain(
        *map(torch.from_numpy, (w1, w2, w3, colc)), band, PCL, MAX_GAP,
        SCORE, l_cap)
    np.testing.assert_array_equal(s, ps.numpy())
    np.testing.assert_array_equal(d, pd.numpy())
    # columns of segment 1 whose chunk began in segment 0, past the halo
    c1 = colc[1, S:2 * S]
    past = (c1 > np.arange(S)) & (np.arange(S) >= H)
    assert past.any() and (s[1, S:2 * S][past] == 0).all()
    # lane (segment 0, row 1) stops its halo at the chunk's last covered
    # column; (segment 1, row 1) scans its whole halo (the chunk runs on)
    lane0, lane1 = 0 * R + 1, 1 * R + 1
    assert st["halo_steps"][lane0] == H
    assert 0 < st["halo_steps"][lane1] <= H


@pytest.mark.parametrize("band", [20, 35, 83, 125, 200, 32, 64, 96, 160,
                                  192])
def test_band_sized_ring_registers(band):
    """ceil(band / 32) registers a thread: 1 / 2 / 3 / 4 / 7 at the bands
    of the presets, against RING / 32 = 1 / 2 / 4 / 4 / 8; exactly band / 32
    at 32, 64 and 96; 5 and 6 at 160 and 192."""
    want = {20: 1, 35: 2, 83: 3, 125: 4, 200: 7, 32: 1, 64: 2, 96: 3,
            160: 5, 192: 6}[band]
    assert ring_regs(band) == want and 32 * ring_regs(band) >= band
    assert ring_regs(band) <= max(ring_size(band) // 32, 1)


# --- K10: the padded layout ---

@pytest.mark.parametrize("band,L,RC", [
    (20, 96, 40), (35, 128, 40), (83, 256, 24), (125, 256, 24),
    (200, 256, 16), (32, 128, 40), (64, 256, 24), (96, 256, 24),
    (160, 256, 16), (192, 256, 16)])
def test_chain_schedule_matches_plain_scan_and_pallas(band, L, RC):
    """synth.padded_dp_case: an empty lane, a colinear lane (every
    candidate ties on the gap), validity holes, contig and strand changes
    inside the band, duplicated ref positions, I32MAX padding."""
    qp, rp, rcv = synth.padded_dp_case(np.random.default_rng(band + L), L,
                                       RC)
    dd, root, st = emulate_chain((qp, rp, rcv), band, PCL, MAX_GAP, SCORE)
    pdd, proot = dp_pallas.dp_chain_plain(
        *map(torch.from_numpy, (qp, rp, rcv)), band, PCL, MAX_GAP, SCORE)
    np.testing.assert_array_equal(dd, pdd.numpy())
    np.testing.assert_array_equal(root, proot.numpy())
    sdd, sroot = _dp_scan(qp, rp, rcv, band, PCL, MAX_GAP, SCORE, unroll=8)
    np.testing.assert_array_equal(dd, np.asarray(sdd))
    np.testing.assert_array_equal(root, np.asarray(sroot))
    jdd, jroot = _dp_pallas(qp, rp, rcv, band, PCL, MAX_GAP, SCORE,
                            interpret=True)
    np.testing.assert_array_equal(dd, np.asarray(jdd))
    np.testing.assert_array_equal(root, np.asarray(jroot))
    assert st["anchor_steps"][0] == 0                     # the empty lane
    assert st["anchor_steps"][1] == L                     # the full lane
    assert st["ties"] > 0 and st["tiles_skipped"] > 0
    assert (dd & ((1 << dp_pallas.dbits(L)) - 1)).max() > 3


@pytest.mark.parametrize("band", [12, 20, 31, 32, 64, 83, 125, 200])
def test_packed_chain_schedule_matches_plain_scan_and_pallas(band):
    """dp_chain_packed_kernel's schedule on synth.padded_dp_case's packed
    words (lanes as in the unpacked test; contig changes ride in rprc),
    against the plain version, the lax.scan reference and the Pallas
    kernel: 1 to 7 ring registers, band = 32 * NREG at 32 and 64."""
    L, RC = 256, 16
    E = int(np.ceil(np.log2(L)))
    qprv, rprc = synth.padded_dp_case(np.random.default_rng(band + 7), L,
                                      RC, packed=True)
    ddr, st = emulate_chain((qprv, rprc), band, PCL, MAX_GAP, SCORE,
                            ebits=E)
    pddr = dp_pallas.dp_chain_packed_plain(
        torch.from_numpy(qprv), torch.from_numpy(rprc), band, PCL, MAX_GAP,
        SCORE, E)
    np.testing.assert_array_equal(ddr, pddr.numpy())
    np.testing.assert_array_equal(ddr, np.asarray(_dp_scan_packed(
        qprv, rprc, band, PCL, MAX_GAP, SCORE, E, unroll=8)))
    np.testing.assert_array_equal(ddr, np.asarray(_dp_pallas_packed(
        qprv, rprc, band, PCL, MAX_GAP, SCORE, E, interpret=True)))
    assert st["anchor_steps"][0] == 0                     # the empty lane
    assert st["anchor_steps"][1] == L                     # the full lane
    assert st["ties"] > 0 and st["tiles_skipped"] > 0
    assert ((ddr >> E) & ((1 << E) - 1)).max() > 3
