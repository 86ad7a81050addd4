"""Banded chaining DP over the COMPACT anchor stream (no regroup pass).

Replaces skani_tpu/kernels/dp_compact.py dp_chain_compact and
dp_chain_compact_wide: the DP walks
the anchors exactly where phase A produced them.  The compact stream is
the concatenation of chunks (anchors of one chunk occupy consecutive
columns), so a sequential scan down each row with the usual band ring
buffer computes the reference recurrence (reference:
src/chain.rs:838-896), provided transitions never cross a chunk
boundary.  Chunk identity travels in-band: 5 spare bits of the packed
anchor word carry cid mod 32, and since cids are nondecreasing and a band
window spans < 32 anchors, the mod-32 tag is unambiguous inside any
window — one XOR+mask compare rejects cross-chunk (and cross-orientation)
transitions.  The 3-plane variant (`dp_chain_compact_wide`) carries chunk
and ref-contig identity in a third word instead, compared for equality, so
it has no band limit: the slow preset (band 83) packs the FULL cid there
(w3 = cid * 64 + rc).

Parallelism: each row's A columns split into A/S segments scanned in
parallel lanes (lane = segment x row).  A chunk crossing a segment
boundary is finished by the lane owning its first anchor, which scans H
extra halo columns into the next segment (H = L_CAP: longer chunks
already overflow to the exact native path).  The next lane's scan of
those columns starts mid-chunk and is discarded by an element-wise select
(col_in_chunk > col % S picks the halo value).

Outputs per anchor (compact order): score, and depth<<20|root where root
is the anchor's chain-root COMPACT column (A <= 2^20, depth < L_CAP <=
2^11).

Two implementations with identical outputs on every column, valid or not:
the plain versions (the segment-lane walk in torch ops, vectorised over
lanes; T = S + H steps) and the CUDA kernels in csrc/dp_compact.cu (one
warp per lane; each stops its halo after the last column it writes).  The
2-plane kernel walks 32-column tiles in two phases: the candidates' terms
that need no DP value in parallel, one target a thread, then the
loop-carried chain, one shuffle and a max per valid column.  The 3-plane
kernel steps only valid anchors over a ring of ceil(band / 32) registers a
thread, with a warp max per step.  Neither is bound by bytes: the 2-plane
kernel by its chain's latency, the 3-plane one by the issue rate of its
int32 work.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import D_MAX_LIN_LENGTH
from . import _build

CID_SHIFT = 26          # w1 bits 26-30: cid mod 32
CID_MASK = 0x1F << CID_SHIFT
QP_MASK = (1 << 24) - 1
ROOT_BITS = 20
NEGI = -(1 << 29)       # "impossible" combined score

#: kernel launches (CPU calls never count)
LAUNCHES = {"dp_chain_compact": 0, "dp_chain_compact_wide": 0}

#: widest ring the kernels hold in registers (8 registers of slots a thread)
MAX_RING = 256


def ring_size(band: int) -> int:
    """Ring buffer length: smallest power of two > band (so the window
    always retains the trailing `band` anchors), at least 8.  The default
    c=125 yields band 20 -> ring 32."""
    return max(8, 1 << int(np.ceil(np.log2(band + 1))))


def ring_regs(band: int) -> int:
    """Registers of ring slots a thread of the wide kernels
    (dp_chain_compact_wide, dp_pallas.dp_chain and dp_chain_packed):
    ceil(band / 32), so the 32 * NREG slots cover the band window; 1 to
    8."""
    return min(max((band + 31) // 32, 1), 8)


def seg_len(A: int, l_cap: int) -> int:
    """Segment length: >= the halo (one chunk never crosses two segment
    boundaries) and dividing A (A is a multiple of 2048)."""
    s = 2048
    while s < l_cap:
        s *= 2
    return min(s, A)


def _geometry(planes, col_in_chunk, band, max_gap, anchor_score, l_cap):
    w1 = planes[0]
    if any(p.shape != w1.shape for p in planes) \
            or col_in_chunk.shape != w1.shape or w1.dim() != 2:
        raise ValueError("dp_chain_compact: the planes and col_in_chunk "
                         "must share one (R, A) shape")
    if len(planes) == 2 and band >= 32:
        raise ValueError("dp_chain_compact: the mod-32 cid tag needs "
                         "band < 32")
    if float(max_gap) != float(int(max_gap)) \
            or float(anchor_score) != float(int(anchor_score)):
        raise ValueError("dp_chain_compact: max_gap and anchor_score must "
                         "be integral")
    R, A = w1.shape
    S = seg_len(A, l_cap)
    H = min(l_cap, S)
    RING = ring_size(band)
    if A % S or A > (1 << ROOT_BITS) or l_cap > (1 << 11) - 1 \
            or (l_cap * int(anchor_score) + 1) * RING >= (1 << 31):
        raise ValueError(f"dp_chain_compact: unsupported A={A}, "
                         f"l_cap={l_cap}")
    return R, A, S, H, RING


def _plain(planes, col_in_chunk, band, pcl, max_gap, anchor_score, l_cap):
    """Plain version of both kernels: the segment-lane walk of the TPU
    layout in torch ops (T = S + H steps, each vectorised over lanes and
    ring slots), then the halo select.  Two planes take the cid-tag rule,
    three the w3-equality rule.  int32 arithmetic wraps as XLA's does."""
    R, A, S, H, RING = _geometry(planes, col_in_chunk, band, max_gap,
                                 anchor_score, l_cap)
    wide = len(planes) == 3
    w1 = planes[0]
    K = A // S
    T = S + H
    L = K * R
    dev = w1.device
    i32 = torch.int32
    max_gap = int(max_gap)
    anchor_score = int(anchor_score)
    ring_shift = int(np.log2(RING))
    dmax = int(D_MAX_LIN_LENGTH)

    def marshal(x):
        xp = torch.cat([x, x.new_zeros((R, H))], dim=1)
        segs = torch.stack([xp[:, k * S:k * S + T] for k in range(K)], 0)
        return segs.permute(2, 0, 1).reshape(T, L).contiguous()

    m1, m2 = marshal(planes[0]), marshal(planes[1])
    m3 = marshal(planes[2]) if wide else None
    base_col = (torch.arange(L, device=dev, dtype=i32) // R) * S
    dpw = torch.zeros((RING, L), dtype=i32, device=dev)
    w1w = torch.zeros_like(dpw)
    w2w = torch.zeros_like(dpw)
    w3w = torch.full_like(dpw, -1)     # never equal to a real word
    rootw = torch.zeros_like(dpw)
    depw = torch.zeros_like(dpw)
    slotw = torch.full_like(dpw, -(1 << 29))
    score_m = torch.empty((T, L), dtype=i32, device=dev)
    dr_m = torch.empty((T, L), dtype=i32, device=dev)
    negi = torch.tensor(NEGI, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    for t in range(T):
        w1_i = m1[t]
        w2_i = m2[t]
        if wide:
            w3_i = m3[t]
            d_q = (w1_i >> 2) - (w1w >> 2)
            ok = (w3w == w3_i) & (((w1w ^ w1_i) & 2) == 0)
        else:
            d_q = ((w1_i >> 2) & QP_MASK) - ((w1w >> 2) & QP_MASK)
            ok = ((w1w ^ w1_i) & (CID_MASK | 2)) == 0
        d_r_f = w2_i - w2w
        d_r = torch.where(((w1_i >> 1) & 1) == 1, -d_r_f, d_r_f)
        gap = torch.abs(d_r - d_q)
        ok &= (w1w & w1_i & 1) == 1
        ok &= (d_q <= pcl) & (d_q != 0)
        ok &= w2_i != w2w
        ok &= (d_q <= dmax) & (d_r <= dmax)
        ok &= d_r > 0
        ok &= gap <= max_gap
        ok &= slotw >= max(t - band, 0)
        rel = slotw - (t - RING)
        cand = anchor_score - gap + dpw
        comb = torch.where(ok, cand * RING + rel, negi)
        best = comb.max(dim=0).values
        best_val = best >> ring_shift
        take = best_val > 0
        onehot = ok & (comb == best)
        pick_root = torch.where(onehot, rootw, zero).sum(0, dtype=i32)
        pick_dep = torch.where(onehot, depw, zero).sum(0, dtype=i32)
        dp_t = torch.where(take, best_val, zero)
        root_t = torch.where(take, pick_root, base_col + t)
        dep_t = torch.where(take, pick_dep + 1, zero)
        score_m[t] = dp_t
        dr_m[t] = (dep_t << ROOT_BITS) | root_t
        s = t % RING
        dpw[s] = dp_t
        w1w[s] = w1_i
        w2w[s] = w2_i
        if wide:
            w3w[s] = w3_i
        rootw[s] = root_t
        depw[s] = dep_t
        slotw[s] = t

    def unmarshal(o):
        segs = o.reshape(T, K, R).permute(1, 2, 0)             # (K, R, T)
        main = segs[:, :, :S].permute(1, 0, 2).reshape(R, A)
        halo = segs[:, :, S:]                                  # (K, R, H)
        halo = torch.cat([halo.new_zeros((1, R, H)), halo[:-1]], dim=0)
        halo = torch.cat([halo, halo.new_zeros((K, R, S - H))], dim=2)
        return main, halo.permute(1, 0, 2).reshape(R, A)

    # a chunk crossing a segment boundary belongs to the PREVIOUS lane:
    # its anchors' correct values sit in that lane's halo columns
    ls = torch.arange(A, device=dev, dtype=i32)[None, :] % S
    fix = col_in_chunk > ls
    sm, sh = unmarshal(score_m)
    dm, dh = unmarshal(dr_m)
    return torch.where(fix, sh, sm), torch.where(fix, dh, dm)


def dp_chain_compact_plain(w1, w2, col_in_chunk, band: int, pcl: int,
                           max_gap: float, anchor_score: float,
                           l_cap: int):
    """Plain version of dp_chain_compact (2 planes, cid tag in w1)."""
    return _plain([w1, w2], col_in_chunk, band, pcl, max_gap, anchor_score,
                  l_cap)


def dp_chain_compact_wide_plain(w1, w2, w3, col_in_chunk, band: int,
                                pcl: int, max_gap: float,
                                anchor_score: float, l_cap: int):
    """Plain version of dp_chain_compact_wide (3 planes, w3 equality)."""
    return _plain([w1, w2, w3], col_in_chunk, band, pcl, max_gap,
                  anchor_score, l_cap)


def _run(name, planes, col_in_chunk, band, pcl, max_gap, anchor_score,
         l_cap):
    """Dispatch shared by both entry points: the plain version for CPU
    tensors, the CUDA kernel for tensors on one CUDA device, else raise."""
    R, A, S, H, RING = _geometry(planes, col_in_chunk, band, max_gap,
                                 anchor_score, l_cap)
    if RING > MAX_RING:
        raise ValueError(f"{name}: band {band} needs a ring of {RING} "
                         f"slots; the kernel holds at most {MAX_RING}")
    tensors = list(planes) + [col_in_chunk]
    if all(t.device.type == "cpu" for t in tensors):
        return _plain(planes, col_in_chunk, band, pcl, max_gap,
                      anchor_score, l_cap)
    dev = planes[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise RuntimeError(f"{name}: tensors must all lie on one CUDA "
                           f"device or all on the CPU")
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name}: expected contiguous int32")
    score = torch.empty((R, A), dtype=torch.int32, device=dev)
    dr = torch.empty((R, A), dtype=torch.int32, device=dev)
    # the wide kernel's ring registers
    nreg = (ring_regs(band),) if len(planes) == 3 else ()
    lib = _build.lib()
    _build.check(getattr(lib, "skt_" + name)(
        *(t.data_ptr() for t in tensors), score.data_ptr(), dr.data_ptr(),
        R, A, S, H, int(band), int(pcl), int(max_gap), int(anchor_score),
        RING, int(np.log2(RING)), *nreg, _build.stream_ptr(dev)), name)
    LAUNCHES[name] += 1
    return score, dr


def dp_chain_compact(w1, w2, col_in_chunk, band: int, pcl: int,
                     max_gap: float, anchor_score: float, l_cap: int):
    """Compact-stream DP, packed positions.  w1 (R, A) = cid_tag | qp<<2
    | rev<<1 | valid (qp < 2^24), w2 (R, A) = rc<<25 | rp, int32.  Returns
    (score, depth<<20|root) in compact order, root = global column.

    The mod-32 cid tag is unambiguous only while a band window spans
    < 32 chunk boundaries (cids are nondecreasing), so band < 32; wider
    bands take dp_chain_compact_wide with a full cid."""
    return _run("dp_chain_compact", [w1, w2], col_in_chunk, band, pcl,
                max_gap, anchor_score, l_cap)


def dp_chain_compact_wide(w1, w2, w3, col_in_chunk, band: int, pcl: int,
                          max_gap: float, anchor_score: float, l_cap: int):
    """Compact-stream DP with a third plane; one w3 equality covers
    same-chunk AND same-ref-contig.  Two packings share the kernel:

      * wide tier (qp/rp exceed 24 bits): w1 = qp<<2|rev<<1|valid
        (qp < 2^28), w2 = rp, w3 = cid_tag<<26 | rc (rc < 2^26;
        band < 32: no spare bits for a full cid next to a wide rc);
      * packed wide-band tier (slow and medium presets, band >= 32):
        w2 = rp (< 2^24), w3 = cid*64 + rc (rc < 64), the FULL cid, so no
        tag-ambiguity band limit.

    Invalid columns carry w3 = -1.  The ring holds at most 256 slots
    (band <= 255); a wider band raises ValueError."""
    return _run("dp_chain_compact_wide", [w1, w2, w3], col_in_chunk, band,
                pcl, max_gap, anchor_score, l_cap)
