"""Banded chaining DP over the PADDED chunk layout.

Replaces skani_tpu/kernels/dp_pallas.py dp_chain and dp_chain_packed (the
module keeps its counterpart's name): the reference's per-chunk
quadratic-with-band chaining DP (reference: src/chain.rs:838-896) over
anchors regrouped to one lane per chunk.  The layout is TRANSPOSED
relative to the rest of phase A: arrays are (L, RC) = (anchor index within
the chunk, chunk row), and the recurrence walks t = 0..L-1 in order, each
step choosing among the trailing `band` anchors of the same lane.  Chain
ROOT (the padded anchor index of the chain's first anchor) and DEPTH (hops
from the root) propagate through the band window, so chain extraction
needs no pointer chasing.

phase A takes these DPs where the compact-stream DPs (kernels/dp_compact)
do not apply: per-chunk caps of 2048 and above, the `sorted` tier at band
>= 32, the legacy generator, and `compact_dp=False`.

dp_chain         qp, rp (L, RC) int32 with I32MAX fill, rcv (L, RC) int32 =
                 contig*4 + reverse*2 + valid.  Returns dd = score <<
                 dbits(L) | depth and root, both (L, RC) int32.
dp_chain_packed  qprv = qp << 2 | rev << 1 | valid (qp < 2^24), rprc =
                 rc << 25 | rp (rp < 2^24, rc < 64).  Returns ddr = score
                 << 2*EBITS | depth << EBITS | root with EBITS =
                 ceil_log2(L_CAP); needs L * anchor_score < 2^(32 -
                 2*EBITS).  The same-ref-contig test is IMPLICIT: when rc
                 differs, |d_r| >= 2^25 - (2^24 - 1) > 2^24, so the d_r > 0
                 / d_r <= D_MAX_LIN_LENGTH / gap <= max_gap tests reject
                 the transition in every sign case.

Every column is written, invalid ones too (score 0, depth 0, root t): the
callers checksum and gather the whole arrays.  int32 arithmetic wraps, as
XLA's does (differences of I32MAX padding wrap).

Two implementations with identical outputs: the plain versions (a Python
loop over t on (RING, RC) ring tensors) and the CUDA kernels in
csrc/dp_padded.cu (a warp per lane, 8 lanes a block, 32-row tiles through
shared memory; both step only valid anchors, hold a ring of ceil(band /
32) registers a thread (dp_compact.ring_regs) and copy the next tile with
cp.async).  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params import D_MAX_LIN_LENGTH
from . import _build
from .dp_compact import MAX_RING, NEGI, ring_regs, ring_size

#: kernel launches (CPU calls never count)
LAUNCHES = {"dp_chain": 0, "dp_chain_packed": 0}


def dbits(L: int) -> int:
    """Bits of the depth field of dp_chain's dd word."""
    return int(np.ceil(np.log2(L + 1)))


def _check(name, planes, band, max_gap, anchor_score):
    p0 = planes[0]
    if p0.dim() != 2 or any(p.shape != p0.shape for p in planes):
        raise ValueError(f"{name}: the planes must share one (L, RC) shape")
    if float(max_gap) != float(int(max_gap)) \
            or float(anchor_score) != float(int(anchor_score)):
        raise ValueError(f"{name}: max_gap and anchor_score must be "
                         f"integral")
    RING = ring_size(band)
    if RING > MAX_RING:
        raise ValueError(f"{name}: band {band} needs a ring of {RING} "
                         f"slots; the kernel holds at most {MAX_RING}")
    return p0.shape[0], p0.shape[1], RING


def _plain(planes, band, pcl, max_gap, anchor_score, pack):
    """Plain version of both kernels: the ring-buffer recurrence of the
    TPU kernels in torch ops, one step per t, vectorised over lanes and
    ring slots.  Two planes take the packed rule (orientation on bit 1 of
    qprv, contig inside rprc), three the rcv rule.  `pack(dp, dep, root)`
    forms the outputs of one step."""
    L, RC = planes[0].shape
    packed = len(planes) == 2
    RING = ring_size(band)
    dev = planes[0].device
    i32 = torch.int32
    max_gap = int(max_gap)
    anchor_score = int(anchor_score)
    ring_shift = int(np.log2(RING))
    dmax = int(D_MAX_LIN_LENGTH)
    zr = lambda: torch.zeros((RING, RC), dtype=i32, device=dev)
    dpw, aw, bw, cw, rootw, depw = zr(), zr(), zr(), zr(), zr(), zr()
    slotw = torch.full((RING, RC), -(1 << 29), dtype=i32, device=dev)
    outs = None
    negi = torch.tensor(NEGI, dtype=i32, device=dev)
    zero = torch.zeros((), dtype=i32, device=dev)
    for t in range(L):
        a_i, b_i = planes[0][t], planes[1][t]
        if packed:
            d_q = (a_i >> 2) - (aw >> 2)
            rev_i = (a_i >> 1) & 1
            ok = ((aw ^ a_i) & 2) == 0              # same orientation
            ok &= (aw & a_i & 1) == 1               # both valid
        else:
            c_i = planes[2][t]
            d_q = a_i - aw
            rev_i = (c_i >> 1) & 1
            ok = (cw >> 1) == (c_i >> 1)     # same contig and orientation
            ok &= (cw & c_i & 1) == 1               # both valid
        d_r_f = b_i - bw
        d_r = torch.where(rev_i == 1, -d_r_f, d_r_f)
        gap = torch.abs(d_r - d_q)
        ok &= (d_q <= pcl) & (d_q != 0)
        ok &= b_i != bw
        ok &= (d_q <= dmax) & (d_r <= dmax)
        ok &= d_r > 0
        ok &= gap <= max_gap
        ok &= slotw >= max(t - band, 0)             # j in [t-band, t-1]
        # combined (score, j) key: ties go to the LARGEST j, matching the
        # reference's backward scan with strict '>'
        rel = slotw - (t - RING)
        cand = anchor_score - gap + dpw
        comb = torch.where(ok, cand * RING + rel, negi)
        best = comb.max(dim=0).values
        best_val = best >> ring_shift               # floor(best / RING)
        take = best_val > 0
        onehot = ok & (comb == best)
        pick_root = torch.where(onehot, rootw, zero).sum(0, dtype=i32)
        pick_dep = torch.where(onehot, depw, zero).sum(0, dtype=i32)
        dp_t = torch.where(take, best_val, zero)
        root_t = torch.where(take, pick_root, zero + t)
        dep_t = torch.where(take, pick_dep + 1, zero)
        step = pack(dp_t, dep_t, root_t)
        if outs is None:
            outs = [torch.empty((L, RC), dtype=i32, device=dev)
                    for _ in step]
        for o, v in zip(outs, step):
            o[t] = v
        s = t % RING
        dpw[s] = dp_t
        aw[s] = a_i
        bw[s] = b_i
        if not packed:
            cw[s] = c_i
        rootw[s] = root_t
        depw[s] = dep_t
        slotw[s] = t
    if outs is None:        # L == 0
        outs = [torch.empty((0, RC), dtype=i32, device=dev)
                for _ in range(1 if packed else 2)]
    return outs


def dp_chain_plain(qp, rp, rcv, band: int, pcl: int, max_gap: float,
                   anchor_score: float):
    """Plain version of dp_chain."""
    L, _RC, _RING = _check("dp_chain", [qp, rp, rcv], band, max_gap,
                           anchor_score)
    DB = dbits(L)
    dd, root = _plain([qp, rp, rcv], band, pcl, max_gap, anchor_score,
                      lambda dp, dep, root: ((dp << DB) | dep, root))
    return dd, root


def dp_chain_packed_plain(qprv, rprc, band: int, pcl: int, max_gap: float,
                          anchor_score: float, EBITS: int):
    """Plain version of dp_chain_packed."""
    _check("dp_chain_packed", [qprv, rprc], band, max_gap, anchor_score)
    return _plain([qprv, rprc], band, pcl, max_gap, anchor_score,
                  lambda dp, dep, root: ((dp << (2 * EBITS))
                                         | (dep << EBITS) | root,))[0]


def _launch(name, planes, n_out, band, pcl, max_gap, anchor_score, bits):
    L, RC, RING = _check(name, planes, band, max_gap, anchor_score)
    dev = planes[0].device
    if dev.type != "cuda" or any(p.device != dev for p in planes):
        raise RuntimeError(f"{name}: tensors must all lie on one CUDA "
                           f"device or all on the CPU")
    for p in planes:
        if p.dtype != torch.int32 or not p.is_contiguous():
            raise TypeError(f"{name}: expected contiguous int32")
    if L * RC >= (1 << 31):
        raise ValueError(f"{name}: unsupported shape ({L}, {RC})")
    outs = [torch.empty((L, RC), dtype=torch.int32, device=dev)
            for _ in range(n_out)]
    lib = _build.lib()
    _build.check(getattr(lib, "skt_" + name)(
        *(p.data_ptr() for p in planes), *(o.data_ptr() for o in outs),
        L, RC, int(band), int(pcl), int(max_gap), int(anchor_score),
        int(bits), RING, int(np.log2(RING)), ring_regs(band),
        _build.stream_ptr(dev)),
        name)
    LAUNCHES[name] += 1
    return outs


def dp_chain(qp, rp, rcv, band: int, pcl: int, max_gap: float,
             anchor_score: float):
    """Padded banded DP.  qp, rp (L, RC) int32 (I32MAX fill), rcv (L, RC)
    int32 = contig*4 + reverse*2 + valid.  Returns (dd, root): dd = score
    << dbits(L) | depth, root = the chain root's row t.  The ring holds at
    most 256 slots (band <= 255); a wider band raises ValueError."""
    planes = [qp, rp, rcv]
    if all(p.device.type == "cpu" for p in planes):
        return dp_chain_plain(qp, rp, rcv, band, pcl, max_gap, anchor_score)
    dd, root = _launch("dp_chain", planes, 2, band, pcl, max_gap,
                       anchor_score, dbits(qp.shape[0]))
    return dd, root


def dp_chain_packed(qprv, rprc, band: int, pcl: int, max_gap: float,
                    anchor_score: float, EBITS: int):
    """Padded banded DP on packed words (see the module docstring).
    Returns ddr (L, RC) int32 = score << 2*EBITS | depth << EBITS | root."""
    L = qprv.shape[0]
    if L * int(anchor_score) >= (1 << (32 - 2 * EBITS)) or L > (1 << EBITS):
        raise ValueError(f"dp_chain_packed: L={L} at anchor_score "
                         f"{anchor_score} does not fit EBITS={EBITS}")
    planes = [qprv, rprc]
    if all(p.device.type == "cpu" for p in planes):
        return dp_chain_packed_plain(qprv, rprc, band, pcl, max_gap,
                                     anchor_score, EBITS)
    return _launch("dp_chain_packed", planes, 1, band, pcl, max_gap,
                   anchor_score, EBITS)[0]
