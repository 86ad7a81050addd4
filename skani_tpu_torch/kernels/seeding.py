"""FracMinHash seeding of DNA contigs on the card.

Replaces skani_tpu/kernels/seeding_tpu.py (`_seed_core` through
`_seed_device_batch`, `fmh_seeds_tpu_batch` and `fmh_seeds_tpu`; XLA code
there, a hand-written kernel here, csrc/seeding.cu).  The contract is the
scalar sketcher's, sketch.fmh_seeds_np, per contig: the rolling 21-mer
marker window from 2-bit codes, the seed k-mer as the low 2k bits of the
forward 21-mer and the reverse seed as the low 2k bits of the
reverse-complement 21-mer (a different sub-window), canonical min, the
mm_hash64 filter against (2^64 - 1) // c (seeds) and // marker_c
(markers, the full canonical 42-bit min(F, R)), and the 'N' resume.  The
resume is restated as a local test: window w, ending at base i = w + 20,
is dropped iff an 'N' or 'n' sits at a base j with max(20, i - k + 1) <=
j <= i, which is the reference's cummax over the N positions, with no
scan.

* `seed_batch(bases, offs, k, c, marker_c)`: a flat batch of contigs (raw
  ASCII bytes, uint8, and int64 CSR offsets) -> survivors in window order,
  contigs in batch order: kmers (int32 holding u32), positions w + 20
  (int32 holding u32), canonical flags (bool), markers (int64; below
  2^42), and the int64 offsets (B + 1) of each contig's seeds and
  markers.  Contigs shorter than 42 give nothing.
* `fmh_seeds_device_batch(seqs, params, device=None)` /
  `fmh_seeds_device(seq, params, device=None)`: what fmh_seeds_np returns,
  per contig (numpy), seeded on `device` (default CUDA; RuntimeError
  without it).
* `fmh_seeds_device_flat(seqs, params, device=None)`: the same seeds
  unsplit, one numpy array each with the contigs' offsets.
* `fmh_seeds_plain(seq, params)`: the plain version of one contig, in
  torch int64 on the CPU.

The TPU version splits 64-bit words into uint32 pairs, buckets contig
lengths to powers of two and compacts survivors to a cap with an exact
host fallback past it, all for a chip without uint64 and for static
shapes.  The kernel works in native uint64 and counts exactly.  A block
owns BLOCK_WINDOWS = THREADS x RUN consecutive windows of one contig, a
thread RUN of them: the count launch rolls the 21-mer one base a window
and writes each thread's keep and mark flags as one bit word each, and
each block's counts; an exclusive scan of the counts (torch) places every
block's output; the write launch rebuilds only the flagged windows and
writes them (tests/test_torch_seeding_schedule.py emulates both launches
in numpy).

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.  `LAUNCHES` counts the wrapper's calls on
the card (each runs the count and the write launch).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..params import ASCII_N, ASCII_N_SMALL, K_MARKER_DNA
from . import _build

#: wrapper calls that launched the kernels (CPU calls never count)
LAUNCHES = {"fmh_seeds": 0}

#: threads a block, windows a thread, windows a block (csrc/seeding.cu
#: kThreads, kRun, kBlockWindows)
THREADS = 256
RUN = 32
BLOCK_WINDOWS = THREADS * RUN
# windows of one contig that the plain version holds at once
_PLAIN_CHUNK = 1 << 22
_MK = K_MARKER_DNA
_SIGN = -(1 << 63)


def thresholds(c: int, marker_c: int):
    """The seed and marker hash thresholds, (2^64 - 1) // c and // marker_c,
    as Python ints."""
    return (2 ** 64 - 1) // c, (2 ** 64 - 1) // marker_c


def _signed(u: int) -> int:
    """An unsigned 64-bit value's bits as a signed int64."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mm_hash64_i64(key: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's 64-bit mix (hashing.mm_hash64) on int64 bits: add, shl
    and xor wrap as uint64 does; right shifts are logical."""
    key = ~(key + (key << 21))
    key = key ^ _shr(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ _shr(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ _shr(key, 28)
    return key + (key << 31)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _encode_table(device) -> torch.Tensor:
    """byte -> 2-bit code | (byte is 'N' or 'n') << 2 (sketch.BYTE_TO_SEQ:
    every byte that is not C, G, T or U, either case, codes 0)."""
    t = np.zeros(256, dtype=np.int64)
    for b, v in ((67, 1), (71, 2), (84, 3), (85, 3),
                 (99, 1), (103, 2), (116, 3), (117, 3)):
        t[b] = v
    t[ASCII_N] |= 4
    t[ASCII_N_SMALL] |= 4
    return torch.from_numpy(t).to(device)


def _check(bases, offs, k):
    if bases.dim() != 1 or offs.dim() != 1 or offs.numel() < 2:
        raise ValueError(f"seed_batch: bad shapes {tuple(bases.shape)}, "
                         f"{tuple(offs.shape)}")
    if bases.dtype != torch.uint8 or offs.dtype != torch.int64:
        raise TypeError("seed_batch: expected uint8 bases and int64 offsets")
    if bases.device != offs.device:
        raise RuntimeError("seed_batch: tensors must lie on one device")
    if not 1 <= k <= 16:
        raise ValueError("Value of k > 16 for DNA; not allowed.")


def seed_batch_plain(bases: torch.Tensor, offs: torch.Tensor, k: int,
                     c: int, marker_c: int):
    """Plain version of seed_batch in torch int64 (on the tensors' device),
    contig by contig, windows in chunks."""
    dev = bases.device
    enc = _encode_table(dev)
    thr, thr_m = (_signed(x) ^ _SIGN for x in thresholds(c, marker_c))
    seed_mask = (1 << (2 * k)) - 1
    offs_l = offs.tolist()
    parts = ([], [], [], [])
    n_seed, n_mark = [0], [0]
    for ci in range(len(offs_l) - 1):
        a, L = offs_l[ci], offs_l[ci + 1] - offs_l[ci]
        nw = L - (_MK - 1) if L >= 2 * _MK else 0
        n0 = len(parts[0])
        for w0 in range(0, nw, _PLAIN_CHUNK):
            n = min(_PLAIN_CHUNK, nw - w0)
            v = enc[bases[a + w0:a + w0 + n + _MK - 1].long()]
            code, is_n = v & 3, v >> 2
            w = torch.arange(w0, w0 + n, device=dev)
            F = torch.zeros(n, dtype=torch.int64, device=dev)
            R = torch.zeros_like(F)
            drop = torch.zeros(n, dtype=torch.bool, device=dev)
            for t in range(_MK):
                ct = code[t:t + n]
                F |= ct << (2 * (_MK - 1 - t))
                R |= (3 - ct) << (2 * t)
                if t >= _MK - k:
                    drop |= (is_n[t:t + n] == 1) & (w + t >= _MK - 1)
            fs, rs = F & seed_mask, R & seed_mask
            canon = fs < rs
            kmer = torch.where(canon, fs, rs)
            h = mm_hash64_i64(kmer) ^ _SIGN     # unsigned order as signed
            keep = (h < thr) & ~drop
            mark = keep & (h < thr_m)
            parts[0].append(_u32_bits(kmer[keep]))
            parts[1].append((w[keep] + _MK - 1).to(torch.int32))
            parts[2].append(canon[keep])
            parts[3].append(torch.where(F < R, F, R)[mark])
        n_seed.append(n_seed[-1] + sum(len(x) for x in parts[0][n0:]))
        n_mark.append(n_mark[-1] + sum(len(x) for x in parts[3][n0:]))
    empty = (torch.int32, torch.int32, torch.bool, torch.int64)
    out = [torch.cat(p) if p else torch.zeros(0, dtype=dt, device=dev)
           for p, dt in zip(parts, empty)]
    return (*out, torch.tensor(n_seed, dtype=torch.int64, device=dev),
            torch.tensor(n_mark, dtype=torch.int64, device=dev))


def block_starts(offs: torch.Tensor) -> torch.Tensor:
    """The kernels' block partition: (B + 1,) int64, the first block of
    each contig's windows (a contig of L >= 42 bases has L - 20 windows,
    BLOCK_WINDOWS a block), then the block count."""
    lens = offs[1:] - offs[:-1]
    nw = torch.where(lens >= 2 * _MK, lens - (_MK - 1), 0)
    blk = torch.zeros(offs.numel(), dtype=torch.int64, device=offs.device)
    blk[1:] = torch.cumsum((nw + BLOCK_WINDOWS - 1) // BLOCK_WINDOWS, 0)
    return blk


def seed_batch(bases: torch.Tensor, offs: torch.Tensor, k: int, c: int,
               marker_c: int):
    """Seeds of a flat batch of contigs: bases (N,) uint8 raw ASCII, offs
    (B + 1,) int64 contig offsets.  Returns (kmers int32, positions int32,
    canonical bool, markers int64, seed_offs (B + 1,) int64, marker_offs
    (B + 1,) int64): contig b's seeds are [seed_offs[b], seed_offs[b + 1])
    of the first three, its markers [marker_offs[b], marker_offs[b + 1])
    of the fourth, each in window order.  Raises ValueError for k > 16."""
    _check(bases, offs, k)
    if bases.device.type == "cpu":
        return seed_batch_plain(bases, offs, k, c, marker_c)
    dev = bases.device
    if dev.type != "cuda":
        raise RuntimeError("seed_batch: tensors must lie on a CUDA device "
                           "or on the CPU")
    if not (bases.is_contiguous() and offs.is_contiguous()):
        raise ValueError("seed_batch: expected contiguous tensors")
    B = offs.numel() - 1
    blk = block_starts(offs)
    nb = int(blk[-1])
    if nb == 0:
        z = torch.zeros(B + 1, dtype=torch.int64, device=dev)
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.int64, device=dev), z, z.clone())
    if nb >= 1 << 31:
        raise ValueError(f"seed_batch: {nb} blocks is past the grid")
    blk_start = blk.to(torch.int32)
    thr, thr_m = thresholds(c, marker_c)
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    # the flag words (keep words, then mark words) and the block counts
    words = torch.empty((2, nb * THREADS), dtype=torch.int32, device=dev)
    counts = torch.empty((2, nb), dtype=torch.int32, device=dev)
    _build.check(lib.skt_seed_count(
        bases.data_ptr(), offs.data_ptr(), blk_start.data_ptr(),
        words.data_ptr(), counts.data_ptr(), B, nb, k, thr, thr_m, stream),
        "seed_count")
    # exclusive scans: each block's first output slot, then the totals
    scan = torch.zeros((2, nb + 1), dtype=torch.int64, device=dev)
    scan[:, 1:] = torch.cumsum(counts, 1)
    n_keep, n_mark = scan[:, nb].tolist()
    kmers = torch.empty(n_keep, dtype=torch.int32, device=dev)
    pos = torch.empty(n_keep, dtype=torch.int32, device=dev)
    canon = torch.empty(n_keep, dtype=torch.bool, device=dev)
    markers = torch.empty(n_mark, dtype=torch.int64, device=dev)
    keep_off = scan[0].contiguous()
    mark_off = scan[1].contiguous()
    _build.check(lib.skt_seed_write(
        bases.data_ptr(), offs.data_ptr(), blk_start.data_ptr(),
        words.data_ptr(), keep_off.data_ptr(), mark_off.data_ptr(),
        kmers.data_ptr(), pos.data_ptr(), canon.data_ptr(),
        markers.data_ptr(), B, nb, k, stream), "seed_write")
    _build.count(LAUNCHES, "fmh_seeds")
    return kmers, pos, canon, markers, keep_off[blk], mark_off[blk]


def _host(out):
    """seed_batch's tensors as numpy: (kmers u32, positions u32, canonical
    bool, markers u64, seed_offs int64, marker_offs int64)."""
    kmers, pos, canon, markers, so, mo = (x.cpu().numpy() for x in out)
    return (kmers.view(np.uint32), pos.view(np.uint32), canon,
            markers.view(np.uint64), so, mo)


def _split(out, n: int):
    """seed_batch's tensors -> per contig (kmers u32, positions u32,
    canonical bool, markers u64), as numpy."""
    kmers, pos, canon, markers, so, mo = _host(out)
    return [(kmers[so[b]:so[b + 1]], pos[so[b]:so[b + 1]],
             canon[so[b]:so[b + 1]], markers[mo[b]:mo[b + 1]])
            for b in range(n)]


def _flat(seqs: Sequence[np.ndarray]):
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    bases = np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs]) \
        if len(seqs) else np.zeros(0, np.uint8)
    return bases, offs


def _seed_on(seqs: Sequence[np.ndarray], params, device):
    """seed_batch of `seqs` on `device` (None for no contigs)."""
    from .device_pipeline import resolve_device
    if params.k > 16:
        raise ValueError("Value of k > 16 for DNA; not allowed.")
    dev = resolve_device(device)
    if not len(seqs):
        return None
    bases, offs = _flat(seqs)
    return seed_batch(torch.from_numpy(bases).to(dev),
                      torch.from_numpy(offs).to(dev), params.k, params.c,
                      params.marker_c)


def fmh_seeds_device_batch(seqs: Sequence[np.ndarray], params,
                           device=None) -> List[tuple]:
    """Seeds of many contigs in one kernel pair on `device` (default CUDA;
    RuntimeError without it; "cpu" runs the plain version): per contig,
    what sketch.fmh_seeds_np returns (seed kmers u32, positions u32,
    canonical bool, markers u64 in window order, not deduplicated)."""
    out = _seed_on(seqs, params, device)
    return [] if out is None else _split(out, len(seqs))


def fmh_seeds_device_flat(seqs: Sequence[np.ndarray], params,
                          device=None):
    """fmh_seeds_device_batch's seeds unsplit, as numpy: (kmers u32,
    positions u32, canonical bool, markers u64, seed_offs (B + 1,) int64,
    marker_offs (B + 1,) int64), contig b's seeds at [seed_offs[b],
    seed_offs[b + 1]) and its markers at [marker_offs[b],
    marker_offs[b + 1]) (sketch._device_windows' native pass)."""
    out = _seed_on(seqs, params, device)
    if out is None:
        z = np.zeros(1, dtype=np.int64)
        return (np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                np.zeros(0, bool), np.zeros(0, np.uint64), z, z.copy())
    return _host(out)


def fmh_seeds_device(seq: np.ndarray, params, device=None):
    """One contig through fmh_seeds_device_batch."""
    return fmh_seeds_device_batch([seq], params, device)[0]


def fmh_seeds_plain(seq: np.ndarray, params):
    """The plain version (torch int64 on the CPU) of one contig; the same
    outputs as fmh_seeds_np."""
    if params.k > 16:
        raise ValueError("Value of k > 16 for DNA; not allowed.")
    bases, offs = _flat([seq])
    return _split(seed_batch_plain(torch.from_numpy(bases),
                                   torch.from_numpy(offs), params.k,
                                   params.c, params.marker_c), 1)[0]


class DeviceSeeder:
    """The seeder of sketch.default_seeder's device route: called on one
    contig it seeds that contig on `device`; sketch.fastx_to_sketches
    seeds whole file sets through `batch_flat` (`batch` where the native
    sketch pass is absent)."""

    def __init__(self, device):
        self.device = device

    def __call__(self, seq, params):
        return fmh_seeds_device(seq, params, self.device)

    def batch(self, seqs, params):
        return fmh_seeds_device_batch(seqs, params, self.device)

    def batch_flat(self, seqs, params):
        return fmh_seeds_device_flat(seqs, params, self.device)
