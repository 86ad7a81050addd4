"""FracMinHash sketches for the reference, in plain PyTorch.

The same semantics as skani's scalar sketcher (reference:
src/seeding.rs:225-323), written with torch int64 operations so that it
runs on the card after the window (and on the CPU in the tests): the seed
k-mer is the low 2k bits of the rolling 21-mer window and of its reverse
complement, the canonical one the smaller; a seed is kept where
mm_hash64(seed) < u64::MAX / c, and the canonical 21-mer is a marker where
the same hash is also < u64::MAX / marker_c; positions within k after an
N (at index >= 20) are skipped.  uint64 values live in int64 bit patterns:
shifts to the right mask the sign, and unsigned comparisons flip it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from .params import (ASCII_N, ASCII_N_SMALL, K_MARKER_DNA,
                     MIN_LENGTH_CONTIG)

_SIGN = -(1 << 63)


@dataclasses.dataclass
class RefSketch:
    """A genome sketch in the layout the copied chain code reads: seeds
    CSR over sorted unique k-mers, markers sorted unique."""
    file_name: str = ""
    contigs: List[str] = dataclasses.field(default_factory=list)
    contig_lengths: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    total_sequence_length: int = 0
    seed_kmers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    seed_starts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.int64))
    seed_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    seed_contig: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint32))
    seed_canon: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, bool))
    marker_seeds: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.uint64))
    marker_c: int = 0
    c: int = 0
    k: int = 0
    amino_acid: bool = False

    @property
    def seed_counts(self) -> np.ndarray:
        return np.diff(self.seed_starts)


#: the fields that two sketches of one genome must hold equal
FIELDS = ("contigs", "contig_lengths", "total_sequence_length",
          "seed_kmers", "seed_starts", "seed_pos", "seed_contig",
          "seed_canon", "marker_seeds", "c", "k")


def _code_table(device) -> torch.Tensor:
    t = torch.zeros(256, dtype=torch.int64)
    for b, v in ((67, 1), (71, 2), (84, 3), (85, 3),
                 (99, 1), (103, 2), (116, 3), (117, 3)):
        t[b] = v
    return t.to(device)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of uint64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def mm_hash64(key: torch.Tensor) -> torch.Tensor:
    """Thomas Wang's 64-bit mix (reference: src/types.rs:86-96) on uint64
    bits held in int64; additions and left shifts wrap."""
    key = ~(key + (key << 21))
    key = key ^ _shr(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ _shr(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ _shr(key, 28)
    key = key + (key << 31)
    return key


def _as_signed(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def seeds_of_contigs(contigs: Sequence[np.ndarray], k: int, c: int,
                     marker_c: int, device):
    """(seed k-mers u32, positions u32, canonical bool, contig index u32,
    markers u64) of every contig, in scan order contig by contig; one
    pass over the contigs laid end to end, where a window that crosses a
    contig's end is no window.  Markers not deduplicated."""
    mk = K_MARKER_DNA
    empty = (np.zeros(0, np.uint32), np.zeros(0, np.uint32),
             np.zeros(0, bool), np.zeros(0, np.uint32),
             np.zeros(0, np.uint64))
    use = [j for j, q in enumerate(contigs) if len(q) >= 2 * mk]
    if not use:
        return empty
    lens = np.array([len(contigs[j]) for j in use], np.int64)
    s = torch.from_numpy(np.concatenate(
        [np.asarray(contigs[j], np.uint8) for j in use])).to(device)
    L = len(s)
    codes = _code_table(device)[s.long()]
    nw = L - mk + 1
    F = torch.zeros(nw, dtype=torch.int64, device=device)
    R = torch.zeros(nw, dtype=torch.int64, device=device)
    for t in range(mk):
        F |= codes[t:t + nw] << (2 * (mk - 1 - t))
        R |= (3 - codes[t:t + nw]) << (2 * t)
    mask = (1 << (2 * k)) - 1
    fs, rs = F & mask, R & mask
    canon = fs < rs
    kmer = torch.where(canon, fs, rs)
    h = mm_hash64(kmer) ^ _SIGN
    thr = _as_signed((2 ** 64 - 1) // c) ^ _SIGN
    thr_m = _as_signed((2 ** 64 - 1) // marker_c) ^ _SIGN
    # each window's end, its contig and its place in the contig
    i_idx = torch.arange(mk - 1, L, device=device)
    starts = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]])
                              ).to(device)
    ctg = torch.searchsorted(starts, i_idx, right=True) - 1
    local = i_idx - starts[ctg]
    inside = local >= mk - 1
    tail = s[mk - 1:]
    # an N counts from index mk - 1 of its contig on; one in an earlier
    # contig lies over k behind every window of this one
    is_n = ((tail == ASCII_N) | (tail == ASCII_N_SMALL)) & inside
    last_n = torch.where(is_n, i_idx, torch.full_like(i_idx, -(1 << 40)))
    last_n = torch.cummax(last_n, 0).values
    keep = (h < thr) & (last_n + k <= i_idx) & inside
    keep_m = keep & (h < thr_m)
    marker = torch.where(F < R, F, R)
    contig_of = torch.tensor(use, dtype=torch.int64, device=device)
    return (kmer[keep].cpu().numpy().astype(np.uint32),
            local[keep].cpu().numpy().astype(np.uint32),
            canon[keep].cpu().numpy(),
            contig_of[ctg[keep]].cpu().numpy().astype(np.uint32),
            marker[keep_m].cpu().numpy().view(np.uint64))


def sketch_contigs(file_name: str, contig_names: Sequence[str],
                   contigs: Sequence[np.ndarray], k: int, c: int,
                   marker_c: int, device) -> RefSketch:
    """A genome's sketch from its contigs (those under MIN_LENGTH_CONTIG
    left out, as skani reads a file), seeds stably sorted by k-mer."""
    sk = RefSketch(file_name=file_name, marker_c=c, c=c, k=k)
    kept = [(n, q) for n, q in zip(contig_names, contigs)
            if len(q) >= MIN_LENGTH_CONTIG]
    sk.contigs = [n for n, _q in kept]
    sk.contig_lengths = np.asarray([len(q) for _n, q in kept], np.uint32)
    sk.total_sequence_length = int(sum(len(q) for _n, q in kept))
    kmers, pos, cas, ctg, mas = seeds_of_contigs(
        [q for _n, q in kept], k, c, marker_c, device)
    if len(kmers):
        order = np.argsort(kmers, kind="stable")
        kmers = kmers[order]
        sk.seed_pos = pos[order]
        sk.seed_canon = cas[order]
        sk.seed_contig = ctg[order]
        uniq, starts = np.unique(kmers, return_index=True)
        sk.seed_kmers = uniq
        sk.seed_starts = np.append(starts, len(kmers)).astype(np.int64)
    if len(mas):
        sk.marker_seeds = np.unique(mas)
    return sk


def same_sketch(a, b) -> bool:
    """Whether two sketches of one genome agree in every field of FIELDS
    (a program's Sketch against a RefSketch)."""
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                return False
        elif x != y:
            return False
    return True
