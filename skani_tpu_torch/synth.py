"""Synthetic genome sets from a seed (no fixtures needed).

One random ACGT base genome, optionally with repeats injected (segments
copied to several random places, so the repeat band has k-mers to drop),
then derived genomes mutated at rates spread linearly over a range, the
first few split into contigs.  Used by the tests and by chip_smoke.py.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from .sketch import Sketch, _finalize_sketch, default_seeder

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def base_genome(rng, length: int, n_repeats: int = 0,
                repeat_len: int = 1500, copies=(2, 30)) -> np.ndarray:
    """Random ACGT sequence with repeated segments of `repeat_len` bases:
    `n_repeats` segments each copied to between copies[0] and copies[1]
    random places, or — when `copies` is a list longer than two — one
    segment per entry, copied that many times."""
    s = BASES[rng.integers(0, 4, size=length)]
    counts = (list(copies) if len(copies) > 2 else
              [int(rng.integers(copies[0], copies[1] + 1))
               for _ in range(n_repeats)])
    for n_copies in counts:
        src = int(rng.integers(0, length - repeat_len))
        seg = s[src:src + repeat_len].copy()
        for _ in range(n_copies):
            dst = int(rng.integers(0, length - repeat_len))
            s[dst:dst + repeat_len] = seg
    return s


def mutate(rng, s: np.ndarray, rate: float) -> np.ndarray:
    """A copy of `s` with round(len * rate) random positions redrawn."""
    out = s.copy()
    n = int(len(s) * rate)
    if n:
        pos = rng.choice(len(s), size=n, replace=False)
        out[pos] = BASES[rng.integers(0, 4, size=n)]
    return out


def split_contigs(rng, s: np.ndarray, n: int,
                  min_len: int = 1000) -> List[np.ndarray]:
    """`s` cut into n contigs of at least `min_len` bases."""
    if n <= 1:
        return [s]
    cuts = np.sort(rng.choice(np.arange(min_len, len(s) - min_len),
                              size=n - 1, replace=False))
    parts = np.split(s, cuts)
    return [p for p in parts if len(p) >= min_len] or [s]


def genome_set(seed: int, n_genomes: int, length: int, n_repeats: int = 0,
               rates=(0.003, 0.03), n_split: int = 0,
               contigs=(2, 8), copies=(2, 30),
               min_len: int = 1000) -> List[List[np.ndarray]]:
    """n_genomes genomes (each a list of contig sequences) derived from one
    base: genome i is mutated at rates[0] + (rates[1] - rates[0]) * i /
    (n - 1), and genomes 0..n_split-1 are split into contigs[0]..contigs[1]
    contigs of at least `min_len` bases (shorter pieces are dropped).
    contigs=(80, 300) gives fragmented draft assemblies, which leave the
    packed position word (more than 64 contigs).  `n_repeats` and `copies`
    shape the base's repeats (see base_genome)."""
    rng = np.random.default_rng(seed)
    base = base_genome(rng, length, n_repeats, copies=copies)
    out = []
    for i in range(n_genomes):
        rate = rates[0] + (rates[1] - rates[0]) * i / max(n_genomes - 1, 1)
        g = mutate(rng, base, rate)
        n = int(rng.integers(contigs[0], contigs[1] + 1)) if i < n_split \
            else 1
        out.append(split_contigs(rng, g, n, min_len))
    return out


def write_fasta(path: str, name: str, parts: Sequence[np.ndarray]) -> str:
    with open(path, "wb") as f:
        for j, s in enumerate(parts):
            f.write(b">%s_c%d\n" % (name.encode(), j))
            f.write(np.asarray(s, np.uint8).tobytes() + b"\n")
    return path


def write_genome_set(dirname: str, genomes, prefix: str = "g") -> List[str]:
    os.makedirs(dirname, exist_ok=True)
    return [write_fasta(os.path.join(dirname, f"{prefix}{i:02d}.fa"),
                        f"{prefix}{i:02d}", parts)
            for i, parts in enumerate(genomes)]


def sketch_parts(parts: Sequence[np.ndarray], sp, name: str,
                 seeder=None) -> Sketch:
    """A Sketch of in-memory contigs (as sketch_file would build it)."""
    seeder = seeder or default_seeder(sp)
    sk = Sketch(file_name=name, marker_c=sp.c, c=sp.c, k=sp.k)
    kms, pos, cas, ctg, mas = [], [], [], [], []
    j = 0
    for s in parts:
        if len(s) < 500:
            continue
        sk.contigs.append(f"{name}_c{j}")
        sk.contig_lengths = np.append(sk.contig_lengths, np.uint32(len(s)))
        sk.total_sequence_length += len(s)
        km, po, ca, ma = seeder(s, sp)
        if len(km):
            kms.append(km)
            pos.append(po)
            cas.append(ca)
            ctg.append(np.full(len(km), j, np.uint32))
        if len(ma):
            mas.append(ma)
        j += 1
    _finalize_sketch(sk, kms, pos, cas, ctg, mas)
    return sk


# --- kernel inputs ---

def adversarial_words(rng, shape) -> np.ndarray:
    """int32 words over the full range, led by sign-boundary, all-ones and
    byte-plane edge patterns."""
    w = rng.integers(-2 ** 31, 2 ** 31, size=shape, dtype=np.int64)
    w = w.astype(np.int32)
    flat = w.reshape(-1)
    flat[:10] = np.array([0, -1, 1, 2 ** 31 - 1, -2 ** 31, 0x7F7F7F7F,
                          -0x7F7F7F80, 255, 256, 0x00FF00FF], np.int32)
    return w


def windowed_case(rng, R, U, A, WB):
    """(table, idx) for the windowed gather: int32 (R, U) adversarial words
    and per-row nondecreasing (R, A) indices.  Row 0 fits one window per
    tile, row 1 sits at the table's end (the window placement clamps), row
    2 spans the whole table in its first tile (overflow when the table is
    wider than the window, zeros outside it) and stays at the table's end
    after it, row 3 overflows in its last tile only, row 4 has negative and
    past-the-end indices; the rest are random spans that fit a window."""
    table = adversarial_words(rng, (R, U))
    span = (WB - 1) * 128
    idx = np.zeros((R, A), np.int64)
    for r in range(R):
        base = int(rng.integers(0, U - span + 1))
        idx[r] = np.sort(rng.integers(base, base + span, A))
    idx[1] = np.sort(rng.integers(U - 100, U, A))
    idx[2, :1024] = np.sort(rng.integers(0, U, 1024))
    idx[2, 1024:] = U - 1
    idx[3, :-1024] = np.sort(rng.integers(0, span, A - 1024))
    idx[3, -1024:] = np.sort(rng.integers(span, U, 1024))
    idx[4, :3] = [-300, -1, 0]
    idx[4, -2:] = [U, U + 200]
    idx[4] = np.sort(idx[4])
    return table, idx.astype(np.int32)


def unique_targets(rng, R, P, K, drop_frac=0.25) -> np.ndarray:
    """Per-row unique targets in [0, K) for most sources, plus dropped
    ones (>= K, and negative)."""
    span = int(K / (1.0 - drop_frac)) + 1
    span = max(span, P + 16)
    idx = np.stack([rng.permutation(span)[:P] for _ in range(R)])
    idx = idx.astype(np.int32)
    idx[:, :8] = -np.arange(1, 9, dtype=np.int32)
    return idx


def _dp_fields(rng, R, A, l_cap):
    """Anchor streams with chunk structure as int64 (R, A) fields: cid, qp,
    rev, rc, rp, col_in_chunk and valid.  Random chunk lengths (1-anchor
    cascade runs up to l_cap - 1), so chunks cross segment boundaries; both
    orientations; an invalid tail whose col_in_chunk continues the last
    chunk's count, as phase A's does."""
    f = {k: np.zeros((R, A), np.int64)
         for k in ("cid", "qp", "rev", "rc", "rp", "colc", "valid")}
    for r in range(R):
        total = int(rng.integers(A // 2, A))
        lens = np.where(rng.random(A) < 0.6,
                        rng.choice([1, 1, 2, 5], size=A),
                        rng.integers(1, l_cap, size=A))
        cum = np.cumsum(lens)
        n = int(np.searchsorted(cum, total)) + 1
        lens = lens[:n].copy()
        lens[-1] -= int(cum[n - 1]) - total
        starts = np.cumsum(lens) - lens
        i_in = np.arange(total) - np.repeat(starts, lens)
        f["cid"][r, :total] = np.repeat(np.arange(n), lens)
        f["qp"][r, :total] = np.cumsum(rng.integers(1, 40, size=total)) \
            + int(rng.integers(0, 1000))
        f["rev"][r, :total] = rng.integers(0, 2, size=total)
        f["rc"][r, :total] = np.repeat(rng.integers(0, 3, size=n), lens)
        rp0 = np.repeat(rng.integers(0, 24000, size=n), lens)
        f["rp"][r, :total] = np.clip(
            rp0 + i_in * rng.integers(1, 30, size=total)
            + rng.integers(-20, 20, size=total), 0, (1 << 24) - 1)
        f["valid"][r, :total] = 1
        f["colc"][r, :total] = i_in
        f["colc"][r, total:] = np.arange(total, A) - starts[-1]
    return f


def _edge_rows(rng, f, A, l_cap):
    """Row 0 without a valid anchor (its col_in_chunk counts from 0, as
    phase A leaves a row without chunks) and row 1 the segment layout's
    edge cases (_edge_row); A >= 8192."""
    S = 2048
    while S < l_cap:
        S *= 2
    for k in f:
        f[k][0] = 0
    f["colc"][0] = np.arange(A)
    _edge_row(rng, f, 1, A, l_cap, min(S, A))


def dp_stream(rng, R, A, l_cap, edges: bool = False):
    """2-plane compact DP inputs (w1, w2, col_in_chunk), int32 (R, A): w1 =
    cid mod 32 << 26 | qp << 2 | rev << 1 | valid, w2 = rc << 25 | rp (see
    _dp_fields for the stream's structure).  With `edges`, rows 0 and 1
    hold the edge cases of _edge_rows."""
    f = _dp_fields(rng, R, A, l_cap)
    if edges:
        _edge_rows(rng, f, A, l_cap)
    v = f["valid"]
    w1 = v * (((f["cid"] & 31) << 26) | (f["qp"] << 2) | (f["rev"] << 1) | 1)
    w2 = v * ((f["rc"] << 25) | f["rp"])
    return [x.astype(np.int32) for x in (w1, w2, f["colc"])]


def _edge_row(rng, f, r, A, l_cap, S):
    """Row r of _dp_fields rewritten with the segment layout's edge cases:
    a chunk longer than S that starts just before a segment boundary and
    ends past the next one, a chunk longer than l_cap, both at small steps
    in a narrow position range (equal-score candidates), then short
    chunks and phase A's padding tail."""
    lens = [S - 300, S + 700, l_cap + 40]
    while sum(lens) < (3 * A) // 4:
        lens.append(int(rng.integers(1, 60)))
    lens = np.array(lens)
    lens[-1] -= int(lens.sum()) - (3 * A) // 4
    total = int(lens.sum())
    starts = np.cumsum(lens) - lens
    i_in = np.arange(total) - np.repeat(starts, lens)
    n = len(lens)
    steps = rng.integers(0, 4, size=total) * rng.choice([1, 1, 7], total)
    for k in f:
        f[k][r] = 0
    f["cid"][r, :total] = np.repeat(np.arange(n), lens)
    f["qp"][r, :total] = np.cumsum(steps) + 50
    f["rev"][r, :total] = np.repeat(rng.integers(0, 2, size=n), lens)
    f["rc"][r, :total] = np.repeat(rng.integers(0, 2, size=n), lens)
    f["rp"][r, :total] = np.clip(30000 + np.where(
        f["rev"][r, :total] == 1, -1, 1) * np.cumsum(steps)
        + rng.integers(-2, 3, size=total), 0, (1 << 24) - 1)
    f["valid"][r, :total] = 1
    f["colc"][r, :total] = i_in
    f["colc"][r, total:] = np.arange(total, A) - starts[-1]


def dp_stream_wide(rng, R, A, l_cap, tag: bool = False,
                   edges: bool = False):
    """3-plane compact DP inputs (w1, w2, w3, col_in_chunk), int32 (R, A):
    w1 = qp << 2 | rev << 1 | valid, w2 = rp, and w3 = cid * 64 + rc (the
    full chunk id) or, with `tag`, cid mod 32 << 26 | rc; w3 is -1 on
    invalid columns.  With `edges`, rows 0 and 1 hold the edge cases of
    _edge_rows."""
    f = _dp_fields(rng, R, A, l_cap)
    if edges:
        _edge_rows(rng, f, A, l_cap)
    v = f["valid"]
    w1 = v * ((f["qp"] << 2) | (f["rev"] << 1) | 1)
    w2 = v * f["rp"]
    w3 = ((f["cid"] & 31) << 26) | f["rc"] if tag \
        else f["cid"] * 64 + f["rc"]
    w3 = np.where(v == 1, w3, -1)
    return [x.astype(np.int32) for x in (w1, w2, w3, f["colc"])]


def padded_dp_case(rng, L, RC, n_contigs=3, packed=False):
    """Padded-DP inputs, int32 (L, RC): (qp, rp, rcv) with I32MAX position
    padding and rcv = contig*4 + reverse*2 + valid, or with `packed` the
    two words (qp<<2 | rev<<1 | valid, rc<<25 | rp) with zero padding.
    Lane 0 holds no valid anchor, lane 1 a full colinear run at a constant
    step (every candidate ties on the gap), lane 2 random validity holes;
    the others hold a valid prefix of random length whose ref contig and
    orientation change along the lane (cross-contig neighbours inside the
    band), small position steps (tied candidate scores) and a few
    duplicated ref positions."""
    qp = np.zeros((L, RC), np.int64)
    rp = np.zeros((L, RC), np.int64)
    rc = np.zeros((L, RC), np.int64)
    rev = np.zeros((L, RC), np.int64)
    val = np.zeros((L, RC), np.int64)
    for lane in range(RC):
        n = L if lane in (1, 2) else int(rng.integers(0, L + 1))
        if lane == 0:
            n = 0
        steps = rng.integers(0, 6, size=L) * rng.choice([1, 1, 7, 40],
                                                        size=L)
        q = np.cumsum(steps) + int(rng.integers(0, 5000))
        run = np.cumsum(rng.random(L) < 0.04)          # contig/strand runs
        c = rng.integers(0, n_contigs, size=L + 1)[run]
        o = rng.integers(0, 2, size=L + 1)[run]
        r = 30000 + np.where(o == 1, -q, q) + rng.integers(-3, 4, size=L)
        if lane == 1:
            q = 100 * np.arange(L) + 7
            r, c, o = q + 1000, np.zeros(L, np.int64), np.zeros(L, np.int64)
        dup = rng.random(L) < 0.03
        r[1:][dup[1:]] = r[:-1][dup[1:]]               # rp_i == rp_j
        qp[:, lane], rp[:, lane], rc[:, lane], rev[:, lane] = q, r, c, o
        val[:n, lane] = 1
        if lane == 2:
            val[:, lane] = rng.random(L) < 0.85
    rp = np.clip(rp, 0, (1 << 24) - 1)
    if packed:
        qprv = val * (qp * 4 + rev * 2 + 1)
        rprc = val * ((rc << 25) | rp)
        return qprv.astype(np.int32), rprc.astype(np.int32)
    i32max = 2 ** 31 - 1
    return (np.where(val == 1, qp, i32max).astype(np.int32),
            np.where(val == 1, rp, i32max).astype(np.int32),
            (val * (rc * 4 + rev * 2 + 1)).astype(np.int32))


def expand_case(rng, R, P, A):
    """(offs, bs, apk, total) for expand_anchors, int32: offs (R, P) the
    exclusive prefix sum of per-position counts, bs < 2^17, apk full-range
    words, total (R,).  Row 0 emits nothing (total 0), row 1 fills the
    buffer exactly (total == A), row 2 emits one anchor every 37 positions
    (its tiles span more than the 2048-position window: overflow), row 3
    emits more than A; the rest draw counts from mixed densities with an
    empty tail."""
    cnt = np.zeros((R, P), np.int64)
    for r in range(R):
        dens = [[0, 0, 1, 1, 1, 1, 2, 3], [0, 1], [0, 0, 0, 1, 2]][r % 3]
        n_pos = int(rng.integers(P // 2, P))
        cnt[r, :n_pos] = rng.choice(dens, size=n_pos)
    cnt[0] = 0
    cnt[1] = 0
    cnt[1, :A // 2] = 2
    cnt[2] = 0
    cnt[2, ::37] = 1
    cnt[3] = 3
    offs = np.cumsum(cnt, axis=1) - cnt
    total = offs[:, -1] + cnt[:, -1]
    bs = rng.integers(0, 1 << 17, size=(R, P))
    return (offs.astype(np.int32), bs.astype(np.int32),
            adversarial_words(rng, (R, P)), total.astype(np.int32))
