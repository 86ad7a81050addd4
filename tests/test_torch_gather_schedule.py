"""The schedules of the Hopper kernels for the unique-target scatter (K2,
K6, K7: csrc/gather.cu row_scatter_kernel) and for genome_map_gather (K5:
row_gather_kernel with the index-row map, and genome_map_gather_kernel),
emulated block by block in numpy on the CPU and held bit for bit against
the plain versions and the JAX package's kernels (Pallas in interpret
mode).

The scatter emulation follows skt_row_scatter_multi:

  * the tiles: at least as many a row as its V planes need to fit a
    block's shared memory, else sms // R (at least 1), each T words, T a
    multiple of 4; tile x of row r owns words [x * T, x * T + T) of all V
    planes, the last tile the ragged rest;
  * a block zeroes its tile, reads the row's targets a unit at a time
    (4 words where P % 4 == 0, else 1) in rounds of 4 units a thread,
    loads the payloads of every unit with a target inside the tile, writes
    those words (unsigned rel = target - t0 < n: one compare drops both
    sides), and stores its tile once;
  * every output word is stored by exactly one block, and no tile word is
    written twice (unique targets: no atomics).

The K5 emulation follows skt_genome_map_gather: the row-affine launch,
sms // R blocks of 1024 threads a row, each a balanced span of the row
started on a 32-word line, with 4 positions a thread in flight a round,
where R <= sms, the R jw rows take at most 3/5 of the L2 and either a row
fits ROW_SMEM_WORDS or the grid keeps nine tenths of the SMs busy; else
one thread a position in blocks of 256.  Index row a_idx[r] of skid
(clamped into [0, G)), table row r of jw, skid values clamped into
[0, K).

The emulated card's SM count, shared memory and L2 are parameters, so
the tile, span and launch rules are exercised at small shapes.  Where a
shape lies outside the TPU kernel's domain (K not a multiple of 128, P
not a multiple of its chunk) the JAX kernel runs on the input padded:
padding targets and positions that drop or are sliced off.  Genome ids
and skid values out of range lie outside the JAX kernel's domain: there
the emulation and the plain version are held against the port's
contract written out by hand (ids and values clamped), and against the
JAX kernel only on the rows and positions inside its domain.
Tolerance: exact (int32 words).
"""
import numpy as np
import pytest
import torch

from skani_tpu.kernels.gather_pallas import (
    genome_map_gather as jax_genome_map_gather, mxu_row_scatter,
    mxu_row_scatter_multi, mxu_row_scatter_multi_wide)
from skani_tpu_torch.kernels import gather
from torch_gather_cases import gmap_inputs, scatter_inputs

torch.set_num_threads(1)

H100_SMS = 132
H100_L2 = 50 << 20       # L2 bytes
SMEM_BYTES = 232448      # a block's dynamic shared memory (227 KB)
ROW_SMEM_WORDS = gather.ROW_SMEM_WORDS
UNROLL = 4               # units a thread in flight, scatter and K5
ROW_THREADS = 1024       # a block of K5's launch
I32 = np.int32


def _cdiv(a, b):
    return -(-a // b)


def _rounds(lo, hi, nt, per):
    """Every word a block of `nt` threads visits, in rounds of `per` a
    thread from lo: thread t, round i, slot k -> lo + t + (i * per + k) *
    nt, kept below hi."""
    if hi <= lo:
        return np.zeros(0, np.int64)
    n_rounds = _cdiv(hi - lo, per * nt)
    w = (lo + np.arange(nt)[:, None, None]
         + (np.arange(n_rounds)[None, :, None] * per
            + np.arange(per)[None, None, :]) * nt)
    return w[w < hi]


def scatter_tiles(R, V, K, sms=H100_SMS, smem_bytes=SMEM_BYTES):
    """(tiles a row, words a tile) as csrc/gather.cu scatter() picks them."""
    kmax = (smem_bytes // 4 // V) & ~3
    nt = max(_cdiv(K, kmax), max(1, sms // R))
    T = min((_cdiv(K, nt) + 3) & ~3, kmax)
    return _cdiv(K, T), T


def emulate_scatter(idx, vals, K, sms=H100_SMS, smem_bytes=SMEM_BYTES):
    R, V, P = vals.shape
    nt, T = scatter_tiles(R, V, K, sms, smem_bytes)
    assert T % 4 == 0 and V * T * 4 <= smem_bytes
    W = 4 if P % 4 == 0 else 1
    units = P // W
    threads = 1024 if V == 1 else 512
    order = _rounds(0, units, threads, UNROLL)
    assert np.array_equal(np.sort(order), np.arange(units))
    out = np.full((R, V, K), 0x5A5A5A5A, I32)     # every word is stored
    stores = np.zeros((R, K), np.int64)
    for r in range(R):
        iu = idx[r].astype(np.int64).reshape(units, W)[order]
        pv = vals[r].reshape(V, units, W)[:, order]
        for x in range(nt):
            t0 = x * T
            n = min(T, K - t0)
            assert n > 0
            tile = np.zeros((V, T), I32)
            rel = (iu - t0) & 0xFFFFFFFF          # unsigned wrap
            inside = rel < n
            hit = inside.any(axis=1)              # units whose payloads load
            sel = inside[hit]
            tgt = rel[hit][sel]
            assert np.unique(tgt).size == tgt.size
            tile[:, tgt] = pv[:, hit][:, sel]
            out[r, :, t0:t0 + n] = tile[:, :n]
            stores[r, t0:t0 + n] += 1
    assert (stores == 1).all()
    return out


def genome_map_launch(R, K, sms=H100_SMS, l2=H100_L2,
                      row_words=ROW_SMEM_WORDS):
    """Blocks a row of the row-affine launch, or 0 where the launch takes
    one thread a position, as csrc/gather.cu genome_map() picks: the
    row-affine launch where R <= sms, the R jw rows take at most 3/5 of
    the L2, and either a row fits row_words or the grid keeps nine tenths
    of the SMs busy."""
    nb = sms // R
    if nb < 1 or 5 * 4 * R * K > 3 * l2:
        return 0
    return nb if K <= row_words or 10 * nb * R >= 9 * sms else 0


def emulate_genome_map(skid, a_idx, jw, sms=H100_SMS, l2=H100_L2,
                       row_words=ROW_SMEM_WORDS):
    G, P = skid.shape
    R, K = jw.shape
    nb = genome_map_launch(R, K, sms, l2, row_words)
    out = np.full((R, P), 0x5A5A5A5A, I32)
    stores = np.zeros((R, P), np.int64)
    for r in range(R):
        irow = skid[min(max(int(a_idx[r]), 0), G - 1)]
        if nb:                  # row-affine: nb spans of the row, each
            # started on a 32-word line (the last ends at P)
            ends = [P * b // nb & ~31 for b in range(nb)] + [P]
            ws = [_rounds(lo, hi, ROW_THREADS, UNROLL)
                  for lo, hi in zip(ends, ends[1:])]
        else:                   # one thread a position, blocks of 256
            ws = [np.arange(b, min(b + 256, P)) for b in range(0, P, 256)]
        for w in ws:
            out[r, w] = jw[r, np.clip(irow[w], 0, K - 1)]
            stores[r, w] += 1
    assert (stores == 1).all()
    return out


def _jax_scatter(idx, vals, K):
    """The TPU kernel of this payload count on the input padded into its
    domain: K up to a multiple of 128 (targets in [K, K') redirected to
    -1, which drops), P up to a multiple of 4096 (padding targets -1)."""
    R, V, P = vals.shape
    K2, P2 = _cdiv(K, 128) * 128, _cdiv(P, 4096) * 4096
    ji = np.full((R, P2), -1, I32)
    ji[:, :P] = np.where((idx >= 0) & (idx < K), idx, -1)
    jv = np.zeros((R, V, P2), I32)
    jv[:, :, :P] = vals
    if V == 1:
        out = np.asarray(mxu_row_scatter(ji, jv[:, 0], K2, interpret=True))
        return out[:, None, :K]
    kern = mxu_row_scatter_multi_wide if V == 2 else mxu_row_scatter_multi
    return np.asarray(kern(ji, jv, K2, interpret=True))[:, :, :K]


def _jax_genome_map(skid, a_idx, jw):
    """The TPU kernel on an input inside its domain (genome ids in [0, G),
    skid values in [0, K)), P padded to a multiple of 4096 (positions
    sliced off) and K to a multiple of 128 (columns never read)."""
    G, P = skid.shape
    R, K = jw.shape
    assert ((a_idx >= 0) & (a_idx < G)).all()
    assert ((skid >= 0) & (skid < K)).all()
    P2, K2 = _cdiv(P, 4096) * 4096, _cdiv(K, 128) * 128
    sk = np.zeros((G, P2), I32)
    sk[:, :P] = skid
    j2 = np.zeros((R, K2), I32)
    j2[:, :K] = jw
    return np.asarray(jax_genome_map_gather(sk, a_idx.astype(I32), j2,
                                            interpret=True))[:, :P]


# (name, kernel, kind, shape, emulated card: for the scatter sms and
# shared memory bytes, for the genome map sms, L2 bytes and the widest
# row that counts as fitting)
_CASES = [
    ("scatter_ascending_v2", "scatter", "ascending", (4, 2, 4096, 4480),
     (H100_SMS, SMEM_BYTES)),
    ("scatter_ascending_v1", "scatter", "ascending", (3, 1, 4096, 5003),
     (8, SMEM_BYTES)),
    ("scatter_random_v1", "scatter", "random", (8, 1, 2048, 3000),
     (H100_SMS, SMEM_BYTES)),
    ("scatter_random_v2", "scatter", "random", (5, 2, 4096, 4096),
     (16, SMEM_BYTES)),
    ("scatter_dropped_v2", "scatter", "dropped", (8, 2, 2048, 256),
     (H100_SMS, SMEM_BYTES)),
    ("scatter_dropped_v3", "scatter", "dropped", (6, 3, 2048, 384),
     (H100_SMS, SMEM_BYTES)),
    # K not a multiple of 4 nor of the tile; P % 4 != 0 (scalar units)
    ("scatter_ragged_v2", "scatter", "dropped", (5, 2, 2050, 1001),
     (H100_SMS, SMEM_BYTES)),
    ("scatter_ragged_v3", "scatter", "random", (3, 3, 999, 1001),
     (7, SMEM_BYTES)),
    # more rows than tiles (one tile a row) and the shared-memory fit
    # rule (tiles forced by the V planes' size, not by the SMs)
    ("scatter_rows_gt_tiles_v1", "scatter", "dropped", (40, 1, 2048, 640),
     (8, SMEM_BYTES)),
    ("scatter_fit_rule_v3", "scatter", "ascending", (3, 3, 4096, 3000),
     (4, 4 * 3 * 400)),
    # row-affine: spans of P / nb words rounded to 32-word lines
    ("gmap_unsorted", "gmap", "unsorted", (5, 9, 4096, 256),
     (H100_SMS, H100_L2, ROW_SMEM_WORDS)),
    ("gmap_all_equal", "gmap", "all_equal", (4, 6, 4096, 384),
     (16, H100_L2, ROW_SMEM_WORDS)),
    ("gmap_out_of_range", "gmap", "out_of_range", (5, 7, 4096, 300),
     (H100_SMS, H100_L2, ROW_SMEM_WORDS)),
    # more rows than SMs (one thread a position); P % 4 != 0,
    # K % 128 != 0
    ("gmap_rows_gt_sms", "gmap", "unsorted", (3, 12, 4099, 1001),
     (8, H100_L2, ROW_SMEM_WORDS)),
    # a wide row: one thread a position where 2 of 16 SMs idle, the
    # row-affine launch where none do (spans of 2049.5 words)
    ("gmap_wide_row_idle_sms", "gmap", "unsorted", (4, 7, 4099, 1001),
     (16, H100_L2, 256)),
    ("gmap_wide_row_busy_sms", "gmap", "unsorted", (4, 8, 4099, 1001),
     (16, H100_L2, 256)),
    # jw rows over 3/5 of the L2: one thread a position
    ("gmap_rows_over_l2", "gmap", "all_equal", (3, 6, 4096, 384),
     (H100_SMS, 8192, ROW_SMEM_WORDS)),
]


@pytest.mark.parametrize("name,kernel,kind,shape,card", _CASES,
                         ids=[c[0] for c in _CASES])
def test_gather_schedule_matches_plain_and_pallas(name, kernel, kind, shape,
                                                  card):
    rng = np.random.default_rng(sum(map(ord, name)))
    if kernel == "scatter":
        sms, smem = card
        R, V, P, K = shape
        idx, vals = scatter_inputs(rng, kind, R, V, P, K)
        got = emulate_scatter(idx, vals, K, sms, smem)
        if V == 1:
            plain = gather.row_scatter(torch.from_numpy(idx),
                                       torch.from_numpy(vals[:, 0].copy()),
                                       K).numpy()[:, None]
        else:
            plain = gather.row_scatter_multi(torch.from_numpy(idx),
                                             torch.from_numpy(vals),
                                             K).numpy()
        want = _jax_scatter(idx, vals, K)
        inside = (idx >= 0) & (idx < K)
        assert inside.any() and (got != 0).any()
        if kind == "ascending":
            assert (idx == K).any()        # the sentinel drops
        if kind == "dropped":
            assert (~inside).any()
    else:
        G, R, P, K = shape
        skid, a, jw = gmap_inputs(rng, kind, G, R, P, K)
        nb = genome_map_launch(R, K, *card)
        assert (nb == 0) == (name in ("gmap_rows_gt_sms",
                                      "gmap_wide_row_idle_sms",
                                      "gmap_rows_over_l2"))
        if name in ("gmap_unsorted", "gmap_wide_row_busy_sms"):
            assert P // nb % 32                 # spans rounded to lines
        got = emulate_genome_map(skid, a, jw, *card)
        plain = gather.genome_map_gather(torch.from_numpy(skid),
                                         torch.from_numpy(a),
                                         torch.from_numpy(jw)).numpy()
        # the port's contract by hand: genome ids clamped into [0, G),
        # skid values into [0, K)
        want = jw[np.arange(R)[:, None],
                  np.clip(skid[np.clip(a, 0, G - 1)], 0, K - 1)]
        # the JAX kernel only where its input lies in its domain: the
        # rows with a genome id in [0, G), the positions whose skid values
        # all lie in [0, K) (the others replaced by 0 and not compared)
        rows = (a >= 0) & (a < G)
        cols = ((skid >= 0) & (skid < K)).all(axis=0)
        assert rows.all() == cols.all() == (kind != "out_of_range")
        jx = _jax_genome_map(np.where((skid >= 0) & (skid < K), skid, 0),
                             a[rows], jw[rows])
        np.testing.assert_array_equal(got[rows][:, cols], jx[:, cols])
        # padding positions read jw[:, 0]
        np.testing.assert_array_equal(got[:, P - P // 8:],
                                      np.repeat(jw[:, :1], P // 8, axis=1))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)


def test_genome_map_launch_at_the_main_path_shapes():
    """The slow (R 32, K 157696) and contigs (R 32, K 38912) batches take
    the row-affine launch; -c 20's R 29 (K 235520, 116 of 132 SMs busy)
    and more rows than SMs take one thread a position; a narrow row takes
    the row-affine launch with idle SMs, and rows over 30 MB never do."""
    assert genome_map_launch(32, 157696) == 4
    assert genome_map_launch(32, 38912) == 4
    assert genome_map_launch(29, 235520) == 0
    assert genome_map_launch(33, 235520) == 4     # 29.6 MB
    assert genome_map_launch(34, 235520) == 0     # 30.5 MB
    assert genome_map_launch(45, 38912) == 2      # 90 of 132 SMs
    assert genome_map_launch(45, 157696) == 0
    assert genome_map_launch(62, 157696) == 0     # 37 MB
    assert genome_map_launch(200, 5000) == 0
    assert genome_map_launch(1, 5000) == 132


def test_scatter_tile_rule_at_the_main_path_shapes():
    """The tiles the card gets at the smoke's batches: the default fused
    fill (R 33, V 2, K 47104) and the contigs single-payload fill (R 32,
    K 49152) give one block an SM; V = 3 and a short batch need the fit
    rule; a row of R > 132 gets one tile."""
    assert scatter_tiles(33, 2, 47104) == (4, 11776)
    assert scatter_tiles(32, 1, 49152) == (4, 12288)
    assert scatter_tiles(33, 3, 47104) == (4, 11776)
    assert scatter_tiles(2, 3, 60000) == (66, 912)
    assert scatter_tiles(1, 1, 200000) == (132, 1516)
    assert scatter_tiles(200, 2, 47104) == (2, 23552)
    for R, V, K in ((33, 2, 47104), (2, 3, 60000), (200, 2, 47104),
                    (7, 1, 1001)):
        nt, T = scatter_tiles(R, V, K)
        assert (nt - 1) * T < K <= nt * T and V * T * 4 <= SMEM_BYTES
