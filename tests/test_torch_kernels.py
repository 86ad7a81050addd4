"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain torch version, so these tests hold
the plain versions bit for bit against the Pallas kernels run in interpret
mode, on the adversarial inputs of tests/test_gather_pallas.py and the
chunked anchor streams of tests/test_dp_compact.py.  The padded DPs are
held against both the lax.scan reference and the Pallas kernels in
interpret mode on the inputs of tests/test_dp_pallas.py, the expansion
kernel against its NumPy oracle and its Pallas kernel on those of
tests/test_expand_pallas.py.  The CUDA kernels are
held against the same plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py).  Tolerance: exact, everywhere (int32 words).
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
from skani_tpu.kernels.dp_pallas import dbits as jax_dbits
from skani_tpu.kernels.expand_pallas import \
    expand_anchors as jax_expand_anchors
from skani_tpu.kernels.expand_pallas import expand_anchors_reference
from skani_tpu.kernels.gather_pallas import (
    genome_map_gather as jax_genome_map_gather, mxu_row_gather,
    mxu_row_scatter, mxu_row_scatter_multi, mxu_row_scatter_multi_wide,
    windowed_sorted_gather as jax_windowed_sorted_gather)
from skani_tpu_torch import synth
from skani_tpu_torch.kernels import (dp_compact, dp_pallas, expand_pallas,
                                     gather)
from test_dp_compact import MAX_GAP, PCL, SCORE, _synth
from test_dp_pallas import _pack_inputs, _random_rows
from test_expand_pallas import _mk
from test_gather_pallas import _cases

torch.set_num_threads(1)


def _scatter_case(rng, R=8, V=2, P=2048, K=256):
    # unique targets per row from a range 16x wider than K (most drop),
    # plus negative targets, which must drop too
    idx = np.stack([rng.permutation(16 * K)[:P] for _ in range(R)]) \
        .astype(np.int32)
    idx[:, :16] = -np.arange(1, 17, dtype=np.int32)
    vals = np.stack([_cases(rng, R, P, P)[0] for _ in range(V)], axis=1)
    vals[:, :, 16:26] = np.array([0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1, 0,
                                  0x80000001, 0xFF, 0x100, 0x7F7F7F7F,
                                  0xDEADBEEF], np.uint32).view(np.int32)
    return idx, vals


def test_row_gather_plain_matches_pallas():
    rng = np.random.default_rng(0)
    table, idx = _cases(rng, 8, 256, 1024)
    want = np.asarray(mxu_row_gather(table, idx, interpret=True))
    got = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_gather_row_map_matches_pallas_on_the_rows_copy():
    """The row-mapped gather equals the JAX kernel on the rows' copy
    table[rows] (whose contract wants clipped indices): repeated rows, the
    first and last rows, row ids outside [0, G) clamped, and indices -5
    and K + 7 clamped to the row."""
    rng = np.random.default_rng(3)
    G, R, K, A = 6, 8, 256, 1024
    table, idx = _cases(rng, G, K, A)
    idx = np.concatenate([idx, idx[:R - G]])
    idx[:, 8:10] = [-5, K + 7]
    rows = np.array([0, G - 1, 3, 3, 0, G - 1, 2, 4], np.int32)
    want = np.asarray(mxu_row_gather(table[rows], np.clip(idx, 0, K - 1),
                                     interpret=True))
    got = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    off = rows.copy()
    off[[2, 3]] = [-7, G + 2]                  # clamp to rows 0 and G - 1
    got = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx),
                            torch.from_numpy(off))
    clip = np.clip(idx[[2, 3]], 0, K - 1)
    np.testing.assert_array_equal(
        got.numpy()[[2, 3]],
        np.take_along_axis(table[[0, G - 1]], clip, 1))


@pytest.mark.parametrize("bad", ["rows_shape", "table_rows"])
def test_row_gather_refuses_bad_row_maps(bad):
    t = torch.zeros((4, 16), dtype=torch.int32)
    i = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "rows_shape":
            gather.row_gather(t, i, torch.zeros(4, dtype=torch.int32))
        else:
            gather.row_gather(t, i)


def test_row_scatter_multi_plain_matches_pallas():
    rng = np.random.default_rng(2)
    idx, vals = _scatter_case(rng)
    want = np.asarray(mxu_row_scatter_multi_wide(idx, vals, 256,
                                                 interpret=True))
    got = gather.row_scatter_multi(torch.from_numpy(idx),
                                   torch.from_numpy(vals), 256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_scatter_multi_plain_matches_pallas_narrow():
    """The narrow-dot TPU kernel (mxu_row_scatter_multi) has the wide one's
    contract; the same wrapper is its counterpart."""
    rng = np.random.default_rng(12)
    idx, vals = _scatter_case(rng, V=3)
    want = np.asarray(mxu_row_scatter_multi(idx, vals, 256, interpret=True))
    got = gather.row_scatter_multi(torch.from_numpy(idx),
                                   torch.from_numpy(vals), 256)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_scatter_plain_matches_pallas():
    rng = np.random.default_rng(13)
    idx, vals = _scatter_case(rng, V=1)
    want = np.asarray(mxu_row_scatter(idx, vals[:, 0], 256, interpret=True))
    got = gather.row_scatter(torch.from_numpy(idx),
                             torch.from_numpy(vals[:, 0].copy()), 256)
    assert got.shape == (8, 256)
    assert (want != 0).any() and (idx >= 256).any() and (idx < 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("U,A,WB", [
    (2048, 2048, 4),       # narrow window: overflow and clamped placement
    (8192, 1024, 64),      # the engine's WB; window = whole table
])
def test_windowed_sorted_gather_plain_matches_pallas(U, A, WB):
    rng = np.random.default_rng(U + WB)
    table, idx = synth.windowed_case(rng, 8, U, A, WB)
    want, want_ovf = jax_windowed_sorted_gather(table, idx, WB=WB,
                                                interpret=True)
    got, ovf = gather.windowed_sorted_gather(
        torch.from_numpy(table), torch.from_numpy(idx), WB)
    assert ovf.dtype == torch.bool
    # every row, flagged or not: zeros outside the window included
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(want_ovf))
    if WB < U // 128:
        assert ovf[2] and ovf[3] and not ovf[0] and not ovf[1]
        full = np.take_along_axis(table, np.clip(idx, 0, U - 1), 1)
        assert (got.numpy()[2] != full[2]).any()       # zeros were read
        np.testing.assert_array_equal(got.numpy()[:2], full[:2])
    else:
        assert ovf.tolist() == [False] * 4 + [True] + [False] * 3


def test_genome_map_gather_plain_matches_pallas():
    rng = np.random.default_rng(21)
    G, R, P, K = 3, 4, 4096, 256
    skid = rng.integers(0, K, (G, P)).astype(np.int32)
    skid[:, 3000:] = 0                                 # padding positions
    a_idx = np.array([2, 0, 0, 2], np.int32)           # repeated genomes
    jw, _ = _cases(rng, R, K, 1024)
    want = np.asarray(jax_genome_map_gather(skid, a_idx, jw,
                                            interpret=True))
    got = gather.genome_map_gather(torch.from_numpy(skid),
                                   torch.from_numpy(a_idx),
                                   torch.from_numpy(jw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 3000:],
                                  np.repeat(jw[:, :1], P - 3000, 1))


@pytest.mark.parametrize("seed,R,A,l_cap,band,tag", [
    (5, 2, 8192, 512, 35, False),     # medium preset band, RING 64
    (6, 1, 8192, 1024, 83, False),    # slow preset band, RING 128
    (7, 2, 8192, 512, 20, True),      # band < 32 with the tag packing
])
def test_dp_chain_compact_wide_plain_matches_pallas_all_columns(
        seed, R, A, l_cap, band, tag):
    rng = np.random.default_rng(seed)
    w1, w2, w3, colc = synth.dp_stream_wide(rng, R, A, l_cap, tag=tag)
    assert (w3 == -1).any() and (w3 >= 0).any()
    ws, wd = jax_dp_wide(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(w3),
                         jnp.asarray(colc), band, PCL, MAX_GAP, SCORE,
                         l_cap, interpret=True)
    gs, gd = dp_compact.dp_chain_compact_wide(
        torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(w3),
        torch.from_numpy(colc), band, PCL, MAX_GAP, SCORE, l_cap)
    assert (np.asarray(wd) >> 20).max() > 3             # chains formed
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_dp_chain_compact_wide_refuses_rings_past_256():
    """band >= 256 needs a ring the kernel cannot hold: the wrapper raises
    on every device and never hands over to the plain version."""
    w = torch.zeros((1, 8192), dtype=torch.int32)
    with pytest.raises(ValueError, match="ring"):
        dp_compact.dp_chain_compact_wide(w, w, w, w, 256, PCL, MAX_GAP,
                                         SCORE, 512)
    assert dp_compact.ring_size(255) == 256
    dp_compact.dp_chain_compact_wide(w, w, w, w, 255, PCL, MAX_GAP, SCORE,
                                     512)


@pytest.mark.parametrize("seed,R,A,l_cap,band", [
    (0, 2, 8192, 512, 20),
    (1, 3, 8192, 512, 20),
    (2, 1, 16384, 512, 20),     # multiple segments per row
    (3, 2, 8192, 257, 20),      # l_cap not a power of two
    (4, 2, 8192, 512, 31),      # widest legal band (cid-tag edge)
])
def test_dp_chain_compact_plain_matches_pallas_all_columns(seed, R, A,
                                                           l_cap, band):
    rng = np.random.default_rng(seed)
    w1, w2, colc, _chunks = _synth(rng, R, A, l_cap)
    ws, wd = jax_dp(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(colc),
                    band, PCL, MAX_GAP, SCORE, l_cap, interpret=True)
    gs, gd = dp_compact.dp_chain_compact(
        torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(colc),
        band, PCL, MAX_GAP, SCORE, l_cap)
    # every column, valid or not: the halo select reproduces the TPU
    # layout's zero fill exactly
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_dp_chain_compact_plain_matches_pallas_phase_a_tail():
    """Streams shaped like phase A's: an invalid tail whose col_in_chunk
    keeps counting from the last chunk start, so the halo select also
    fires on invalid columns (and yields the TPU layout's zero fill)."""
    rng = np.random.default_rng(9)
    w1, w2, colc = synth.dp_stream(rng, 2, 16384, 512)
    ws, wd = jax_dp(jnp.asarray(w1), jnp.asarray(w2), jnp.asarray(colc),
                    20, PCL, MAX_GAP, SCORE, 512, interpret=True)
    gs, gd = dp_compact.dp_chain_compact(
        torch.from_numpy(w1), torch.from_numpy(w2), torch.from_numpy(colc),
        20, PCL, MAX_GAP, SCORE, 512)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_cpu_calls_never_count_launches():
    before = dict(gather.LAUNCHES, **dp_compact.LAUNCHES)
    rng = np.random.default_rng(5)
    table, idx = _cases(rng, 2, 256, 1024)
    gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    sidx, svals = _scatter_case(rng, R=2)
    gather.row_scatter_multi(torch.from_numpy(sidx),
                             torch.from_numpy(svals), 256)
    w1, w2, colc, _ = _synth(rng, 1, 8192, 512)
    dp_compact.dp_chain_compact(torch.from_numpy(w1), torch.from_numpy(w2),
                                torch.from_numpy(colc), 20, PCL, MAX_GAP,
                                SCORE, 512)
    gather.row_scatter(torch.from_numpy(sidx),
                       torch.from_numpy(svals[:, 0].copy()), 256)
    wt, wi = synth.windowed_case(rng, 8, 2048, 1024, 4)
    gather.windowed_sorted_gather(torch.from_numpy(wt),
                                  torch.from_numpy(wi), 4)
    gather.genome_map_gather(
        torch.from_numpy(idx[:, :512] % 256),
        torch.zeros(2, dtype=torch.int32), torch.from_numpy(table))
    wide = [torch.from_numpy(x)
            for x in synth.dp_stream_wide(rng, 1, 8192, 512)]
    dp_compact.dp_chain_compact_wide(*wide, 35, PCL, MAX_GAP, SCORE, 512)
    after = dict(gather.LAUNCHES, **dp_compact.LAUNCHES)
    assert after == before
    assert set(after) == {
        "row_gather", "windowed_sorted_gather", "genome_map_gather",
        "row_scatter", "row_scatter_multi", "dp_chain_compact",
        "dp_chain_compact_wide"}


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, never computed by the plain version."""
    t = torch.empty((2, 1024), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        gather.row_gather(t, t)
    with pytest.raises(RuntimeError):
        gather.row_scatter_multi(t, t.reshape(2, 1, 1024), 256)
    with pytest.raises(RuntimeError):
        gather.row_scatter(t, t, 256)
    with pytest.raises(RuntimeError):
        gather.windowed_sorted_gather(t, t, 4)
    with pytest.raises(RuntimeError):
        gather.genome_map_gather(t, t[:, 0], t)
    w = torch.empty((1, 8192), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        dp_compact.dp_chain_compact(w, w, w, 20, PCL, MAX_GAP, SCORE, 512)
    with pytest.raises(RuntimeError):
        dp_compact.dp_chain_compact_wide(w, w, w, w, 83, PCL, MAX_GAP,
                                         SCORE, 1024)
    # nor is a mix of CPU and other tensors computed on the CPU
    c = torch.zeros((2, 1024), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        gather.windowed_sorted_gather(c, t, 4)
    with pytest.raises(RuntimeError):
        gather.genome_map_gather(c, t[:, 0], c)


# --- the padded DPs (kernels/dp_pallas.py) ---

# (band, pcl, max_gap, L, RC): the shapes of tests/test_dp_pallas.py, lane
# counts that are no multiple of 128, and bands 20 / 35 / 83
_PADDED = [(20, 2500, 300, 64, 256), (5, 100, 50, 64, 256),
           (35, 2500, 300, 48, 128), (83, 2500, 300, 96, 128),
           (20, 2500, 300, 32, 384), (20, 2500, 300, 32, 96),
           (35, 2500, 300, 64, 100), (83, 2500, 300, 104, 37)]


def _padded_inputs(seed, L, RC, adversarial):
    rng = np.random.default_rng(seed)
    if adversarial:
        return synth.padded_dp_case(rng, L, RC)
    return _random_rows(rng, L, RC, n_contigs=3)


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("band,pcl,max_gap,L,RC", _PADDED)
def test_dp_chain_plain_matches_scan_and_pallas(band, pcl, max_gap, L, RC,
                                                adversarial):
    qp, rp, rcv = _padded_inputs(42 + L, L, RC, adversarial)
    dd, root = dp_pallas.dp_chain(
        torch.from_numpy(qp), torch.from_numpy(rp), torch.from_numpy(rcv),
        band, pcl, max_gap, 20)
    dd_s, root_s = _dp_scan(qp, rp, rcv, band, pcl, max_gap, 20, unroll=8)
    np.testing.assert_array_equal(dd.numpy(), np.asarray(dd_s))
    np.testing.assert_array_equal(root.numpy(), np.asarray(root_s))
    dd_p, root_p = _dp_pallas(qp, rp, rcv, band, pcl, max_gap, 20,
                              interpret=True)
    np.testing.assert_array_equal(dd.numpy(), np.asarray(dd_p))
    np.testing.assert_array_equal(root.numpy(), np.asarray(root_p))
    assert dp_pallas.dbits(L) == jax_dbits(L)
    assert (dd.numpy() & ((1 << dp_pallas.dbits(L)) - 1)).max() >= 1


@pytest.mark.parametrize("adversarial", [False, True])
@pytest.mark.parametrize("band,pcl,max_gap,L,RC", _PADDED)
def test_dp_chain_packed_plain_matches_scan_and_pallas(band, pcl, max_gap,
                                                       L, RC, adversarial):
    if adversarial:
        qprv, rprc = synth.padded_dp_case(np.random.default_rng(7 + L), L,
                                          RC, packed=True)
    else:
        qprv, rprc = _pack_inputs(*_padded_inputs(11 + L, L, RC, False))
    EBITS = int(np.ceil(np.log2(L)))
    ddr = dp_pallas.dp_chain_packed(
        torch.from_numpy(qprv), torch.from_numpy(rprc), band, pcl, max_gap,
        20, EBITS).numpy()
    np.testing.assert_array_equal(ddr, np.asarray(_dp_scan_packed(
        qprv, rprc, band, pcl, max_gap, 20, EBITS, unroll=8)))
    np.testing.assert_array_equal(ddr, np.asarray(_dp_pallas_packed(
        qprv, rprc, band, pcl, max_gap, 20, EBITS, interpret=True)))
    assert ((ddr >> EBITS) & ((1 << EBITS) - 1)).max() >= 1


def test_padded_dp_packings_differ_at_powers_of_two():
    """dbits = ceil_log2(L + 1) against EBITS = ceil_log2(L): at L = 64
    the depth field of dp_chain is one bit wider than dp_chain_packed's
    root field; both hold the same scores, depths and roots."""
    L, RC = 64, 40
    qp, rp, rcv = synth.padded_dp_case(np.random.default_rng(3), L, RC)
    dd, root = dp_pallas.dp_chain(*map(torch.from_numpy, (qp, rp, rcv)),
                                  20, PCL, MAX_GAP, SCORE)
    qprv, rprc = _pack_inputs(np.where(rcv & 1, qp, 0),
                              np.where(rcv & 1, rp, 0), rcv)
    ddr = dp_pallas.dp_chain_packed(torch.from_numpy(qprv),
                                    torch.from_numpy(rprc), 20, PCL,
                                    MAX_GAP, SCORE, 6)
    assert (dp_pallas.dbits(L), 6) == (7, 6)
    assert torch.equal(dd >> 7, ddr >> 12)
    assert torch.equal(dd & 127, (ddr >> 6) & 63)
    assert torch.equal(root, ddr & 63)
    assert int((dd >> 7).max()) > 20


def test_padded_dp_refuses_rings_past_256_and_bad_packing():
    w = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="ring"):
        dp_pallas.dp_chain(w, w, w, 256, PCL, MAX_GAP, SCORE)
    with pytest.raises(ValueError, match="ring"):
        dp_pallas.dp_chain_packed(w, w, 256, PCL, MAX_GAP, SCORE, 4)
    dp_pallas.dp_chain(w, w, w, 255, PCL, MAX_GAP, SCORE)
    with pytest.raises(ValueError, match="EBITS"):     # 1024 * 20 >= 2^12
        z = torch.zeros((1024, 2), dtype=torch.int32)
        dp_pallas.dp_chain_packed(z, z, 20, PCL, MAX_GAP, SCORE, 10)
    with pytest.raises(ValueError, match="shape"):
        dp_pallas.dp_chain(w, w[:8], w, 20, PCL, MAX_GAP, SCORE)


# --- the expansion kernel (kernels/expand_pallas.py) ---

def _expand_all(offs, bs, apk, total, A):
    got = expand_pallas.expand_anchors(
        *(torch.from_numpy(x) for x in (offs, bs, apk, total)), A)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("density", [
    [0, 0, 1, 1, 1, 1, 2, 3], [0, 1], [0, 0, 0, 1, 2]])
def test_expand_anchors_plain_matches_oracle_and_pallas(density):
    rng = np.random.default_rng(hash(tuple(density)) % 2**31)
    R, P, A = 3, 4096, 4096
    offs, bs, apk, total = _mk(rng, R, P, density, [4000, 2500, 64])
    aw, brow, ovf = _expand_all(offs, bs, apk, total, A)
    aw_r, brow_r, ovf_r = expand_anchors_reference(offs, bs, apk, total, A)
    aw_p, brow_p, ovf_p = map(np.asarray, jax_expand_anchors(
        offs, bs, apk, total, A, interpret=True))
    np.testing.assert_array_equal(ovf, ovf_r)
    np.testing.assert_array_equal(ovf, ovf_p)
    # every slot, past `total` too: the plain version is the TPU kernel's
    # function, not only its valid prefix
    for got, ref, pal in ((aw, aw_r, aw_p), (brow, brow_r, brow_p)):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pal)


def test_expand_anchors_plain_sparse_overflows_and_window_edge():
    """The two edge inputs of tests/test_expand_pallas.py: emitters spaced
    wider than the window flag overflow; runs crossing 128-blocks and
    window restarts stay exact."""
    P, A = 4096, 2048
    cnt = np.zeros((1, P), np.int32)
    cnt[0, ::37] = 1
    offs = np.cumsum(cnt, axis=1) - cnt
    total = np.array([cnt.sum()], np.int32)
    bs = np.zeros((1, P), np.int32)
    apk = np.arange(P, dtype=np.int32)[None, :]
    aw, brow, ovf = _expand_all(offs, bs, apk, total, A)
    aw_p, brow_p, ovf_p = map(np.asarray, jax_expand_anchors(
        offs, bs, apk, total, A, interpret=True))
    assert ovf[0] == 1 and ovf_p[0] == 1
    np.testing.assert_array_equal(aw, aw_p)
    np.testing.assert_array_equal(brow, brow_p)
    P = A = 2048
    cnt = np.full((1, P), 1, np.int32)
    cnt[0, 1::2] = 3
    offs = np.cumsum(cnt, axis=1) - cnt
    total = np.array([min(int(offs[0, -1] + cnt[0, -1]), A)], np.int32)
    rng = np.random.default_rng(5)
    bs = rng.integers(0, 1 << 17, size=(1, P)).astype(np.int32)
    apk = synth.adversarial_words(rng, (1, P))
    got = _expand_all(offs, bs, apk, total, A)
    ref = expand_anchors_reference(offs, bs, apk, total, A)
    pal = map(np.asarray, jax_expand_anchors(offs, bs, apk, total, A,
                                             interpret=True))
    for g, r, p_ in zip(got, ref, pal):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, p_)


def test_expand_anchors_plain_adversarial_rows_match_pallas():
    """synth.expand_case: total 0, total == A, a row past the window, a row
    past the buffer, full-range apk words."""
    rng = np.random.default_rng(19)
    R, P, A = 5, 4096, 4096
    offs, bs, apk, total = synth.expand_case(rng, R, P, A)
    assert total[0] == 0 and total[1] == A and total[3] > A
    got = _expand_all(offs, bs, apk, total, A)
    pal = map(np.asarray, jax_expand_anchors(offs, bs, apk, total, A,
                                             interpret=True))
    for g, p_ in zip(got, pal):
        np.testing.assert_array_equal(g, p_)
    assert got[2][:4].tolist() == [0, 0, 1, 0]
    assert (apk < 0).any() and (got[0] < 0).any()


def test_expand_anchors_refuses_bad_shapes():
    z = torch.zeros((2, 2048), dtype=torch.int32)
    t = torch.zeros((2,), dtype=torch.int32)
    expand_pallas.expand_anchors(z, z, z, t, 1024)
    with pytest.raises(ValueError, match="unsupported"):
        expand_pallas.expand_anchors(z, z, z, t, 1000)       # A % 1024
    with pytest.raises(ValueError, match="unsupported"):
        expand_pallas.expand_anchors(z[:, :1024], z[:, :1024], z[:, :1024],
                                     t, 1024)                # P < 2048
    with pytest.raises(ValueError, match="bad shapes"):
        expand_pallas.expand_anchors(z, z, z, t[:1], 1024)
    assert (expand_pallas.TILE, expand_pallas.WBLK) == (1024, 16)


def test_new_wrappers_count_no_cpu_launch_and_refuse_other_devices():
    before = dict(dp_pallas.LAUNCHES, **expand_pallas.LAUNCHES)
    assert set(before) == {"dp_chain", "dp_chain_packed", "expand_anchors"}
    rng = np.random.default_rng(1)
    qp, rp, rcv = synth.padded_dp_case(rng, 16, 8)
    dp_pallas.dp_chain(*map(torch.from_numpy, (qp, rp, rcv)), 20, PCL,
                       MAX_GAP, SCORE)
    dp_pallas.dp_chain_packed(
        *map(torch.from_numpy, synth.padded_dp_case(rng, 16, 8,
                                                    packed=True)),
        20, PCL, MAX_GAP, SCORE, 4)
    _expand_all(*synth.expand_case(rng, 4, 2048, 1024), 1024)
    assert dict(dp_pallas.LAUNCHES, **expand_pallas.LAUNCHES) == before
    m = torch.empty((16, 8), dtype=torch.int32, device="meta")
    c = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        dp_pallas.dp_chain(m, m, m, 20, PCL, MAX_GAP, SCORE)
    with pytest.raises(RuntimeError):
        dp_pallas.dp_chain(c, m, c, 20, PCL, MAX_GAP, SCORE)
    with pytest.raises(RuntimeError):
        dp_pallas.dp_chain_packed(m, m, 20, PCL, MAX_GAP, SCORE, 4)
    e = torch.empty((2, 2048), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        expand_pallas.expand_anchors(e, e, e, e[:, 0], 1024)
    z = torch.zeros((2, 2048), dtype=torch.int32)
    with pytest.raises(RuntimeError):
        expand_pallas.expand_anchors(z, e, z, z[:, 0].contiguous(), 1024)
