"""The port's CUDA kernels and device path on the card (marker `cuda`;
each test skips on a host without CUDA).  No JAX here: the machine with
the card has none.  Run there with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Every comparison is exact: kernel against plain version on the same
device, and CUDA phase_a / engine against the CPU plain path and the
native per-pair path.
"""
import numpy as np
import pytest
import torch

from skani_tpu_torch import CommandParams, SketchParams, stats, synth
from skani_tpu_torch.ani import chain_seeds_native
from skani_tpu_torch.kernels import (dp_compact, dp_pallas, expand_pallas,
                                     gather)
from skani_tpu_torch.kernels.device_db import DeviceDb
from skani_tpu_torch.kernels.device_pipeline import (DevicePairEngine,
                                                     phase_a)
from skani_tpu_torch.params import map_params_from_sketch
from torch_expand_cases import CASES as EXPAND_CASES
from torch_expand_cases import OUTSIDE as EXPAND_OUTSIDE
from torch_expand_cases import case as expand_case
from torch_gather_cases import gmap_inputs, scatter_inputs
from test_torch_seeding_cases import CASES as SEED_CASES
from test_torch_seeding_cases import acgt
from test_torch_seeding_cases import case as seed_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")


def test_row_gather_kernel_matches_plain(dev):
    rng = np.random.default_rng(7)
    R, K, A = 33, 40960, 47104
    table = torch.from_numpy(synth.adversarial_words(rng, (R, K))).to(dev)
    idx_np = rng.integers(0, K, size=(R, A)).astype(np.int32)
    idx_np[:, :8] = [0, 1, 127, 128, K - 2, K - 1, -5, K + 7]
    idx = torch.from_numpy(idx_np).to(dev)
    n0 = gather.LAUNCHES["row_gather"]
    got = gather.row_gather(table, idx)
    assert gather.LAUNCHES["row_gather"] == n0 + 1
    assert torch.equal(got, gather.row_gather_plain(table, idx))


# (G, R, K, A, rows): shapes whose launch offers staging (rows of at most
# ROW_SMEM_WORDS words, among them the widest, where a wave's spans hold
# more indices than the row has sectors) and shapes read directly (one
# word wider, rows wider still, short spans; one index a thread where
# R * A fits the card's threads once, else four), with and without the
# row map, R > G with repeated rows, index widths A % 4 != 0 and odd K
# (rows that start off a 16-byte boundary)
_ROW_MAP = [
    (40, 33, 40960, 47104, True), (33, 33, 40960, 47104, False),
    (20, 33, 98304, 40960, True), (33, 33, 98304, 40960, False),
    (5, 7, 300001, 20000, True),
    (3, 4, gather.ROW_SMEM_WORDS, 262144, True),
    (3, 4, gather.ROW_SMEM_WORDS + 1, 262144, True),
    (9, 33, 5001, 40001, True),
    (2, 1, 30001, 200000, True), (6, 13, 70001, 1023, True),
    (2, 3, 5, 7, True), (64, 128, 512, 512, True)]


@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("G,R,K,A,use_rows", _ROW_MAP)
def test_row_gather_kernel_row_map(dev, G, R, K, A, use_rows, order):
    """Exact against the plain version, one launch a call: random indices
    (blocks that are offered staging stage their row) and per-row sorted
    ones (every block reads directly), each with indices -5 and K + 7."""
    rng = np.random.default_rng(G * 7 + K + A)
    table = torch.from_numpy(synth.adversarial_words(rng, (G, K))).to(dev)
    idx_np = rng.integers(0, K, size=(R, A)).astype(np.int32)
    if order == "sorted":
        idx_np.sort(axis=1)
        idx_np[:, 0], idx_np[:, -1] = -5, K + 7
    else:
        idx_np[:, :min(A, 8)] = np.array(
            [0, 1, 127, 128, K - 2, K - 1, -5, K + 7], np.int32)[:min(A, 8)]
    idx = torch.from_numpy(idx_np).to(dev)
    rows = None
    if use_rows:
        r_np = rng.integers(0, G, size=R).astype(np.int32)
        r_np[:3] = np.array([0, G - 1, 0], np.int32)[:R]
        rows = torch.from_numpy(r_np).to(dev)
    n0 = gather.LAUNCHES["row_gather"]
    got = gather.row_gather(table, idx, rows)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["row_gather"] == n0 + 1
    assert torch.equal(got, gather.row_gather_plain(table, idx, rows))


def test_row_gather_kernel_row_map_clamps_rows(dev):
    rng = np.random.default_rng(17)
    table = torch.from_numpy(synth.adversarial_words(rng, (6, 4096))).to(dev)
    idx = torch.from_numpy(rng.integers(0, 4096, (4, 4096))
                           .astype(np.int32)).to(dev)
    rows = torch.tensor([-3, 6, 100, 2], dtype=torch.int32, device=dev)
    got = gather.row_gather(table, idx, rows)
    want = gather.row_gather(table, idx,
                             torch.tensor([0, 5, 5, 2], dtype=torch.int32,
                                          device=dev))
    assert torch.equal(got, want)
    assert torch.equal(got, gather.row_gather_plain(table, idx, rows))


def test_row_scatter_multi_kernel_matches_plain(dev):
    rng = np.random.default_rng(8)
    R, P, K = 33, 40960, 47104
    idx = torch.from_numpy(synth.unique_targets(rng, R, P, K)).to(dev)
    vals = torch.from_numpy(synth.adversarial_words(rng, (R, 2, P))).to(dev)
    got = gather.row_scatter_multi(idx, vals, K)
    assert torch.equal(got, gather.row_scatter_multi_plain(idx, vals, K))


@pytest.mark.parametrize("band,l_cap", [(20, 512), (31, 512), (20, 257),
                                        (12, 1024)])
def test_dp_chain_compact_kernel_matches_plain(dev, band, l_cap):
    rng = np.random.default_rng(band * 1000 + l_cap)
    ins = [torch.from_numpy(x).to(dev)
           for x in synth.dp_stream(rng, 4, 16384, l_cap)]
    args = (band, 2500, 300, 20, l_cap)
    got = dp_compact.dp_chain_compact(*ins, *args)
    want = dp_compact.dp_chain_compact_plain(*ins, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("R,A,l_cap,band,edges", [
    (3, 8192, 257, 8, False), (3, 8192, 512, 8, True),
    (3, 8192, 512, 20, False), (3, 8192, 257, 20, True),
    (3, 8192, 512, 20, True), (3, 8192, 257, 31, False),
    (3, 8192, 512, 31, True), (33, 47104, 512, 20, False)])
def test_dp_chain_compact_kernel_schedule_cases(dev, R, A, l_cap, band,
                                                edges):
    """The cases of the schedule test (tests/test_torch_dp_schedule.py
    _COMPACT: bands 8, 20 and 31, caps 257 and 512, the 2-plane edge
    streams) and the default batch's shape, kernel against plain version."""
    rng = np.random.default_rng(band + l_cap + R)
    ins = _dev(synth.dp_stream(rng, R, A, l_cap, edges=edges), dev)
    args = (band, 2500, 300, 20, l_cap)
    n0 = dp_compact.LAUNCHES["dp_chain_compact"]
    got = dp_compact.dp_chain_compact(*ins, *args)
    assert dp_compact.LAUNCHES["dp_chain_compact"] == n0 + 1
    want = dp_compact.dp_chain_compact_plain(*ins, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) >> 20 > 3


def _dev(xs, dev):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]


@pytest.mark.parametrize("U,A,WB", [(8192, 4096, 64), (40960, 47104, 64),
                                    (2048, 2048, 4)])
def test_windowed_sorted_gather_kernel_matches_plain(dev, U, A, WB):
    rng = np.random.default_rng(U + A)
    table, idx = _dev(synth.windowed_case(rng, 33, U, A, WB), dev)
    n0 = gather.LAUNCHES["windowed_sorted_gather"]
    got, ovf = gather.windowed_sorted_gather(table, idx, WB)
    assert gather.LAUNCHES["windowed_sorted_gather"] == n0 + 1
    want, want_ovf = gather.windowed_sorted_gather_plain(table, idx, WB)
    assert torch.equal(got, want) and torch.equal(ovf, want_ovf)
    assert ovf.any() and not ovf.all()


def test_genome_map_gather_kernel_matches_plain(dev):
    rng = np.random.default_rng(9)
    G, R, P, K = 7, 33, 45056, 43008
    skid = rng.integers(0, K, (G, P)).astype(np.int32)
    skid[:, 40000:] = 0
    a_idx = np.sort(rng.integers(0, G, R)).astype(np.int32)
    skid, a_idx, jw = _dev([skid, a_idx,
                            synth.adversarial_words(rng, (R, K))], dev)
    got = gather.genome_map_gather(skid, a_idx, jw)
    assert torch.equal(got, gather.genome_map_gather_plain(skid, a_idx, jw))


def test_row_scatter_kernel_matches_plain(dev):
    rng = np.random.default_rng(10)
    R, P, K = 33, 40960, 47104
    idx, vals = _dev([synth.unique_targets(rng, R, P, K),
                      synth.adversarial_words(rng, (R, P))], dev)
    n0 = dict(gather.LAUNCHES)
    got = gather.row_scatter(idx, vals, K)
    assert gather.LAUNCHES["row_scatter"] == n0["row_scatter"] + 1
    assert gather.LAUNCHES["row_scatter_multi"] == n0["row_scatter_multi"]
    assert torch.equal(got, gather.row_scatter_plain(idx, vals, K))


# (kind, R, V, P, K): the cases of the schedule test
# (tests/test_torch_gather_schedule.py), the main path's fills (default
# batch, V 2; contigs batch, V 1), V 3, more rows than SMs, V planes wider
# than one block's shared memory, a row wider than the card has tiles
_SCATTER = [
    ("ascending", 4, 2, 4096, 4480), ("ascending", 3, 1, 4096, 5003),
    ("random", 8, 1, 2048, 3000), ("random", 5, 2, 4096, 4096),
    ("dropped", 8, 2, 2048, 256), ("dropped", 6, 3, 2048, 384),
    ("dropped", 5, 2, 2050, 1001), ("random", 3, 3, 999, 1001),
    ("dropped", 40, 1, 2048, 640), ("ascending", 3, 3, 4096, 3000),
    ("ascending", 33, 2, 40960, 47104), ("random", 33, 2, 40960, 47104),
    ("ascending", 32, 1, 45056, 49152), ("dropped", 33, 1, 40960, 47104),
    ("random", 33, 3, 40960, 47104), ("dropped", 200, 1, 513, 7001),
    ("random", 2, 3, 30000, 60000), ("dropped", 1, 1, 77, 200000)]


@pytest.mark.parametrize("kind,R,V,P,K", _SCATTER)
def test_row_scatter_kernel_cases(dev, kind, R, V, P, K):
    """Kernel against plain version, one launch a call, every case of the
    scatter schedule and the main path's shapes (V = 1 through both
    wrappers)."""
    rng = np.random.default_rng(R * 1000 + V * 100 + P + K)
    idx_np, vals_np = scatter_inputs(rng, kind, R, V, P, K)
    idx, vals = _dev([idx_np, vals_np], dev)
    n0 = dict(gather.LAUNCHES)
    got = gather.row_scatter_multi(idx, vals, K)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["row_scatter_multi"] == n0["row_scatter_multi"] + 1
    want = gather.row_scatter_multi_plain(idx, vals, K)
    assert torch.equal(got, want)
    if V == 1:
        one = gather.row_scatter(idx, vals[:, 0].contiguous(), K)
        torch.cuda.synchronize()
        assert gather.LAUNCHES["row_scatter"] == n0["row_scatter"] + 1
        assert torch.equal(one, want[:, 0])


def test_row_scatter_kernel_unaligned_inputs(dev):
    """Targets and payloads that start off a 16-byte boundary take the
    one-word loads; K % 4 != 0 the one-word stores."""
    rng = np.random.default_rng(31)
    R, V, P, K = 5, 2, 4096, 4999
    idx_np, vals_np = scatter_inputs(rng, "dropped", R, V, P, K)
    ib = torch.zeros(R * P + 1, dtype=torch.int32, device=dev)
    vb = torch.zeros(R * V * P + 1, dtype=torch.int32, device=dev)
    idx = ib[1:].view(R, P)
    vals = vb[1:].view(R, V, P)
    idx.copy_(torch.from_numpy(idx_np))
    vals.copy_(torch.from_numpy(vals_np))
    assert idx.data_ptr() % 16 and vals.data_ptr() % 16
    got = gather.row_scatter_multi(idx, vals, K)
    assert torch.equal(got, gather.row_scatter_multi_plain(idx, vals, K))


def test_row_scatter_multi_kernel_refuses_four_payloads(dev):
    idx = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    vals = torch.zeros((2, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        gather.row_scatter_multi(idx, vals, 16)


# (kind, G, R, P, K): the cases of the schedule test, then rows that fit a
# block's shared memory (ROW_SMEM_WORDS: the contigs and joins batches'
# kmer axes) and wider ones (the slow and -c 20 batches'), more rows than
# SMs; then each branch of the launch rule: a narrow row with 42 SMs
# idle (row-affine), a wide row in spans of P / 5 words (row-affine), jw
# rows over 3/5 of the L2 (one thread a position)
_GMAP = [
    ("unsorted", 5, 9, 4096, 256), ("all_equal", 4, 6, 4096, 384),
    ("out_of_range", 5, 7, 4096, 300), ("unsorted", 3, 12, 4099, 1001),
    ("unsorted", 16, 32, 45056, 38912),
    ("all_equal", 16, 33, 40960, gather.ROW_SMEM_WORDS),
    ("unsorted", 16, 32, 167936, 157696),
    ("out_of_range", 16, 29, 253952, 235520),
    ("unsorted", 7, 200, 1001, 5000),
    ("unsorted", 16, 45, 45056, 38912),
    ("unsorted", 16, 24, 167936, 157696),
    ("unsorted", 16, 34, 253952, 235520)]


@pytest.mark.parametrize("kind,G,R,P,K", _GMAP)
def test_genome_map_gather_kernel_cases(dev, kind, G, R, P, K):
    rng = np.random.default_rng(G * 1000 + R + P + K)
    skid, a_idx, jw = _dev(gmap_inputs(rng, kind, G, R, P, K), dev)
    n0 = gather.LAUNCHES["genome_map_gather"]
    got = gather.genome_map_gather(skid, a_idx, jw)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["genome_map_gather"] == n0 + 1
    assert torch.equal(got, gather.genome_map_gather_plain(skid, a_idx, jw))


@pytest.mark.parametrize("band,l_cap,tag", [
    (35, 512, False), (83, 1024, False), (200, 512, False),
    (20, 512, True), (5, 257, True), (32, 512, False), (64, 512, False),
    (96, 512, False), (160, 512, False), (192, 512, False)])
def test_dp_chain_compact_wide_kernel_matches_plain(dev, band, l_cap, tag):
    rng = np.random.default_rng(band * 1000 + l_cap)
    ins = _dev(synth.dp_stream_wide(rng, 3, 16384, l_cap, tag=tag), dev)
    args = (band, 2500, 300, 20, l_cap)
    got = dp_compact.dp_chain_compact_wide(*ins, *args)
    want = dp_compact.dp_chain_compact_wide_plain(*ins, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) >> 20 > 3


def test_dp_chain_compact_wide_refuses_wide_rings_on_the_card(dev):
    w = torch.zeros((1, 8192), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ring"):
        dp_compact.dp_chain_compact_wide(w, w, w, w, 256, 2500, 300, 20,
                                         512)


@pytest.fixture(scope="module")
def small_set():
    sp, cp = SketchParams(), CommandParams()
    gs = synth.genome_set(5, 5, 300_000, n_repeats=6, n_split=2,
                          contigs=(2, 6))
    sks = [synth.sketch_parts(p, sp, f"c{i}") for i, p in enumerate(gs)]
    pairs = [(i, j) for i in range(5) for j in range(5) if i != j]
    return sp, cp, sks, pairs


def test_phase_a_cuda_matches_cpu(dev, small_set):
    sp, cp, sks, pairs = small_set
    eng = DevicePairEngine(sks, sp, cp, device=dev)
    _out, meta, _m = eng.plan(pairs)
    group = next(eng.groups(meta))
    args = eng.batch_args(group, group[0][4])
    ab = eng.batch_index(group)
    got = phase_a(eng.db.arrays, ab, **args).cpu()
    want = phase_a(eng.db.to("cpu").arrays, ab.cpu(), **args)
    assert torch.equal(got, want)


def test_engine_cuda_matches_native(dev, small_set):
    sp, cp, sks, pairs = small_set
    res = DevicePairEngine(sks, sp, cp, device=dev).run_pairs(pairs)
    for (i, j), r in zip(pairs, res):
        mp = map_params_from_sketch(sks[i], False, cp, None)
        n = chain_seeds_native(sks[i], sks[j], mp)
        for f in ("ani", "align_fraction_query", "align_fraction_ref",
                  "ci_lower"):
            a, b = getattr(r, f), getattr(n, f)
            assert a == b or (np.isnan(a) and np.isnan(b)), (i, j, f)


@pytest.mark.parametrize("host_workers", [0, 2])
def test_engine_cuda_host_workers(dev, small_set, host_workers):
    """run_pairs on the card with host steal-workers (batch 2: the queue
    holds more than two batches, so they start), the native finalize on
    the pinned readbacks: native's results, every pair scored once
    (device, host worker or mirror)."""
    sp, cp, sks, pairs = small_set
    eng = DevicePairEngine(sks, sp, cp, device=dev, batch=2)
    before = stats.snapshot()
    res = eng.run_pairs(pairs, host_workers=host_workers)
    after = stats.snapshot()
    d = {k: after.get(k, 0) - before.get(k, 0)
         for k in ("pairs_device", "pairs_host", "pairs_mirrored")}
    assert sum(d.values()) == len(pairs)
    assert (d["pairs_host"] == 0) or host_workers > 0
    for (i, j), r in zip(pairs, res):
        mp = map_params_from_sketch(sks[i], False, cp, None)
        n = chain_seeds_native(sks[i], sks[j], mp)
        for f in ("ani", "align_fraction_query", "align_fraction_ref",
                  "ci_lower", "ci_upper"):
            a, b = getattr(r, f), getattr(n, f)
            assert a == b or (np.isnan(a) and np.isnan(b)), (i, j, f)


@pytest.mark.parametrize("join_mode", ["dense", "merge"])
def test_phase_a_joins_cuda_match_cpu(dev, small_set, join_mode):
    sp, cp, sks, pairs = small_set
    eng = DevicePairEngine(sks, sp, cp, device=dev, join_mode=join_mode)
    _out, meta, _m = eng.plan(pairs)
    group = next(eng.groups(meta))
    args = eng.batch_args(group, group[0][4])
    ab = eng.batch_index(group)
    cpu = eng.db.to("cpu").arrays
    for fused in (True, False):
        got = phase_a(eng.db.arrays, ab, fused_apk=fused, **args).cpu()
        assert torch.equal(got, phase_a(cpu, ab.cpu(), fused_apk=fused,
                                        **args))


def test_engine_slow_preset_cuda_matches_native(dev):
    """c=30 (band 83): the unfused fill is not reached at this size, but
    the 3-plane DP at RING 128 is, through the engine on the card."""
    sp, cp = SketchParams(c=30), CommandParams()
    gs = synth.genome_set(6, 4, 400_000, copies=(2, 4, 8, 200),
                          rates=(0.003, 0.02), n_split=2, contigs=(2, 5))
    sks = [synth.sketch_parts(p, sp, f"s{i}") for i, p in enumerate(gs)]
    pairs = [(i, j) for i in range(4) for j in range(4) if i != j]
    n0 = dp_compact.LAUNCHES["dp_chain_compact_wide"]
    res = DevicePairEngine(sks, sp, cp, device=dev).run_pairs(pairs)
    assert dp_compact.LAUNCHES["dp_chain_compact_wide"] > n0
    for (i, j), r in zip(pairs, res):
        mp = map_params_from_sketch(sks[i], False, cp, None)
        n = chain_seeds_native(sks[i], sks[j], mp)
        for f in ("ani", "align_fraction_query", "align_fraction_ref",
                  "ci_lower"):
            a, b = getattr(r, f), getattr(n, f)
            assert a == b or (np.isnan(a) and np.isnan(b)), (i, j, f)


# --- the padded DPs, the expansion kernel and the branches they serve ---

@pytest.mark.parametrize("band,L,RC", [
    (20, 512, 300), (35, 128, 1024), (83, 1024, 203), (200, 96, 64),
    (5, 40, 9), (32, 256, 300), (64, 256, 300), (96, 256, 203),
    (160, 256, 64), (192, 256, 64)])
def test_dp_chain_kernel_matches_plain(dev, band, L, RC):
    rng = np.random.default_rng(band * 1000 + L)
    ins = _dev(synth.padded_dp_case(rng, L, RC), dev)
    n0 = dp_pallas.LAUNCHES["dp_chain"]
    got = dp_pallas.dp_chain(*ins, band, 2500, 300, 20)
    assert dp_pallas.LAUNCHES["dp_chain"] == n0 + 1
    want = dp_pallas.dp_chain_plain(*ins, band, 2500, 300, 20)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0] & ((1 << dp_pallas.dbits(L)) - 1)).max()) > 3
    assert int(got[0][:, 0].max()) == 0                 # the empty lane


@pytest.mark.parametrize("band,L,RC", [
    (20, 512, 300), (31, 64, 1000), (83, 128, 77), (12, 33, 8)])
def test_dp_chain_packed_kernel_matches_plain(dev, band, L, RC):
    rng = np.random.default_rng(band * 1000 + L + 1)
    ins = _dev(synth.padded_dp_case(rng, L, RC, packed=True), dev)
    E = int(np.ceil(np.log2(L)))
    n0 = dp_pallas.LAUNCHES["dp_chain_packed"]
    got = dp_pallas.dp_chain_packed(*ins, band, 2500, 300, 20, E)
    assert dp_pallas.LAUNCHES["dp_chain_packed"] == n0 + 1
    want = dp_pallas.dp_chain_packed_plain(*ins, band, 2500, 300, 20, E)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(((got >> E) & ((1 << E) - 1)).max()) > 3


@pytest.mark.parametrize("band", [12, 20, 31, 32, 64, 83, 125, 200])
def test_dp_chain_packed_kernel_bands(dev, band):
    """The bands of the schedule test (tests/test_torch_dp_schedule.py):
    1 to 7 ring registers, band = 32 * NREG at 32 and 64."""
    L, RC = 256, 203
    rng = np.random.default_rng(band * 7 + 3)
    ins = _dev(synth.padded_dp_case(rng, L, RC, packed=True), dev)
    E = int(np.ceil(np.log2(L)))
    n0 = dp_pallas.LAUNCHES["dp_chain_packed"]
    got = dp_pallas.dp_chain_packed(*ins, band, 2500, 300, 20, E)
    assert dp_pallas.LAUNCHES["dp_chain_packed"] == n0 + 1
    want = dp_pallas.dp_chain_packed_plain(*ins, band, 2500, 300, 20, E)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(((got >> E) & ((1 << E) - 1)).max()) > 3
    assert int(got[:, 0].max()) == L - 1 and int((got[:, 0] >> E).max()) == 0


def test_padded_dp_refuses_wide_rings_on_the_card(dev):
    w = torch.zeros((64, 128), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ring"):
        dp_pallas.dp_chain(w, w, w, 256, 2500, 300, 20)
    with pytest.raises(ValueError, match="ring"):
        dp_pallas.dp_chain_packed(w, w, 256, 2500, 300, 20, 6)


# (R, P, A, G): the default, slow and -c 20 batches' shapes, R past the
# card's 132 SMs, P past 8192 * 128 (the cursor launch samples every
# 256th entry), and a table of fewer rows than R read through a row map
# (G None: apk (R, P), read through the identity map)
_EXPAND = [(5, 4096, 4096, None), (33, 40960, 47104, None),
           (4, 2048, 8192, None), (32, 167936, 192512, None),
           (29, 253952, 288768, None), (150, 8192, 8192, None),
           (4, 1048704, 8192, None),
           (33, 40960, 47104, 16), (150, 16384, 16384, 7)]


@pytest.mark.parametrize("R,P,A,G", _EXPAND)
def test_expand_anchors_kernel_matches_plain(dev, R, P, A, G):
    rng = np.random.default_rng(R + P)
    ins = _dev(synth.expand_case(rng, R, P, A), dev)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    if G is not None:
        table = torch.from_numpy(synth.adversarial_words(rng, (G, P))).to(dev)
        rows_np = rng.integers(0, G, size=R).astype(np.int32)
        rows_np[:4] = [G - 1, 0, -3, G + 2]          # clamped into [0, G)
        rows = torch.from_numpy(rows_np).to(dev)
        ins[2] = table
    n0 = expand_pallas.LAUNCHES["expand_anchors"]
    got = expand_pallas.expand_anchors(*ins, A, rows)
    assert expand_pallas.LAUNCHES["expand_anchors"] == n0 + 1
    want = expand_pallas.expand_anchors_plain(*ins, A, rows)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # row 1's A / 2 positions of two anchors each end inside the table only
    # where P > A / 2: a row whose sources reach the table's last position
    # fills the window clamped there, which counts as running out
    if P > A // 2:
        assert got[2][:4].tolist() == [0, 0, 1, 0]


@pytest.mark.parametrize("name", EXPAND_CASES + EXPAND_OUTSIDE)
def test_expand_anchors_kernel_schedule_cases(dev, name):
    """The schedule emulation's cases (the cursor at its clamp, rows that
    end early or hold nothing, a run-out in the last tile only, windows
    filled to one short of, exactly to and one past their end, run-outs
    over more than 32 tiles; offs above 0, outside the contract) on the
    card: every slot and flag as the plain version gives it."""
    offs, bs, apk, total, A = expand_case(name)
    ins = _dev((offs, bs, apk, total), dev)
    rows = torch.arange(offs.shape[0], dtype=torch.int32, device=dev)
    got = expand_pallas.expand_anchors(*ins, A, rows)
    want = expand_pallas.expand_anchors_plain(*ins, A, rows)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _first_batch(sks, sp, cp, dev, **kw):
    eng = DevicePairEngine(sks, sp, cp, device=dev, **kw)
    n = len(sks)
    _out, meta, _m = eng.plan([(i, j) for i in range(n) for j in range(n)
                               if i != j])
    group = next(eng.groups(meta))
    return eng, eng.batch_args(group, group[0][4]), eng.batch_index(group)


def _cuda_equals_cpu(eng, args, ab, **over):
    args = dict(args, **over)
    got = phase_a(eng.db.arrays, ab, **args).cpu()
    want = phase_a(eng.db.to("cpu").arrays, ab.cpu(), **args)
    assert torch.equal(got, want)
    return got


@pytest.fixture(scope="module")
def contig_set():
    """Four genomes of 300 kb in more than 64 contigs each."""
    gs = synth.genome_set(9, 4, 300_000, copies=(2, 3, 4), n_split=4,
                          contigs=(90, 120), min_len=500)
    assert min(len(g) for g in gs) > 64
    return gs


@pytest.mark.parametrize("c,kw,kernel", [
    (125, {}, "dp_chain_compact_wide"),        # tag packing, band 20
    (70, {}, "dp_chain"),                      # band 35: the padded DP
    (125, {"min_p": (1 << 19) + 4096}, "dp_chain_compact_wide"),
    (125, {"compact_dp": False}, "dp_chain"),
])
def test_phase_a_sorted_tier_cuda_matches_cpu(dev, contig_set, c, kw,
                                              kernel):
    sp, cp = SketchParams(c=c), CommandParams()
    sks = [synth.sketch_parts(p, sp, f"f{i}")
           for i, p in enumerate(contig_set)]
    eng, args, ab = _first_batch(sks, sp, cp, dev, **kw)
    assert eng.gen_mode == "sorted" and args["join_mode"] == "merge"
    n0 = dict(dp_compact.LAUNCHES, **dp_pallas.LAUNCHES)[kernel]
    got = _cuda_equals_cpu(eng, args, ab)
    assert dict(dp_compact.LAUNCHES, **dp_pallas.LAUNCHES)[kernel] == n0 + 1
    assert got.shape[1] == 10 * args["I_CAP"] + 3 * args["C_CAP"] + 3
    assert int(got[:, -1].sum()) == 0 and int(got[:, -2].min()) > 0


@pytest.mark.parametrize("kw,over,kernel", [
    ({"compact_dp": False}, {}, "dp_chain_packed"),    # L_CAP 512
    ({"l_cap": 2048}, {}, "dp_chain"),                 # + wide aggregation
    ({"min_p": (1 << 19) + 4096}, {}, None),           # split gathers
    ({}, {"expand_kernel": True}, "expand_anchors"),
])
def test_phase_a_packed_tier_new_branches_cuda_match_cpu(dev, small_set, kw,
                                                         over, kernel):
    sp, cp, sks, _pairs = small_set
    eng, args, ab = _first_batch(sks, sp, cp, dev, **kw)
    assert eng.gen_mode == "sorted_packed"
    counts = lambda: dict(dp_pallas.LAUNCHES, **expand_pallas.LAUNCHES)
    n0 = counts()
    got = _cuda_equals_cpu(eng, args, ab, **over)
    if kernel:
        assert counts()[kernel] == n0[kernel] + 1
    base = phase_a(eng.db.arrays, ab, **dict(args, compact_dp=True)).cpu()
    if "l_cap" not in kw:
        assert torch.equal(got, base)       # same readback as the default


@pytest.mark.parametrize("c,length", [(125, 300_000), (20, 1_500_000)])
def test_phase_a_legacy_cuda_matches_cpu(dev, c, length):
    """The legacy generator on a DNA database built with mode="legacy",
    with P <= 65536 (packed start pair) and beyond."""
    sp = SketchParams(c=c)
    gs = synth.genome_set(13, 3, length, rates=(0.005, 0.03), n_split=1,
                          contigs=(2, 4))
    sks = [synth.sketch_parts(p, sp, f"l{i}") for i, p in enumerate(gs)]
    db = DeviceDb(sks, dev, mode="legacy")
    assert (db.P <= 65536) == (c == 125)
    ab = torch.tensor([[0, 1, 2, 2], [1, 2, 0, 1]], dtype=torch.int32,
                      device=dev)
    A = max(8192, (int(1.15 * db.max_n_pos) + 2047) // 2048 * 2048)
    args = dict(A=A, I_CAP=256, C_CAP=128, L_CAP=2048, band=min(2500 // c,
                                                                 200),
                fl=20000, pcl=2500, max_gap=300.0, anchor_score=20.0,
                min_anchors=3, min_score=45.0, gen_mode="legacy",
                join_mode="merge")
    n0 = dp_pallas.LAUNCHES["dp_chain"]
    got = phase_a(db.arrays, ab, **args).cpu()
    assert dp_pallas.LAUNCHES["dp_chain"] == n0 + 1
    want = phase_a(db.to("cpu").arrays, ab.cpu(), **args)
    assert torch.equal(got, want)
    assert int(got[:, -2].min()) > 0


def test_engine_many_contigs_cuda_matches_native(dev, contig_set):
    """The `sorted` tier end to end on the card, at the default preset
    (tag packing) and at c=70 (band 35: the padded DP)."""
    for c, kernel in ((125, "dp_chain_compact_wide"), (70, "dp_chain")):
        sp, cp = SketchParams(c=c), CommandParams()
        sks = [synth.sketch_parts(p, sp, f"f{i}")
               for i, p in enumerate(contig_set)]
        pairs = [(i, j) for i in range(4) for j in range(4) if i != j]
        n0 = dict(dp_compact.LAUNCHES, **dp_pallas.LAUNCHES)[kernel]
        eng = DevicePairEngine(sks, sp, cp, device=dev)
        assert eng.gen_mode == "sorted"
        res = eng.run_pairs(pairs)
        assert dict(dp_compact.LAUNCHES, **dp_pallas.LAUNCHES)[kernel] > n0
        for (i, j), r in zip(pairs, res):
            mp = map_params_from_sketch(sks[i], False, cp, None)
            n = chain_seeds_native(sks[i], sks[j], mp)
            for f in ("ani", "align_fraction_query", "align_fraction_ref",
                      "ci_lower"):
                a, b = getattr(r, f), getattr(n, f)
                assert a == b or (np.isnan(a) and np.isnan(b)), (c, i, j, f)


# --- the redesigned wide DPs on the schedule's edge cases ---

@pytest.mark.parametrize("band,l_cap,tag", [
    (20, 256, True), (35, 256, False), (83, 1024, False), (125, 256, False),
    (200, 256, False), (32, 256, False), (64, 512, False), (96, 256, False),
    (160, 256, False), (192, 256, False)])
def test_dp_chain_compact_wide_kernel_edge_streams(dev, band, l_cap, tag):
    """An all-invalid row, a chunk longer than S across two segment
    boundaries, a chunk longer than the halo, equal-score runs and phase
    A's padding tail (synth.dp_stream_wide(edges=True))."""
    rng = np.random.default_rng(band + l_cap)
    ins = _dev(synth.dp_stream_wide(rng, 4, 8192, l_cap, tag=tag,
                                    edges=True), dev)
    args = (band, 2500, 300, 20, l_cap)
    n0 = dp_compact.LAUNCHES["dp_chain_compact_wide"]
    got = dp_compact.dp_chain_compact_wide(*ins, *args)
    assert dp_compact.LAUNCHES["dp_chain_compact_wide"] == n0 + 1
    want = dp_compact.dp_chain_compact_wide_plain(*ins, *args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("band,L,RC", [
    (20, 256, 40), (35, 256, 40), (83, 256, 77), (125, 256, 24),
    (200, 256, 16), (32, 256, 40), (64, 256, 40), (96, 256, 24),
    (160, 256, 16), (192, 256, 16)])
def test_dp_chain_kernel_edge_lanes(dev, band, L, RC):
    """synth.padded_dp_case at the band of each preset: an empty lane, a
    colinear lane of tied candidates, validity holes, contig changes."""
    rng = np.random.default_rng(band + L + RC)
    ins = _dev(synth.padded_dp_case(rng, L, RC), dev)
    got = dp_pallas.dp_chain(*ins, band, 2500, 300, 20)
    want = dp_pallas.dp_chain_plain(*ins, band, 2500, 300, 20)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the microbenchmarks' kernels (scripts/microbench_*.py) by contract ---

@pytest.mark.parametrize("R,K,A,sort", [
    (8, 40960, 4096, False),      # gather_at / gather_matsum / gather_ablate
    (8, 40960, 4096, True),       # mxu_gather_i8 / mxu_gather_bw
    (8, 126208, 4096, False),     # gather_taa / gather_take
    (8, 4096, 4096, False)])      # g_a1 / g_blk (same shape)
def test_row_gather_microbench_contracts(dev, R, K, A, sort):
    rng = np.random.default_rng(K + A)
    table = rng.integers(-(1 << 31), 1 << 31, (R, K),
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, K, (R, A)).astype(np.int32)
    if sort:
        idx = np.sort(idx, axis=1)
    got = gather.row_gather(*_dev([table, idx], dev))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.take_along_axis(table, idx, axis=1))


def test_row_gather_axis0_tile_contract(dev):
    """g_a0: take_along_axis along axis 0 of one (512, 128) tile, through
    the row gather on the transposed tile."""
    rng = np.random.default_rng(512)
    table = rng.integers(-(1 << 31), 1 << 31, (512, 128),
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, 512, (512, 128)).astype(np.int32)
    got = gather.row_gather(*_dev([table.T, idx.T], dev)).T
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.take_along_axis(table, idx, axis=0))


def test_row_scatter_multi_microbench_contract(dev):
    """scatter_pc: two payloads onto unique in-range targets."""
    rng = np.random.default_rng(2)
    R, P, A = 8, 4096, 6144
    tgt = np.stack([rng.permutation(A)[:P] for _ in range(R)]) \
        .astype(np.int32)
    vals = rng.integers(-(1 << 31), 1 << 31, (R, 2, P),
                        dtype=np.int64).astype(np.int32)
    want = np.zeros((R, 2, A), np.int32)
    for r in range(R):
        want[r][:, tgt[r]] = vals[r]
    got = gather.row_scatter_multi(*_dev([tgt, vals], dev), A)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


# --- resident search (reserved rows) and AAI ---

@pytest.mark.parametrize("mode", ["sorted_packed", "sorted", "legacy"])
def test_update_rows_cuda_matches_cpu(dev, small_set, mode):
    """DeviceDb.update_rows on the card writes the CPU database's tables,
    in place (the same storage before and after)."""
    _sp, _cp, sks, _pairs = small_set
    on_dev = DeviceDb(sks[:3], dev, mode=mode)
    on_cpu = DeviceDb(sks[:3], "cpu", mode=mode)
    ptrs = {k: v.data_ptr() for k, v in on_dev.arrays.items()}
    for db in (on_dev, on_cpu):
        db.update_rows([2, 0], [sks[3], sks[4]])
    assert on_dev.max_n_pos == on_cpu.max_n_pos
    for k, v in on_dev.arrays.items():
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(v.cpu(), on_cpu.arrays[k]), k


def _same_results(got, want):
    for g, w in zip(got, want):
        for f in ("ani", "align_fraction_query", "align_fraction_ref",
                  "ci_lower", "ci_upper"):
            a, b = getattr(g, f), getattr(w, f)
            assert a == b or (np.isnan(a) and np.isnan(b)), f


def test_load_slots_then_run_pairs_cuda_matches_fresh_engine(dev,
                                                              small_set):
    """Queries swapped into reserved rows score as an engine built over
    references + queries does, twice over the same rows."""
    sp, cp, sks, _pairs = small_set
    refs = sks[:3]
    eng = DevicePairEngine(refs, sp, cp, device=dev, reserved_slots=2)
    assert eng.join_mode == "merge" and eng.reserved_base == 3
    fresh = DevicePairEngine(sks, sp, cp, device=dev)
    for queries in ((3, 4), (4, 0)):
        slots = [eng.reserved_base, eng.reserved_base + 1]
        assert eng.load_slots(slots, [sks[q] for q in queries])
        got = eng.run_pairs([(r, s) for s in slots for r in range(3)])
        want = fresh.run_pairs([(r, q) for q in queries for r in range(3)])
        _same_results(got, want)


def test_dp_chain_kernel_aai_domain(dev):
    """The padded DP at AAI's domain: per-chunk cap 768, band 500 // 15."""
    rng = np.random.default_rng(768)
    ins = _dev(synth.padded_dp_case(rng, 768, 1024), dev)
    n0 = dp_pallas.LAUNCHES["dp_chain"]
    got = dp_pallas.dp_chain(*ins, 33, 2500, 300, 20)
    assert dp_pallas.LAUNCHES["dp_chain"] == n0 + 1
    want = dp_pallas.dp_chain_plain(*ins, 33, 2500, 300, 20)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_engine_aai_cuda_matches_cpu(dev):
    """A small AAI engine (the legacy generator, per-chunk cap 768) on the
    card gives the CPU run's and the native path's results."""
    from skani_tpu_torch.params import DEFAULT_C_AAI, DEFAULT_K_AAI
    sp = SketchParams(c=DEFAULT_C_AAI, k=DEFAULT_K_AAI, use_aa=True)
    cp = CommandParams()
    gs = synth.genome_set(43, 4, 150_000, rates=(0.01, 0.15), n_split=1,
                          contigs=(2, 3))
    sks = [synth.sketch_parts(p, sp, f"aa{i}") for i, p in enumerate(gs)]
    pairs = [(i, j) for i in range(4) for j in range(4) if i != j]
    n0 = dp_pallas.LAUNCHES["dp_chain"]
    eng = DevicePairEngine(sks, sp, cp, device=dev)
    got = eng.run_pairs(pairs)
    assert eng.gen_mode == "legacy" and eng.L_CAP == 768
    assert dp_pallas.LAUNCHES["dp_chain"] > n0
    _same_results(got, DevicePairEngine(sks, sp, cp,
                                        device="cpu").run_pairs(pairs))
    native = [chain_seeds_native(sks[i], sks[j],
                                 map_params_from_sketch(sks[i], True, cp,
                                                        None))
              for i, j in pairs]
    _same_results(got, native)


def _seed_inputs(seqs, dev):
    from skani_tpu_torch.kernels import seeding
    bases, offs = seeding._flat(seqs)
    return (torch.from_numpy(bases).to(dev), torch.from_numpy(offs).to(dev))


@pytest.mark.parametrize("name", SEED_CASES + ["5mbp"])
def test_seed_batch_kernel_matches_plain(dev, name):
    """The seeding kernels against the plain version on the card, on the
    CPU tests' cases and on a 5 Mbp contig beside short ones (blocks of
    one contig end where the next contig's begin); per contig, the same
    as the native seeder."""
    from skani_tpu_torch import native
    from skani_tpu_torch.kernels import seeding
    if name == "5mbp":
        rng = np.random.default_rng(5)
        big = acgt(rng, 5_000_000)
        big[rng.integers(0, len(big), size=2000)] = ord("N")
        seqs, k, c = [acgt(rng, 300), big, acgt(rng, 700), acgt(rng, 41)], \
            15, 125
    else:
        seqs, k, c = seed_case(name)
    sp = SketchParams(c=c, k=k)
    bases, offs = _seed_inputs(seqs, dev)
    n0 = seeding.LAUNCHES["fmh_seeds"]
    got = seeding.seed_batch(bases, offs, k, c, sp.marker_c)
    assert seeding.LAUNCHES["fmh_seeds"] == n0 + 1
    want = seeding.seed_batch_plain(bases, offs, k, c, sp.marker_c)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    per = seeding.fmh_seeds_device_batch(seqs, sp, device=dev)
    for s, res in zip(seqs, per):
        for g, w in zip(res, native.fmh_seeds_native(s, sp)):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("shape", ["waves", "256m"])
def test_seed_batch_kernel_large_shapes(dev, shape):
    """The redesigned seeding kernels past one wave of blocks (300 contigs
    of 2 kb to 400 kb, about 6000 blocks of 8192 windows, misaligned
    starts) and at the route's window of 256 M bases (1024 contigs,
    lowercase, N runs, IUPAC bytes), against the plain version on the
    card."""
    from skani_tpu_torch.kernels import seeding
    rng = np.random.default_rng(12 if shape == "waves" else 13)
    if shape == "waves":
        lens = rng.integers(2000, 400_000, size=300)
    else:
        lens = np.full(1024, (256 << 20) // 1024) \
            + rng.integers(-5000, 5000, size=1024)
    bases = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=int(lens.sum()))]
    bases = bases.copy()
    for b, n in zip((ord("N"), ord("n"), ord("R"), ord("y"), ord("U")),
                    (400, 400, 2000, 2000, 2000)):
        at = rng.integers(0, len(bases) - 50, size=n)
        for d in range(int(rng.integers(1, 30))):
            bases[at + d] = b
    bases[rng.integers(0, len(bases), size=len(bases) // 50)] += 32
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    b_, o_ = torch.from_numpy(bases).to(dev), torch.from_numpy(offs).to(dev)
    nb = int(seeding.block_starts(o_)[-1])
    assert nb > 8 * torch.cuda.get_device_properties(0).multi_processor_count
    for k, c in ((15, 125), (16, 30)):
        sp = SketchParams(c=c, k=k)
        got = seeding.seed_batch(b_, o_, k, c, sp.marker_c)
        want = seeding.seed_batch_plain(b_, o_, k, c, sp.marker_c)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        assert len(got[0]) > 0


def test_seed_batch_kernel_no_windows(dev):
    """A batch whose contigs are all shorter than 42 launches nothing and
    gives empty outputs."""
    from skani_tpu_torch.kernels import seeding
    bases, offs = _seed_inputs([acgt(np.random.default_rng(1), n)
                                for n in (0, 10, 41)], dev)
    n0 = seeding.LAUNCHES["fmh_seeds"]
    out = seeding.seed_batch(bases, offs, 15, 125, 1000)
    assert seeding.LAUNCHES["fmh_seeds"] == n0
    assert all(x.numel() == 0 for x in out[:4])
    assert out[4].tolist() == out[5].tolist() == [0] * 4


def test_device_route_native_pass_matches_host_route(dev, tmp_path):
    """The CUDA device route (_device_windows under DeviceSeeder: the
    native parse, the kernels' flat outputs, the native assemble) gives
    the host route's sketches, sketch for sketch, in one window and in a
    window flushed every second genome; every file counts as
    `sketch_native`."""
    from skani_tpu_torch import native, sketch
    from skani_tpu_torch.kernels.seeding import DeviceSeeder
    gs = synth.genome_set(25, 6, 400_000, n_repeats=4, n_split=3,
                          contigs=(2, 40))
    paths = synth.write_genome_set(str(tmp_path), gs)
    sp = SketchParams()
    host = [sketch.sketch_file(p, sp, seeder=native.fmh_seeds_native)
            for p in paths]
    for window_bases in (sketch.DEVICE_SEED_WINDOW_BASES, 700_000):
        before = stats.snapshot()
        got = [sk for w in sketch._device_windows(
            paths, sp, True, DeviceSeeder(dev), None, 4, window_bases)
            for _pi, sk in w]
        assert stats.snapshot().get("sketch_native", 0) \
            - before.get("sketch_native", 0) == len(paths)
        assert [s.file_name for s in got] == [s.file_name for s in host]
        for g, h in zip(got, host):
            assert g.contigs == h.contigs
            for f in ("contig_lengths", "seed_kmers", "seed_starts",
                      "seed_pos", "seed_contig", "seed_canon",
                      "marker_seeds"):
                a, b = getattr(g, f), getattr(h, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_seeding_build_failure_raises(dev, tmp_path, monkeypatch):
    """A kernel source that does not compile makes the CUDA call raise:
    no wrapper carries on with the plain version."""
    from skani_tpu_torch.kernels import _build, seeding
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cu").write_text("this is not CUDA;\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "SO", str(tmp_path / "build" / "x.so"))
    monkeypatch.setattr(_build, "_lib", None)
    bases, offs = _seed_inputs([acgt(np.random.default_rng(2), 5000)], dev)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        seeding.seed_batch(bases, offs, 15, 125, 1000)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        seeding.fmh_seeds_device_batch(
            [acgt(np.random.default_rng(2), 5000)], SketchParams(),
            device=dev)


def test_seeding_launch_failure_raises(dev, monkeypatch):
    """An entry point that returns a CUDA error makes the call raise."""
    from skani_tpu_torch.kernels import _build, seeding

    class Failing:
        def skt_seed_count(self, *a):
            return 9          # cudaErrorInvalidConfiguration

        skt_seed_write = skt_seed_count

    monkeypatch.setattr(_build, "lib", lambda: Failing())
    bases, offs = _seed_inputs([acgt(np.random.default_rng(3), 5000)], dev)
    n0 = seeding.LAUNCHES["fmh_seeds"]
    with pytest.raises(RuntimeError, match="seed_count: CUDA launch failed"):
        seeding.seed_batch(bases, offs, 15, 125, 1000)
    assert seeding.LAUNCHES["fmh_seeds"] == n0


def test_device_seeding_route_on_the_card(dev, tmp_path):
    """Above DEVICE_SEED_MIN_BASES default_seeder takes the card, and
    fastx_to_sketches through it gives the native route's sketches."""
    from skani_tpu_torch import sketch
    from skani_tpu_torch.kernels import seeding
    sp = SketchParams()
    seeder = sketch.default_seeder(sp, sketch.DEVICE_SEED_MIN_BASES)
    assert isinstance(seeder, seeding.DeviceSeeder)
    assert seeder.device.type == "cuda"
    gs = synth.genome_set(8, 4, 300_000, n_split=2, contigs=(2, 6))
    paths = synth.write_genome_set(str(tmp_path), gs)
    n0 = seeding.LAUNCHES["fmh_seeds"]
    got = sketch.fastx_to_sketches(paths, sp, threads=2,
                                   total_bases=sketch.DEVICE_SEED_MIN_BASES)
    assert seeding.LAUNCHES["fmh_seeds"] == n0 + 1
    want = sketch.fastx_to_sketches(paths, sp, threads=2)
    for g, w in zip(got, want):
        for f in ("seed_kmers", "seed_starts", "seed_pos", "seed_contig",
                  "seed_canon", "marker_seeds", "contig_lengths"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_fleet_on_one_card_twice_matches_native(dev, small_set):
    """ShardedPairFleet and ShardedMarkerScreen over ["cuda:0", "cuda:0"]
    (two engines sharing the card) equal the native path and the host
    marker index; the kernels' launch counters see both engines."""
    from skani_tpu_torch import screen
    from skani_tpu_torch.parallel import ShardedMarkerScreen, ShardedPairFleet
    sp, cp, sks, pairs = small_set
    devs = ["cuda:0", "cuda:0"]
    scr = ShardedMarkerScreen(sks, devs)
    host = screen.MarkerIndex(sks)
    for q in sks:
        assert np.array_equal(scr.counts_for(q.marker_seeds),
                              host.counts_for(q.marker_seeds))
    n0 = gather.LAUNCHES["row_gather"]
    for refs, queries, prs in ((sks, sks, pairs),
                               (sks[:3], sks[3:], [(i, j) for i in range(3)
                                                   for j in range(2)])):
        got = ShardedPairFleet(refs, queries, sp, cp,
                               devices=devs).run_pairs(prs)
        native = [chain_seeds_native(refs[i], queries[j],
                                     map_params_from_sketch(refs[i], False,
                                                            cp, None))
                  for i, j in prs]
        _same_results(got, native)
    assert gather.LAUNCHES["row_gather"] > n0


# chip_smoke.py's bench depth (its defaults: 32, 24, 512 and 14 genomes)
_BENCH_DEPTH = {"BENCH_GENOMES": "16", "BENCH_DISTANT_GENOMES": "12",
                "BENCH_SEARCH_GENOMES": "128", "BENCH_CLI_GENOMES": "8"}


def test_bench_torch_on_the_card(dev, monkeypatch, capsys):
    """bench_torch.py's four tiers on the card at the smoke's depth: one
    JSON line, every tier run, no mismatch, pairs on the device in the
    main tier and in the CLI tier's subprocess."""
    import json

    import bench_torch
    for k, v in _BENCH_DEPTH.items():
        monkeypatch.setenv(k, v)
    for k in ("BENCH_TIERS", "BENCH_GENOME_LEN", "SKANI_TPU_EXECUTOR",
              "SKANI_TPU_HOST_WORKERS", "SKANI_TPU_MIN_PAIRS"):
        monkeypatch.delenv(k, raising=False)
    try:
        rc = bench_torch.main([])
    finally:
        bench_torch._ENGINE.clear()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["mismatches"] == 0, out
    assert out["device_only"] > 0 and "error" not in out["main"]
    assert set(out["tiers"]) == {"distant_82_95", "search_decoy",
                                 "cli_triangle"}
    assert not any("error" in t for t in out["tiers"].values())
    assert out["tiers"]["cli_triangle"]["pairs_device"] > 0
    assert out["device"] != "cpu"


def test_mag_scale_demo_on_the_card(dev):
    """The MAG demo at 17 Mbp (past 2^24 positions: the unpacked `sorted`
    generator) through a seed-position table past 2^19 rows (the split
    gathers), both orientations equal to native."""
    from skani_tpu_torch.tools import mag_scale_demo
    n0 = gather.LAUNCHES["row_gather"]
    out = mag_scale_demo.run(17_000_000, 0.02, dev,
                             min_p=(1 << 19) + 4096, log=lambda *_: None)
    assert out["mismatches"] == 0
    assert out["gen_mode"] == "sorted" and out["P"] >= 1 << 19
    assert out["stages"]["warm"]["pairs_overflow"] == 0
    assert gather.LAUNCHES["row_gather"] > n0


def test_profile_host_stage_on_the_card(dev):
    """The first batch of 6 genomes of 150 kb: the Python and the native
    host stage agree on the card's readback, which equals the CPU's."""
    from skani_tpu_torch.tools import profile_host_stage
    from skani_tpu_torch.tools.common import first_batch
    eng, group = first_batch(6, 150_000, dev)
    out = profile_host_stage.profile(eng, group, reps=2)
    assert out["mismatches"] == 0 and out["pairs"] == 15
    want = phase_a(eng.db.to("cpu").arrays, eng.batch_index(group).cpu(),
                   **eng.batch_args(group, group[0][4]))
    assert np.array_equal(out["packed"], want.numpy())
    assert out["dispatch_warm_ms"] >= out["enqueue_warm_ms"] > 0


def test_profile_phase_a_on_the_card(dev):
    """Every stage prefix of the first batch of 6 genomes of 150 kb: the
    card's stage output equals the CPU's, and the full batch launches
    K1-K3."""
    from skani_tpu_torch.tools import profile_phase_a
    from skani_tpu_torch.tools.common import first_batch
    eng, group = first_batch(6, 150_000, dev)
    out = profile_phase_a.profile(eng, group, reps=2)
    args = eng.batch_args(group, group[0][4])
    have = profile_phase_a.stages_for(args, eng.db.P)
    assert [r["stage"] for r in out["stages"]] == have
    full = out["stages"][-1]["launches"]
    assert full["row_gather"] >= 1 and full["row_scatter_multi"] == 1 \
        and full["dp_chain_compact"] == 1
    cpu_db, ab = eng.db.to("cpu").arrays, eng.batch_index(group)
    for stage in have:
        got = profile_phase_a.stage_output(eng.db.arrays, ab, args, stage)
        want = profile_phase_a.stage_output(cpu_db, ab.cpu(), args, stage)
        assert torch.equal(got.cpu(), want), stage


def test_soak_fuzz_on_the_card(dev):
    """Fifteen seconds of the soak from its default seed: every pair equal
    to native."""
    from skani_tpu_torch.tools import soak_fuzz
    out = soak_fuzz.soak(0.25, device=dev, log=lambda *_: None)
    assert out["configs"] >= 1 and out["mismatching_pairs"] == 0


def test_scaling_probe_on_the_card(dev):
    """One and two engines on the one card: counts sum to the pairs and
    every result equals one engine's."""
    from skani_tpu_torch.tools import scaling_probe
    rows = scaling_probe.run(5, 150_000, counts=(1, 2), device=dev,
                             log=lambda *_: None)
    for r in rows:
        assert r["mismatches"] == 0 and sum(r["counts"]) == r["pairs"] == 10
        assert r["device"] != "cpu"
