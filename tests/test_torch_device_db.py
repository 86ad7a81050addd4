"""The DeviceDb's native row pack (csrc/db_pack.cpp through
device_db._pack_rows) against its plain version, device_db._pack_genome:
every table of `build_arrays` and of `DeviceDb.update_rows` equal in bits
and dtype, in every mode, on sketches whose k-mer runs are shuffled,
duplicate (contig, position) seeds, positions and contig ids past 2^31,
empty sketches and reserved rows, and width floors; equal on 1 and 8
threads; the width refusal; the counters `db_pack_native` /
`db_pack_fallback` and the metric that reads them.  No JAX: the JAX
package's tables are held to the port's in tests/test_torch_phase_a.py.
"""
import numpy as np
import pytest

from benchmark import harness
from skani_tpu_torch import SketchParams, native, stats, synth
from skani_tpu_torch.kernels import device_db
from skani_tpu_torch.kernels.device_db import DeviceDb, build_arrays
from skani_tpu_torch.sketch import Sketch

BUILDS = {
    "sorted_packed": dict(mode="sorted_packed"),
    "sorted_packed_dense": dict(mode="sorted_packed",
                                dense_join_budget=64 << 20, band=3),
    "sorted": dict(mode="sorted"),
    "legacy": dict(mode="legacy"),
}


def random_sketch(rng, n_kmers, mean_count=3, n_ctg=6, shuffle=True,
                  duplicates=False, high=False):
    """A CSR sketch laid out as sketch._finalize_sketch makes it, over
    random k-mers; `shuffle` leaves each k-mer's run out of (contig,
    position) order, `duplicates` draws seeds from few (contig, position)
    values, `high` puts half the contig ids past 2^30 (2 * id past 2^31)
    and half the positions past 2^31."""
    kmers = np.unique(rng.integers(0, 2**32 - 1, n_kmers,
                                   dtype=np.uint64)).astype(np.uint32)
    counts = rng.integers(1, 2 * mean_count, len(kmers))
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n = int(starts[-1])
    if duplicates:
        contig = rng.integers(0, 2, n).astype(np.uint32)
        pos = rng.integers(0, max(n // 4, 1), n).astype(np.uint32)
    else:
        flat = rng.choice(n_ctg << 20, n, replace=False)
        contig = (flat >> 20).astype(np.uint32)
        pos = (flat & ((1 << 20) - 1)).astype(np.uint32)
    if high:
        contig[contig % 2 == 1] += np.uint32(3 << 29)
        pos[rng.integers(0, 2, n) == 1] += np.uint32(1 << 31)
    if not shuffle:
        kid = np.repeat(np.arange(len(kmers)), counts)
        order = np.lexsort((pos, contig, kid))
        pos, contig = pos[order], contig[order]
    return Sketch(file_name="r", contig_lengths=np.zeros(n_ctg, np.uint32),
                  seed_kmers=kmers, seed_starts=starts, seed_pos=pos,
                  seed_contig=contig,
                  seed_canon=rng.integers(0, 2, n).astype(bool))


@pytest.fixture(scope="module")
def sketches():
    """Sketched genomes (one in contigs), random sketches of every shape
    above, and empty rows."""
    sp = SketchParams()
    gs = synth.genome_set(41, 3, 60_000, n_split=1, contigs=(2, 5))
    real = [synth.sketch_parts(p, sp, f"g{i}") for i, p in enumerate(gs)]
    rng = np.random.default_rng(42)
    rand = [random_sketch(rng, 1500), random_sketch(rng, 900, shuffle=False),
            random_sketch(rng, 300, duplicates=True),
            random_sketch(rng, 400, high=True),
            random_sketch(rng, 200, mean_count=12)]
    return real[:2] + [Sketch()] + rand + [real[2], Sketch()]


def _plain(monkeypatch):
    """Every row through _pack_genome from here on."""
    monkeypatch.setattr(device_db.native, "dbpack_lib", lambda: None)


def _counted(fn):
    """fn()'s result and the genomes each pack took meanwhile."""
    base = stats.snapshot()
    out = fn()
    now = stats.snapshot()
    return out, tuple(int(now.get(k, 0.0) - base.get(k, 0.0))
                      for k in ("db_pack_native", "db_pack_fallback"))


def _assert_same_tables(got, want):
    assert list(got) == list(want)
    for k, v in got.items():
        w = want[k]
        assert v.dtype == w.dtype and v.shape == w.shape, k
        assert np.array_equal(v, w), k


@pytest.mark.parametrize("floors", [(0, 0), (9000, 20000)])
@pytest.mark.parametrize("build", sorted(BUILDS))
def test_native_build_matches_pack_genome(sketches, monkeypatch, build,
                                          floors):
    kw = dict(BUILDS[build], min_k=floors[0], min_p=floors[1])
    got, counts = _counted(lambda: build_arrays(sketches, threads=3, **kw))
    assert counts == (len(sketches), 0)
    _plain(monkeypatch)
    want, counts = _counted(lambda: build_arrays(sketches, **kw))
    assert counts == (0, len(sketches))
    _assert_same_tables(got, want)
    if build == "sorted_packed_dense":
        assert "gidp" in got
    if floors[1]:
        assert got["kmers"].shape[1] >= 9000
        assert got["skid" if build != "legacy" else "pos"].shape[1] >= 20000


@pytest.mark.parametrize("mode", device_db.MODES)
def test_native_rows_equal_pack_genome_row_by_row(sketches, mode):
    srt = mode != "legacy"
    t = device_db._pack_rows(sketches, 8192, 16384, srt, threads=2)
    for g, s in enumerate(sketches):
        row = device_db._pack_genome(s, 8192, 16384, srt)
        for k, v in t.items():
            assert v[g].dtype == row[k].dtype, k
            assert np.array_equal(v[g], row[k]), (g, k)


@pytest.mark.parametrize("mode", device_db.MODES)
def test_threads_give_equal_tables(sketches, mode):
    many = sketches * 3
    one = build_arrays(many, mode=mode, threads=1)
    _assert_same_tables(build_arrays(many, mode=mode, threads=8), one)


def test_untaken_genomes_fall_back_to_pack_genome(sketches, monkeypatch):
    """Seeds the native pass does not take (a contig column of another
    dtype, a strided view, positions without k-mers) are packed by
    _pack_genome in the same build, beside the native rows."""
    rng = np.random.default_rng(43)
    wide_ctg = random_sketch(rng, 200)
    wide_ctg.seed_contig = wide_ctg.seed_contig.astype(np.int64)
    strided = random_sketch(rng, 200)
    strided.seed_pos = np.repeat(strided.seed_pos, 2)[::2]
    assert not strided.seed_pos.flags.c_contiguous
    no_kmers = Sketch(seed_pos=np.arange(5, dtype=np.uint32),
                      seed_contig=np.zeros(5, np.uint32),
                      seed_canon=np.zeros(5, bool))
    mixed = sketches[:3] + [wide_ctg, strided, no_kmers]
    for mode in device_db.MODES:
        got, counts = _counted(lambda: build_arrays(mixed, mode=mode))
        assert counts == (3, 3)
        with monkeypatch.context() as m:
            _plain(m)
            _assert_same_tables(got, build_arrays(mixed, mode=mode))


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("mode", device_db.MODES)
def test_update_rows_matches_a_fresh_build(sketches, monkeypatch, mode,
                                           plain):
    """Reserved empty rows filled by update_rows equal a fresh build of
    the final sketch list at the same widths, on either pack."""
    refs = sketches[:4]
    db = DeviceDb(refs + [Sketch(), Sketch()], "cpu", mode=mode,
                  min_k=8192, min_p=16384, threads=4)
    new = [sketches[5], sketches[7]]
    if plain:
        _plain(monkeypatch)
    _, counts = _counted(lambda: db.update_rows([5, 4], new))
    assert counts == ((0, 2) if plain else (2, 0))
    fresh = build_arrays(refs + [new[1], new[0]], mode=mode,
                         min_k=db.K, min_p=db.P)
    _assert_same_tables({k: v.numpy() for k, v in db.arrays.items()}, fresh)


@pytest.mark.parametrize("plain", [False, True])
def test_a_sketch_wider_than_the_rows_raises(sketches, monkeypatch, plain):
    db = DeviceDb([Sketch(), Sketch()], "cpu", mode="sorted")
    wide = random_sketch(np.random.default_rng(44), 3000)
    assert len(wide.seed_pos) > db.P
    if plain:
        _plain(monkeypatch)
    before = {k: v.clone() for k, v in db.arrays.items()}
    with pytest.raises(ValueError, match="padded widths"):
        db.update_rows([1], [wide])
    for k, v in db.arrays.items():
        assert np.array_equal(v.numpy(), before[k].numpy()), k
    with pytest.raises(ValueError, match="padded widths"):
        device_db._pack_rows([sketches[3]], 1024, 8192, True)


def test_counters_and_the_perf_line_without_the_library(sketches,
                                                        monkeypatch):
    want = build_arrays(sketches, mode="sorted")
    assert native.dbpack_lib() is not None
    _plain(monkeypatch)
    base = stats.snapshot()
    got, counts = _counted(lambda: build_arrays(sketches, mode="sorted"))
    assert counts == (0, len(sketches))
    _assert_same_tables(got, want)
    assert (f"db_pack[native=0 fallback={len(sketches)}]"
            in stats.driver_report("triangle", 1.0, base))


def _unit(st, ok=True):
    return harness.Unit(wall=1.0, ok=ok, work=1.0, stats=st, spans={},
                        counts={})


def test_native_share_reader():
    read = harness.metric_reader("db_pack_native_share.triangle")
    run = harness.Run(cell="x", seed=1, trace=False, units=[
        _unit({"db_pack_native": 64.0}),
        _unit({"db_pack_native": 62.0, "db_pack_fallback": 2.0}),
        _unit({"db_pack_fallback": 50.0}, ok=False)])
    assert read(run) == pytest.approx(100.0 * 126 / 128)
    run.units = [_unit({"db_pack_s": 1.0})]
    assert read(run) is None
