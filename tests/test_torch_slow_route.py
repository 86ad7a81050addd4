"""The port at skani's `--slow` preset (c 30, band 83) on the CPU, against
the benchmark's plain reference: a set with a draft of more than 64
contigs takes the `sorted` generator and the padded DP, and every pair
equals `benchmark/reference` (pipeline.score, same_result, tsv_row), at
the default L_CAP and with L_CAP forced small so that pairs take the
exact per-pair fallback (`pairs_overflow`, the `overflow_fallback` span)
on run_pairs' overflow threads, or in place without them.
The DP route counters (`dp_batches_padded`, `dp_batches_compact`) on
this route and on a `sorted_packed` c 125 set.  The two readers of the
`derep_slow.clustered` cell on canned runs, and the cells
`derep_slow.clustered` and `derep_c125.diverse` end to end at a tiny
size: correct when sound, not correct when a job fails.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

from skani_tpu_torch import cli, stats, synth
from skani_tpu_torch.kernels.device_pipeline import (DevicePairEngine,
                                                     fallback_workers)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import genomes, harness, run  # noqa: E402
from benchmark.reference import pipeline as refp  # noqa: E402
from benchmark.reference import sketch as refsk  # noqa: E402

torch.set_num_threads(1)

GENOME = {"length_min": 100_000, "length_max": 160_000, "draft_share": 0.5,
          "draft_contigs": [70, 80], "complete_contigs": [1, 4],
          "min_contig": 1000, "repeat_len": 1500,
          # 200 copies of 1.5 kb would cover a genome this small twice
          "repeat_copies": [2, 4, 8, 20]}
SEED = 2 ** 31 + 2207       # past 32 signed bits, as the check's seeds are


def _params(preset):
    """(SketchParams, CommandParams) as `skani triangle --sparse` builds
    them with `preset` ([] or ["--slow"])."""
    ns = cli.build_parser().parse_args(
        ["triangle", "a.fa", "b.fa", "--sparse"] + preset)
    return cli.parse_args_to_params(ns)


def _species(seed, length, n_contigs):
    """Strains of one species base, 0.3-4 % apart, cut as `n_contigs`
    (contigs of at least 500 bases, skani's floor)."""
    base = genomes.species_base(GENOME, seed, length)
    rates = genomes.grid(0.003, 0.04, len(n_contigs))
    return [genomes.derive(seed + 1 + i, base, float(r), n, 500)
            for i, (r, n) in enumerate(zip(rates, n_contigs))]


def _sketches(parts_list, sp):
    """The program's and the reference's sketch of each genome."""
    prog, ref = [], []
    for i, parts in enumerate(parts_list):
        name = f"g{i}"
        prog.append(synth.sketch_parts(parts, sp, name))
        ref.append(refsk.sketch_contigs(
            name, [f"{name}_c{j}" for j in range(len(parts))], parts,
            sp.k, sp.c, sp.marker_c, "cpu"))
    for p, r in zip(prog, ref):
        assert refsk.same_sketch(p, r)
    return prog, ref


@pytest.fixture(scope="module")
def slow_set():
    """Four strains at --slow, one of them a draft of more than 64
    contigs."""
    sp, cp = _params(["--slow"])
    assert sp.c == 30 and not cp.learned_ani
    prog, ref = _sketches(_species(11, 200_000, [100, 1, 3, 2]), sp)
    assert len(prog[0].contigs) > 64
    pairs = [(i, j) for i in range(4) for j in range(4) if i < j]
    rcp = refp.command_params(learned_ani=False)
    want = [refp.score(ref[i], ref[j], rcp) for i, j in pairs]
    return sp, cp, prog, pairs, want


def _run(sp, cp, prog, pairs, **kw):
    """run_pairs on the CPU engine, device rows only; the results and the
    stats deltas."""
    eng = DevicePairEngine(prog, sp, cp, device="cpu", batch=2, **kw)
    before = stats.snapshot()
    got = eng.run_pairs(pairs, host_workers=0)
    return eng, got, harness.stats_delta(stats.snapshot(), before)


def _assert_exact(got, want):
    for g, w in zip(got, want):
        assert refp.same_result(g, w), (g, w)
        assert refp.tsv_row(g) == refp.tsv_row(w)
    # every pair scored and written
    assert all(w.ani > 0.9 and refp.written(w) for w in want)


@pytest.mark.parametrize("py_finalize", [False, True])
def test_slow_route_default_l_cap_is_exact(slow_set, py_finalize):
    sp, cp, prog, pairs, want = slow_set
    eng, got, d = _run(sp, cp, prog, pairs, py_finalize=py_finalize)
    assert eng.gen_mode == "sorted" and eng.L_CAP == 1024
    assert d["dp_batches_padded"] > 0 and "dp_batches_compact" not in d
    assert d["pairs_device"] == len(pairs)
    _assert_exact(got, want)


def _thread_names(monkeypatch):
    """The names of the threads that run each exact overflow row."""
    names = []
    exact = DevicePairEngine._exact_pair

    def spy(self, *a):
        names.append(threading.current_thread().name)
        return exact(self, *a)
    monkeypatch.setattr(DevicePairEngine, "_exact_pair", spy)
    return names


@pytest.mark.parametrize("py_finalize", [False, True])
def test_slow_route_overflow_fallback_is_exact(slow_set, py_finalize,
                                               monkeypatch):
    """L_CAP 64 overflows the chunks of every pair: each takes the exact
    per-pair path inside the `overflow_fallback` span, on run_pairs'
    overflow threads rather than the finalize thread, and still equals
    the reference."""
    sp, cp, prog, pairs, want = slow_set
    names = _thread_names(monkeypatch)
    _eng, got, d = _run(sp, cp, prog, pairs, l_cap=64,
                        py_finalize=py_finalize)
    assert d["pairs_overflow"] == len(pairs)
    assert d["overflow_fallback_s"] > 0
    assert len(names) == len(pairs)
    assert all(n.startswith("overflow_fallback") for n in names), names
    assert d["dp_batches_padded"] > 0 and "dp_batches_compact" not in d
    _assert_exact(got, want)


def test_overflow_rows_without_a_pool_run_in_place(slow_set, monkeypatch):
    """A finalize called with no fallback (the tools' and tests' direct
    calls) scores each overflow row itself, on the calling thread."""
    sp, cp, prog, pairs, want = slow_set
    eng = DevicePairEngine(prog, sp, cp, device="cpu", batch=8, l_cap=64)
    group = next(eng.groups(eng.plan(pairs)[1]))
    packed, _ev, icap, ccap = eng._dispatch_phase_a(group, group[0][4])
    names = _thread_names(monkeypatch)
    out = [None] * len(pairs)
    before = stats.snapshot()
    eng._process_batch_native(group, packed.numpy(), out, icap, ccap)
    d = harness.stats_delta(stats.snapshot(), before)
    assert d["pairs_overflow"] == len(pairs) and d["overflow_fallback_s"] > 0
    assert names == [threading.current_thread().name] * len(pairs)
    _assert_exact([out[item[0]] for item in group],
                  [want[item[0]] for item in group])


def test_a_failed_overflow_row_fails_run_pairs(slow_set, monkeypatch):
    """An exception on an overflow thread surfaces from run_pairs once
    every thread is joined."""
    sp, cp, prog, pairs, _want = slow_set

    def broken(*a, **kw):
        raise RuntimeError("fallback lost")
    monkeypatch.setattr(DevicePairEngine, "_exact_pair", broken)
    with pytest.raises(RuntimeError, match="fallback lost"):
        _run(sp, cp, prog, pairs, l_cap=64)
    assert not any(t.name.startswith("overflow_fallback")
                   for t in threading.enumerate())


@pytest.mark.parametrize("threads, host_workers, cores, want", [
    (8, 2, 8, 4),      # the card's host: -t 8, two steal-workers
    (32, 2, 8, 4),     # -t above the cores counts the cores
    (3, 0, 8, 1),      # skani's default -t 3
    (1, 2, 2, 1),      # never fewer than one
])
def test_fallback_workers(threads, host_workers, cores, want, monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    assert fallback_workers(threads, host_workers) == want


def test_packed_default_route_counts_compact_batches():
    """A `sorted_packed` set at c 125 takes the compact DP: only
    `dp_batches_compact` moves."""
    sp, cp = _params([])
    prog, ref = _sketches(_species(12, 120_000, [1, 3, 2]), sp)
    pairs = [(0, 1), (0, 2), (1, 2)]
    eng, got, d = _run(sp, cp, prog, pairs)
    assert eng.gen_mode == "sorted_packed"
    assert d["dp_batches_compact"] > 0 and "dp_batches_padded" not in d
    rcp = refp.command_params(learned_ani=cp.learned_ani)
    _assert_exact(got, [refp.score(ref[i], ref[j], rcp) for i, j in pairs])


# --- the cell's readers -----------------------------------------------------

def _unit(st, ok=True):
    return harness.Unit(wall=1.0, ok=ok, work=1.0, stats=st, spans={},
                        counts={})


def _canned(*stats_, failed=None):
    units = [_unit(s) for s in stats_]
    if failed is not None:
        units.append(_unit(failed, ok=False))
    return harness.Run(cell="derep_slow.clustered", seed=1, trace=True,
                       units=units)


def test_overflow_fallback_reader():
    read = harness.metric_reader("overflow_fallback_ms_per_job.slow")
    # a value: ms a completed job (a failed job counts nowhere)
    run_ = _canned({"overflow_fallback_s": 0.5, "pairs_overflow": 3},
                   {"overflow_fallback_s": 1.5, "pairs_overflow": 5},
                   failed={"overflow_fallback_s": 100.0})
    assert read(run_) == pytest.approx(1e3)
    # no pair overflowed: 0.0, whether or not the program has the span
    assert read(_canned({"pairs_device": 10.0}, {})) == 0.0
    # no completed job
    assert read(_canned(failed={"overflow_fallback_s": 1.0})) is None
    # pairs overflowed in a program without the span
    assert read(_canned({"pairs_overflow": 2.0})) is None


def test_padded_batch_share_reader():
    read = harness.metric_reader("padded_batch_share.slow")
    assert read(_canned({"dp_batches_padded": 3.0},
                        {"dp_batches_compact": 1.0},
                        failed={"dp_batches_compact": 50.0})) \
        == pytest.approx(75.0)
    assert read(_canned({"dp_batches_compact": 4.0})) == 0.0
    assert read(_canned({"pairs_device": 4.0})) is None
    assert read(_canned()) is None


def test_new_readers_are_in_benchmark_json():
    bench = harness.benchmark_json()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in ("overflow_fallback_ms_per_job.slow",
                 "padded_batch_share.slow"):
        assert listed[name]["workloads"] == ["derep_slow.clustered"]


# --- the cells end to end ---------------------------------------------------

TINY = {
    "derep_slow.clustered": {
        # drafts keep more than 64 contigs: the `sorted` generator
        "config": {"genome": dict(GENOME, draft_contigs=[110, 130],
                                  min_contig=500)},
        "traffic": {"strains_per_species": 6, "sample_per_species": 2}},
    "derep_c125.diverse": {
        "config": {"genome": GENOME},
        "traffic": {"job_genomes": 14, "species_sizes": "1x4, 2x3, 4x1",
                    "sample_per_species": 2, "sample_singletons": 2}},
}


@pytest.fixture
def loaded_before(monkeypatch):
    """The harness's check of forbidden modules, less those that other
    tests of this process loaded before the run (a worker runs several
    test files): what the run itself loads still fails it."""
    before = set(harness.forbidden_modules())
    found = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules",
                        lambda: sorted(set(found()) - before))


def _cell(cell, tmp_path, seconds=1.0, warm_jobs=1):
    over = {"config": TINY[cell]["config"],
            "traffic": dict(TINY[cell]["traffic"], warm_jobs=warm_jobs)}
    return run.run_cell(cell, SEED, seconds, True, device="cpu",
                        workdir=str(tmp_path), cache_dir=str(tmp_path),
                        overrides=over)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_sound_run_is_correct(cell, tmp_path, monkeypatch,
                                   loaded_before):
    # every pair list to the device engine, however short
    monkeypatch.setenv("SKANI_TPU_EXECUTOR", "tpu")
    out = _cell(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["readings"]["scored"] > 0
    assert out["readings"]["screened"] > out["readings"]["scored"]
    if cell == "derep_slow.clustered":
        m = out["metrics"]
        assert m["padded_batch_share.slow"]["value"] == 100.0
        assert m["overflow_fallback_ms_per_job.slow"]["value"] >= 0.0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_failed_job_is_caught(cell, tmp_path, monkeypatch,
                                   loaded_before):
    from skani_tpu_torch import engine

    def broken(*a, **kw):
        raise RuntimeError("job lost")
    monkeypatch.setattr(engine, "triangle", broken)
    out = _cell(cell, tmp_path, seconds=0.2, warm_jobs=0)
    assert out["failed"] >= 1 and not out["correct"]
    assert out["readings"]["errors"][0] == "RuntimeError: job lost"


def test_diverse_design_is_the_same_work_for_every_seed():
    """Every job set of every seed holds the same species sizes, the same
    total length and the same contig-count multiset; a seed changes
    only bases, orders and rates."""
    drv = harness.driver("triangle_jobs_mixed")
    cfg = harness.config("derep_c125")
    tr = harness.workload("derep_c125.diverse")["traffic"]
    seen = set()
    for seed in (1, SEED):
        for design in drv.mixed_design(cfg, tr, seed):
            assert len(design) == 192
            sizes = {}
            for dd in design:
                sizes[dd["species"]] = sizes.get(dd["species"], 0) + 1
            assert sorted(sizes.values(), reverse=True) == \
                [8] * 3 + [4] * 12 + [2] * 24 + [1] * 72
            within = sum(n * (n - 1) // 2 for n in sizes.values())
            assert within == 180
            seen.add((sum(dd["length"] for dd in design),
                      tuple(sorted(dd["n_contigs"] for dd in design))))
    assert len(seen) == 1


def test_diverse_sample_is_drawn_from_the_largest_species_and_singletons():
    drv = harness.driver("triangle_jobs_mixed")

    class Ctx:
        seed = SEED
        traffic = harness.workload("derep_c125.diverse")["traffic"]
        design = drv.mixed_design(harness.config("derep_c125"), traffic,
                                  SEED)
    for job in range(3):
        pick = drv.job_sample(Ctx, job % 2, job)
        design = Ctx.design[job % 2]
        sizes = {}
        for dd in design:
            sizes[dd["species"]] = sizes.get(dd["species"], 0) + 1
        of = [sizes[design[g]["species"]] for g in pick]
        assert sorted(of) == [1] * 4 + [8] * 12
        assert len(set(pick)) == 16
    assert not np.array_equal(drv.job_sample(Ctx, 0, 0),
                              drv.job_sample(Ctx, 0, 2))
