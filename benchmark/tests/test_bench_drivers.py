"""Both drivers end to end at a tiny size on the CPU (the program's plain
kernel versions): a sound run comes out correct, with the result line's
exact keys; a run with the timed path broken underneath comes out not
correct, once for each fault the cells can have; the control (the
reference in float32 in the program's place) comes out not correct."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control, run  # noqa: E402

GENOME = {"length_min": 150_000, "length_max": 250_000, "draft_share": 0.5,
          "draft_contigs": [70, 90], "complete_contigs": [1, 4],
          "min_contig": 1000, "repeat_len": 1500,
          "repeat_copies": [2, 4, 8, 200]}
TINY = {
    "derep_c125.clustered": {
        "config": {"genome": GENOME},
        "traffic": {"strains_per_species": 6, "sample_per_species": 3,
                    "warm_jobs": 1}},
    "search_c125.place": {
        "config": {"genome": GENOME,
                   "database": {"db_seed": 1, "genera": 4,
                                "species_per_genus": 4,
                                "species_rate": [0.02, 0.04]}},
        "traffic": {"warm_calls": 1, "calls_checked": 2,
                    "other_refs": 3}},
}
SEED = 2 ** 31 + 12345      # past 32 signed bits, as the check's seeds are


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def _run(cell, tmp_path, cache, trace=False, seconds=2.0):
    return run.run_cell(cell, SEED, seconds, trace, device="cpu",
                        workdir=str(tmp_path), cache_dir=cache,
                        overrides=TINY[cell])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell, tmp_path, cache):
    out = _run(cell, tmp_path, cache, trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "readings", "checks"]
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["readings"]["scored"] > 0
    assert out["readings"]["screened"] > out["readings"]["scored"]
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit"}
    # per-layer metrics that need no device trace are read on the CPU
    assert out["metrics"]
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}


def _fault(kind):
    """A context that breaks the timed path underneath the harness."""
    from skani_tpu_torch import engine, screen
    from skani_tpu_torch.kernels import device_pipeline as dp
    saved = []

    def patch(owner, attr, make):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, make(getattr(owner, attr)))

    if kind == "answer_altered":
        def make(fn):
            def bad(self, pairs, *a, **kw):
                res = fn(self, pairs, *a, **kw)
                for r in res:
                    r.ani = float(np.float32(r.ani) * np.float32(1.0001))
                return res
            return bad
        patch(dp.DevicePairEngine, "run_pairs", make)
    elif kind == "half_the_batch_left_out":
        def make(fn):
            def bad(self, pairs, *a, **kw):
                res = fn(self, pairs, *a, **kw)
                for r in res[::2]:
                    r.ani = float("nan")
                return res
            return bad
        patch(dp.DevicePairEngine, "run_pairs", make)
    elif kind == "seed_altered":
        def make(fn):
            def bad(*a, **kw):
                out = fn(*a, **kw)
                for sk in out:
                    sk.seed_pos = sk.seed_pos.copy()
                    sk.seed_pos[0] += 1
                return out
            return bad
        patch(engine, "fastx_to_sketches", make)
    elif kind == "screen_dropped":
        def make(fn):
            def bad(*a, **kw):
                return list(fn(*a, **kw))[::2]
            return bad
        patch(screen, "screen_refs", make)
        patch(engine, "_screen_query", make)
    elif kind == "screen_widened":
        # every reference passes the screen: pairs of unrelated genomes
        # are scored beside the sound ones
        def make_rows(fn):
            def bad(identity, index, *a, **kw):
                fn(identity, index, *a, **kw)
                return np.arange(index.n_sketches)
            return bad

        def make_query(fn):
            def bad(q, ref_sketches, *a, **kw):
                fn(q, ref_sketches, *a, **kw)
                return list(range(len(ref_sketches)))
            return bad
        patch(screen, "screen_refs", make_rows)
        patch(engine, "_screen_query", make_query)

    class Ctx:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            for owner, attr, orig in reversed(saved):
                setattr(owner, attr, orig)
    return Ctx()


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("kind", ["answer_altered", "half_the_batch_left_out",
                                  "seed_altered", "screen_dropped",
                                  "screen_widened"])
def test_broken_timed_path_is_not_correct(cell, kind, tmp_path, cache):
    with _fault(kind):
        out = _run(cell, tmp_path, cache)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell, tmp_path, cache):
    r = control.control_readings(cell, SEED, "cpu", str(tmp_path), cache,
                                 TINY[cell])
    assert r["seeds_off"] == 0 and r["screen_off"] == 0
    assert r["pairs_off"] > 0


def test_no_line_where_a_metric_reader_loads_the_jax_package(
        monkeypatch, tmp_path, capsys, cache):
    """A module named skani_tpu loaded after the window, here by a metric
    reader, leaves the run without a result."""
    import torch
    from benchmark import harness
    cell = "derep_c125.clustered"
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "skani_tpu.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    monkeypatch.delitem(sys.modules, "skani_tpu", raising=False)
    sound = harness.metric_reader

    def loading_reader(name):
        read = sound(name)

        def wrapped(r):
            import skani_tpu  # noqa: F401
            return read(r)
        return wrapped

    orig_run_cell = run.run_cell
    monkeypatch.setattr(harness, "metric_reader", loading_reader)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(
        run, "run_cell", lambda c, seed, seconds, trace: orig_run_cell(
            c, seed, seconds, trace, device="cpu",
            workdir=str(tmp_path / "work"), cache_dir=cache,
            overrides=TINY[c]))
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "skani_tpu" in out.err
    monkeypatch.delitem(sys.modules, "skani_tpu", raising=False)
