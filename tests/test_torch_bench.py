"""bench_torch.py, the port's JAX-free counterpart of bench.py, on the CPU
at a small size: it imports no JAX, its three pair paths equal bench.py's
JAX device and native paths on the same genomes (ANI, both AFs and both
CI bounds, tolerance 0, NaN equal to NaN), its JSON line holds bench.py's
keys, a device failure is a mismatch in every tier and a non-zero exit,
and without CUDA it refuses to run unless told to use the CPU.
"""
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from skani_tpu_torch.kernels.device_pipeline import DevicePairEngine

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

torch.set_num_threads(1)

# the small size: genomes of 60 kb, a search DB of 8 x 30 kb, a CLI
# triangle of 4
SMALL = dict(BENCH_GENOME_LEN="60000", BENCH_GENOMES="5",
             BENCH_DISTANT_GENOMES="5", BENCH_SEARCH_GENOMES="8",
             BENCH_SEARCH_GENOME_LEN="30000", BENCH_CLI_GENOMES="4")

# bench.py's output keys (bench.py:408-418) and its tiers' keys
BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "device_only",
                 "device_only_vs_baseline", "mismatches", "tiers"}
BENCH_PY_TIER_KEYS = {
    "distant_82_95": {"pairs_s_device", "pairs_s_native_1t", "vs_native",
                      "ani_span"},
    "search_decoy": {"db_genomes", "decoy_fraction", "cold_s_per_query",
                     "warm_s_per_query", "hits"},
    "cli_triangle": {"pairs_s_wall", "wall_s", "rows"}}


@pytest.fixture
def small(monkeypatch):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    for k in ("BENCH_TIERS", "SKANI_TPU_EXECUTOR", "SKANI_TPU_HOST_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    bench_torch._ENGINE.clear()
    yield
    bench_torch._ENGINE.clear()


def _fields(r):
    return tuple(float(getattr(r, f)) for f in
                 ("ani", "align_fraction_query", "align_fraction_ref",
                  "ci_lower", "ci_upper"))


def _assert_same(got, want, what):
    assert len(got) == len(want), what
    for k, (a, b) in enumerate(zip(got, want)):
        fa, fb = _fields(a), _fields(b)
        same = all(x == y or (np.isnan(x) and np.isnan(y))
                   for x, y in zip(fa, fb))
        assert same, (what, k, fa, fb)


def test_import_leaves_no_jax_module():
    code = ("import sys, bench_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'skani_tpu' "
            "or m.startswith('skani_tpu.')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_pair_paths_equal_bench_py_jax_and_native(monkeypatch):
    """The same genomes through bench.py (JAX device engine on the CPU,
    host_workers=0, and native) and through bench_torch's default,
    device-only and native paths on the CPU: every pair equal."""
    monkeypatch.setenv("SKANI_TPU_SEEDER", "native")
    bench = importlib.import_module("bench")
    genomes = (bench_torch.make_genomes(3, length=60_000)
               + bench_torch.make_genomes(3, lo=0.05, hi=0.18, seed=29,
                                          length=60_000))
    n = len(genomes)
    pairs = [(i, j) for i in range(n) for j in range(n) if i < j]

    jsk, jparams = bench.sketch_genomes(genomes)
    want_jax = bench.run_pairs_device(jsk, jparams, pairs, host_workers=0,
                                      key="test_torch_bench")
    want_nat = bench.run_pairs_native(jsk, jparams, pairs)
    _assert_same(want_jax, want_nat, "bench.py: JAX device vs native")

    tsk, tparams = bench_torch.sketch_genomes(genomes)
    for a, b in zip(tsk, jsk):
        assert np.array_equal(a.seed_pos, b.seed_pos)
        assert np.array_equal(a.seed_kmers, b.seed_kmers)
    got_nat = bench_torch.run_pairs_native(tsk, tparams, pairs)
    got_best = bench_torch.run_pairs_device(tsk, tparams, pairs,
                                            key="t_best", device="cpu")
    got_dev = bench_torch.run_pairs_device(tsk, tparams, pairs,
                                           host_workers=0, key="t_dev",
                                           device="cpu")
    for what, got in (("native", got_nat), ("default", got_best),
                      ("device only", got_dev)):
        _assert_same(got, want_jax, f"bench_torch {what} vs JAX device")
        _assert_same(got, want_nat, f"bench_torch {what} vs JAX native")
        assert bench_torch.count_mismatches(got, want_jax) == 0
    # the set covers scored pairs and pairs below the ANI floor
    anis = [r.ani for r in want_nat]
    assert any(a > 0.9 for a in anis)
    assert any(not a > 0.8 for a in anis)
    bench_torch._ENGINE.clear()


def test_count_mismatches_compares_all_five_fields():
    from skani_tpu_torch.ani import AniEstResult
    a = AniEstResult(ani=0.99, align_fraction_query=0.8,
                     align_fraction_ref=0.7, ci_lower=0.98, ci_upper=0.995)
    for f in ("ani", "align_fraction_query", "align_fraction_ref",
              "ci_lower", "ci_upper"):
        b = AniEstResult(**{**_kw(a), f: getattr(a, f) - 0.01})
        assert bench_torch.count_mismatches([a], [b]) == 1, f
    nan = AniEstResult(**{**_kw(a), "ani": float("nan")})
    assert bench_torch.count_mismatches([nan], [nan]) == 0
    assert bench_torch.count_mismatches([a], [nan]) == 1
    assert bench_torch.count_mismatches([a, a], [a]) == 1


def _kw(r):
    return {f: getattr(r, f) for f in
            ("ani", "align_fraction_query", "align_fraction_ref",
             "ci_lower", "ci_upper")}


def test_main_cpu_prints_bench_py_keys(small, capsys):
    rc = bench_torch.main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert rc == 0
    assert out["mismatches"] == 0
    assert BENCH_PY_KEYS <= set(out)
    for tier, keys in BENCH_PY_TIER_KEYS.items():
        assert keys <= set(out["tiers"][tier]), tier
    assert out["device"] == "cpu"
    assert out["device_only"] > 0 and out["value"] > 0
    assert out["pairs_overflow"] is not None and out["db_build_s"] > 0
    for run in out["main"]["stages"]["device_only"]:
        assert run["pairs_device"] + run["pairs_mirrored"] > 0
        assert run["pairs_host"] == 0
    s = out["tiers"]["search_decoy"]
    for k in ("load_s", "page_uploads", "pairs_slots_refused", "upload_mb",
              "native_s_per_query"):
        assert k in s, k
    # the cold search uploads its page, the warm one only the queries
    assert s["page_uploads"] == {"cold": 1, "warm": 0}
    assert 0 < s["upload_mb"]["warm"] < s["upload_mb"]["cold"]
    c = out["tiers"]["cli_triangle"]
    assert c["tsv_identical"] and c["rows"] > 0 and c["pairs_device"] > 0
    assert c["pairs_s_wall_native"] > 0


def test_device_failure_is_a_mismatch_in_every_tier(small, monkeypatch,
                                                     capsys):
    def boom(self, pairs, host_workers=None):
        raise RuntimeError("device failed")

    monkeypatch.setattr(DevicePairEngine, "run_pairs", boom)
    rc = bench_torch.main(["--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc != 0
    assert "error" in out["main"]
    for tier in ("distant_82_95", "search_decoy", "cli_triangle"):
        assert "error" in out["tiers"][tier], tier
    assert out["mismatches"] == 4


def test_main_without_cuda_raises(small, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_torch.main([])
