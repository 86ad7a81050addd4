"""CPU tests of the benchmark's harness: the generator, discovery by
name, the metric readers, the trace summary, the frozen DP counts, the
import check and BENCHMARK.json's own shape."""
from __future__ import annotations

import json
import os
import re
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import genomes, harness  # noqa: E402
from benchmark.roofline import dp_counts  # noqa: E402

BENCH = harness.benchmark_json()
CELLS = [w["name"] for w in BENCH["workloads"]]


# --- the generator ---------------------------------------------------------

def _derep(seed):
    cfg = harness.config("derep_c125")
    tr = harness.workload("derep_c125.clustered")["traffic"]
    return cfg, tr, genomes.derep_design(cfg, tr, seed)


def test_derep_design_is_fixed_work_in_a_seeded_order():
    cfg, tr, a = _derep(1)
    _, _, b = _derep(1)
    _, _, c = _derep(2 ** 40 + 3)
    assert a == b
    assert a != c
    n = tr["species_per_job"] * tr["strains_per_species"]
    for sets in (a, c):
        assert len(sets) == tr["job_sets"]
        for s in sets:
            assert len(s) == n
        # every set holds the same bases: equal total length
        totals = [sum(d["length"] for d in s) for s in sets]
        assert len(set(totals)) == 1
    for f in ("length", "rate", "n_contigs"):
        assert sorted(d[f] for s in a for d in s) == \
            sorted(d[f] for s in c for d in s)
    lengths = {d["length"] for s in a for d in s}
    assert min(lengths) >= cfg["genome"]["length_min"]
    assert max(lengths) <= cfg["genome"]["length_max"]
    rates = sorted({d["rate"] for s in a for d in s})
    assert rates[0] >= tr["strain_rate"][0] and \
        rates[-1] <= tr["strain_rate"][1]
    drafts = sum(d["n_contigs"] >= cfg["genome"]["draft_contigs"][0]
                 for s in a for d in s)
    assert drafts == sum(len(s) for s in a) // 2


def test_genomes_have_the_designed_shape():
    cfg, _tr, sets = _derep(5)
    cfg = dict(cfg, genome=dict(cfg["genome"], length_min=60_000,
                                length_max=90_000))
    d = dict(sets[0][0], length=80_000, n_contigs=40)
    parts = genomes.make_genomes(cfg, [d])[0]
    # cuts are drawn; pieces under min_contig are dropped, as skani
    # drops contigs under 500 bases
    assert 0.8 * 80_000 < sum(len(p) for p in parts) <= 80_000
    assert 25 <= len(parts) <= 40
    assert min(len(p) for p in parts) >= cfg["genome"]["min_contig"]
    again = genomes.make_genomes(cfg, [d])[0]
    assert all(np.array_equal(x, y) for x, y in zip(parts, again))
    whole = genomes.make_genomes(cfg, [dict(d, n_contigs=1)])[0]
    base = genomes.species_base(cfg["genome"], d["base_seed"], 80_000)
    diff = (whole[0] != base).mean()
    assert 0.5 * d["rate"] < diff <= d["rate"]


def test_search_design_and_queries():
    cfg = harness.config("search_c125")
    tr = harness.workload("search_c125.place")["traffic"]
    refs = genomes.search_db_design(cfg)
    assert len(refs) == cfg["references"]
    assert len({r["name"] for r in refs}) == len(refs)
    assert refs == genomes.search_db_design(cfg)
    n_gen = cfg["database"]["genera"]
    qs = genomes.query_design(cfg, tr, 77, 3 * n_gen)
    assert len({q["seed"] for q in qs}) == len(qs)
    per_genus = np.bincount([q["ref"]["genus"] for q in qs],
                            minlength=n_gen)
    assert (per_genus == 3).all()
    tail = genomes.query_design(cfg, tr, 77, n_gen, first=2 * n_gen)
    assert tail == qs[2 * n_gen:]
    other = genomes.query_design(cfg, tr, 78, 3 * n_gen)
    assert sorted(q["ref"]["length"] for q in other) == \
        sorted(q["ref"]["length"] for q in qs)


# --- discovery and the contract's shape ------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_name_in_benchmark_json_is_found():
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert harness.config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        wl = harness.workload(w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"]
        assert len(w["why"]) <= 200
        drv = harness.driver(wl["driver"])
        for fn in ("prepare", "setup", "install_spans", "window", "check",
                   "control"):
            assert callable(getattr(drv, fn))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert callable(harness.metric_reader(m["name"]))
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for cell in CELLS:
        names = [m["name"] for m in harness.cell_metrics(
            BENCH, cell, "end_to_end")]
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(BENCH, cell, "per_layer")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "skani_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "skani_tpu.kernels",
                        types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("z"))
    assert harness.forbidden_modules() == ["jaxlib", "skani_tpu"]


def test_run_refuses_without_cuda(monkeypatch, capsys):
    import torch
    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(2 ** 33 + 1),
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


# --- metric arithmetic -----------------------------------------------------

def _unit(wall, ok=True, work=2016.0, stats=None, spans=None, counts=None):
    return harness.Unit(wall=wall, ok=ok, work=work, stats=stats or {},
                        spans=spans or {}, counts=counts or {})


def test_metric_readers_on_canned_runs():
    read = lambda name, run: harness.metric_reader(name)(run)
    tri = harness.Run(cell="derep_c125.clustered", seed=1, trace=True,
                      setup_s=21.5, window_s=10.0)
    st = dict(sketch_s=0.5, screen_s=0.1, db_build_s=1.5, executor_s=2.5,
              pairs_overflow=10)
    cnt = dict(mbp=256.0, genomes=64, pairs_screened=1000)
    tri.units = [_unit(4.0, stats=st, counts=cnt),
                 _unit(4.0, stats=st, counts=cnt),
                 _unit(2.0, ok=False)]
    tri.profile = dict(busy_s=2.5, window_s=10.0,
                       dp=dict(least_s=0.2, device_s=0.8))
    assert read("setup_s", tri) == 21.5
    assert read("triangle_pairs_per_s", tri) == pytest.approx(403.2)
    assert read("sketch_ms_per_mbp.triangle", tri) == \
        pytest.approx(1e3 * 1.0 / 512)
    assert read("screen_ms_per_job.triangle", tri) == pytest.approx(100.0)
    assert read("db_build_ms_per_genome.triangle", tri) == \
        pytest.approx(1e3 * 3.0 / 128)
    assert read("chain_ms_per_pair.triangle", tri) == pytest.approx(1.0)
    assert read("overflow_share.triangle", tri) == pytest.approx(1.0)
    assert read("dp_roofline", tri) == pytest.approx(25.0)
    assert read("device_idle_share.triangle", tri) == pytest.approx(75.0)

    srch = harness.Run(cell="search_c125.place", seed=1, trace=True,
                       window_s=20.0)
    sp = dict(load=0.05, update_rows=0.02, sketch=0.03)
    srch.units = [_unit(0.1 + 0.01 * i, work=1.0, stats=dict(screen_s=0.04),
                        spans=sp) for i in range(99)] + \
        [_unit(5.0, ok=False, work=1.0)]
    assert read("search_queries_per_s", srch) == pytest.approx(99 / 20)
    # nearest rank: the 90th of 100 sorted walls
    assert read("search_query_p90_ms", srch) == pytest.approx(1e3 * 0.99)
    assert read("screen_ms_per_query.search", srch) == pytest.approx(40.0)
    assert read("load_ms_per_query.search", srch) == pytest.approx(50.0)
    assert read("update_rows_ms_per_query.search", srch) == \
        pytest.approx(20.0)
    assert read("sketch_ms_per_query.search", srch) == pytest.approx(30.0)
    assert read("device_idle_share.search", srch) is None
    srch.units = [_unit(0.1, ok=False, work=1.0)] * 10
    assert read("search_query_p90_ms", srch) == pytest.approx(20e3)


class _Ev:
    def __init__(self, name, start, end, device):
        self.name = name
        self.time_range = types.SimpleNamespace(start=start, end=end)
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def test_trace_summary_on_canned_intervals():
    evs = [_Ev("bench:run_pairs", 100, 400, False),
           _Ev("bench:run_pairs", 90, 410, True),
           _Ev("bench:screen", 500, 700, False),
           _Ev("k1", 100, 200, True), _Ev("k2", 150, 250, True),
           _Ev("k1", 300, 320, True), _Ev("memcpy", 800, 900, True)]
    s = harness.summarize_trace(evs, 0, 1000)
    # union: [100, 250] + [300, 320] + [800, 900] = 270 us
    assert s["busy_s"] == pytest.approx(270e-6)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["device_ops"][0] == ["k1", pytest.approx(120e-6)]
    gaps = dict((round(d * 1e6), n) for n, d in s["idle_gaps"])
    # [320, 800]: its middle 560 lies in the screen span
    assert gaps[480] == "screen"
    assert gaps[100] == "outside any span"      # [0, 100]
    assert gaps[50] == "run_pairs"              # [250, 300]


# --- the frozen DP counts --------------------------------------------------

def test_dp_counts_against_a_hand_count():
    import torch
    # one row of 6 columns, valid at 0, 2, 3, 5; band 2: candidates
    # min(2, i) -> 0 + 2 + 2 + 2 = 6
    w1 = torch.tensor([[1, 0, 3, 5, 0, 1]], dtype=torch.int32)
    ops, nbytes = dp_counts.counts("dp_chain_compact",
                                   (w1, w1, w1, 2, 0, 0, 0, 0))
    assert int(ops) == 16 * 6 and nbytes == 4 * 5 * 6
    ops, nbytes = dp_counts.counts("dp_chain_compact_wide",
                                   (w1, w1, w1, w1, 2, 0, 0, 0, 0))
    assert int(ops) == 17 * 6 and nbytes == 4 * 6 * 6
    # the padded layout: lanes are columns, steps rows
    rcv = w1.T.contiguous()
    ops, nbytes = dp_counts.counts("dp_chain", (rcv, rcv, rcv, 2, 0, 0, 0))
    assert int(ops) == 15 * 6 and nbytes == 4 * 5 * 6
    ops, nbytes = dp_counts.counts("dp_chain_packed", (rcv, rcv, 2, 0, 0, 0,
                                                       0))
    assert int(ops) == 16 * 6 and nbytes == 4 * 3 * 6
    p = dp_counts.peaks("NVIDIA H100 80GB HBM3")
    assert dp_counts.least_seconds(1.6727e13, 0, p) == pytest.approx(
        1.0, rel=1e-4)
    assert dp_counts.least_seconds(0, 3.35e12, p) == pytest.approx(1.0)
    assert dp_counts.kernel_kind("void dp_wide_kernel<2>(int const*)") == \
        "dp_chain_compact_wide"
    assert dp_counts.kernel_kind("dp_chain_packed_kernel<1>") == \
        "dp_chain_packed"
    assert dp_counts.kernel_kind("dp_chain_kernel<4>") == "dp_chain"
    assert dp_counts.kernel_kind("void dp_compact_kernel(int const*)") == \
        "dp_chain_compact"
    assert dp_counts.kernel_kind("row_gather_kernel<4, 1024, true>") is None
