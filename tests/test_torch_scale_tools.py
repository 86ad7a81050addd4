"""The port's scale demos (skani_tpu_torch/tools/mag_scale_demo.py,
search_scale_demo.py, triangle_scale_demo.py) at a small size on the
CPU, each exact against the native executor, and the port's DeviceDb
upload accounting (kernels/device_db.py UPLOAD_BYTES) against the JAX
DeviceDb's on the same sketches in all three modes.
"""
import json

import numpy as np
import pytest
import torch

from skani_tpu_torch import SketchParams, synth
from skani_tpu_torch.kernels import device_db as tdb
from skani_tpu_torch.tools import (mag_scale_demo, search_scale_demo,
                                   triangle_scale_demo)

torch.set_num_threads(1)

# a seed-position table past 2^19 rows, as a 65 Mbp genome's is
SPLIT_MIN_P = (1 << 19) + 4096


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_mag_scale_demo_split_gather_branch(monkeypatch, capsys):
    """~200 kb genomes through min_p past 2^19: the merge join's split
    gathers (a genome this short stays in the packed mode), both
    orientations equal to native on all five fields."""
    monkeypatch.setenv("BENCH_MAG_LEN", "200000")
    monkeypatch.delenv("BENCH_MAG_DIV", raising=False)
    rc = mag_scale_demo.main(["--device", "cpu", "--min-p",
                              str(SPLIT_MIN_P)])
    out = _last_json(capsys)
    assert rc == 0 and out["mismatches"] == 0
    assert out["gen_mode"] == "sorted_packed"
    assert out["join_mode"] == "merge"
    assert out["P"] >= 1 << 19
    # one orientation on the device, the other its mirror
    warm = out["stages"]["warm"]
    assert warm["pairs_device"] == 1 and warm["pairs_mirrored"] == 1
    assert warm["pairs_overflow"] == 0
    assert out["ani"] > 0.95


@pytest.mark.parametrize("length, modes", [
    (1 << 24, ("sorted",)), (65_000_000, ("sorted",)),
    ((1 << 24) - 65536, ("sorted_packed",)), (200_000, ("sorted_packed",)),
    ((1 << 24) - 1000, ("sorted", "sorted_packed"))])
def test_mag_scale_demo_expected_mode(length, modes):
    assert mag_scale_demo._expected_mode(length) == modes


def test_mag_scale_demo_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mag_scale_demo.run(100_000, 0.02)


def test_search_scale_demo_matches_native(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DB_GENOMES", "16")
    monkeypatch.setenv("BENCH_DB_GENOME_LEN", "30000")
    monkeypatch.delenv("SKANI_SCALE_PHASE", raising=False)
    monkeypatch.delenv("SKANI_TPU_EXECUTOR", raising=False)
    rc = search_scale_demo.main([str(tmp_path), "--device", "cpu"])
    out = _last_json(capsys)
    assert rc == 0 and out["mismatches"] == 0
    assert out["db_genomes"] == 16 and out["genomes_per_s"] > 0
    assert out["cold"]["hits"] == out["warm"]["hits"] \
        == out["native"]["hits"] > 0
    assert out["cold"]["stages"]["page_uploads"] == 1
    assert out["warm"]["stages"]["page_uploads"] == 0
    # once resident, a search uploads only its queries
    assert 0 < out["warm"]["upload_mb"] < out["cold"]["upload_mb"]
    assert out["native"]["upload_mb"] == 0
    assert out["peak_rss_mb"] > 0


def test_search_scale_demo_build_then_search_phase(tmp_path, monkeypatch):
    """SKANI_SCALE_PHASE: `build` makes the DB and needs no device,
    `search` reuses it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = search_scale_demo.run(str(tmp_path), 8, 30000, phase="build",
                                  log=lambda *_: None)
    assert "cold" not in built and built["db_mb"] > 0
    out = search_scale_demo.run(str(tmp_path), 8, 30000, device="cpu",
                                phase="search", log=lambda *_: None)
    assert out["mismatches"] == 0 and out["warm"]["hits"] > 0
    with pytest.raises(ValueError):
        search_scale_demo.run(str(tmp_path), 9, 30000, device="cpu",
                              phase="search", log=lambda *_: None)


def test_triangle_scale_demo_matches_native(monkeypatch, capsys):
    # no host steal-worker: on the CPU they would take every pair
    monkeypatch.setenv("SKANI_TPU_HOST_WORKERS", "0")
    rc = triangle_scale_demo.main(["8", "40000", "--device", "cpu"])
    out = _last_json(capsys)
    assert rc == 0 and out["mismatches"] == 0
    assert out["candidate_pairs"] == 28 and out["rows"] > 0
    assert out["stages"]["pairs_device"] > 0


# --- UPLOAD_BYTES against the JAX DeviceDb ---

@pytest.fixture(scope="module")
def sketches():
    gs = synth.genome_set(31, 5, 60_000, n_repeats=2, n_split=2,
                          contigs=(2, 4), rates=(0.003, 0.03))
    sp = SketchParams()
    return [synth.sketch_parts(p, sp, f"u{i}") for i, p in enumerate(gs)]


# by design the port uploads no n_kmers row (the JAX DeviceDb uploads one
# int32 a genome in every mode) and, in `legacy`, no n_pos row either (a
# genome's positions there are the sum of its kmer counts)
def _port_less(mode, G):
    return 4 * G * (2 if mode == "legacy" else 1)


@pytest.mark.parametrize("mode, budget, band", [
    ("sorted_packed", 0, 0), ("sorted_packed", 512 << 20, 20),
    ("sorted", 0, 0), ("legacy", 0, 0)])
def test_upload_bytes_build_matches_jax(sketches, mode, budget, band):
    jdb = pytest.importorskip("skani_tpu.kernels.device_db")
    j0 = jdb.UPLOAD_BYTES[0]
    jd = jdb.DeviceDb(sketches, mode=mode, dense_join_budget=budget,
                      band=band)
    j_delta = jdb.UPLOAD_BYTES[0] - j0
    t0 = tdb.UPLOAD_BYTES[0]
    td = tdb.DeviceDb(sketches, "cpu", mode=mode, dense_join_budget=budget,
                      band=band)
    t_delta = tdb.UPLOAD_BYTES[0] - t0
    assert set(td.arrays) == set(jd.arrays)
    assert ("gidp" in td.arrays) == bool(budget)
    assert t_delta == sum(v.numel() * v.element_size()
                          for v in td.arrays.values())
    assert t_delta == j_delta - _port_less(mode, len(sketches))
    # a copy between devices uploads nothing
    td.to("cpu")
    assert tdb.UPLOAD_BYTES[0] - t0 == t_delta


@pytest.mark.parametrize("mode", tdb.MODES)
def test_upload_bytes_update_rows_matches_jax(sketches, mode):
    jdb = pytest.importorskip("skani_tpu.kernels.device_db")
    refs, new = sketches[:3], sketches[3:]
    jd = jdb.DeviceDb(refs, mode=mode)
    td = tdb.DeviceDb(refs, "cpu", mode=mode,
                      min_k=jd.K, min_p=jd.P)
    assert (td.K, td.P) == (jd.K, jd.P)
    j0, t0 = jdb.UPLOAD_BYTES[0], tdb.UPLOAD_BYTES[0]
    jd.update_rows([0, 2], new)
    td.update_rows([0, 2], new)
    j_delta = jdb.UPLOAD_BYTES[0] - j0
    t_delta = tdb.UPLOAD_BYTES[0] - t0
    assert t_delta == j_delta > 0
    # the rows' bytes: two genome rows of every table
    assert t_delta == sum(2 * v[0].numel() * v.element_size()
                          for v in td.arrays.values())
    np.testing.assert_array_equal(td.arrays["kmers"].numpy(),
                                  np.asarray(jd.arrays["kmers"]))
