#!/usr/bin/env python3
"""skani_tpu_torch benchmark: genome-pairs/s plus regression tiers, on
the card (PyTorch/CUDA; imports no JAX).

    python3 bench_torch.py [--device cuda|cpu]

Tiers (BENCH_TIERS env, default all; the main tier always runs):

* **main** — BENCH_GENOMES (32) genomes point-mutated at 0.3-2 % from one
  synthetic E. coli-scale source (BENCH_GENOME_LEN, 5 Mbp; see
  skani_tpu_torch/tools/common.py source_genome), all UNIQUE unordered
  pairs (the `triangle` workload): the engine's default path (device plus
  host steal-workers), the device only (host_workers=0) and the
  single-thread native path, each best of 2.  Unique pairs are the honest
  accounting: the engine computes mirrored orientations by swapping the
  fields of one result, which the reference's triangle command
  (src/triangle.rs:71-105) gets for free too.
* **distant** — a star: one ancestor and BENCH_DISTANT_GENOMES - 1 (23)
  mutants at 5-18 % (82-95 % ANI, the edge of the reference's stated
  accuracy envelope, README.md:135-137), scored ancestor against mutant:
  23 pairs at the defaults.  Sparse anchors and low AF exercise what the
  main tier's near-identical pairs never touch.
* **search** — a consolidated `sketch` database of BENCH_SEARCH_GENOMES
  (512) genomes of BENCH_SEARCH_GENOME_LEN (150 kb), 3/4 of them random
  decoys the marker screen must reject, searched by 3 queries through the
  real `engine.search` (marker screening, lazy loads, device-resident
  pages; reference: src/search.rs): cold (pages uploaded), warm
  (resident) and under the native executor.
* **cli** — the whole `triangle` CLI command (sketching, screening,
  chaining, sparse write) of BENCH_CLI_GENOMES (14) genomes as a
  subprocess, under the default executor (the card) and under
  SKANI_TPU_EXECUTOR=native at `-t` = cores; the TSVs must be
  byte-identical.  On `--device cpu` the device run goes in process
  through the device engine on the CPU.

Baseline: the single-thread native C++ per-pair pipeline, which
implements the reference algorithm exactly.  vs_baseline is the default
path's rate over it.

Prints ONE JSON line; the headline keys are the main tier's, the other
tiers nest under "tiers".  A pair counts as a mismatch unless ANI, both
AFs and both CI bounds are equal (NaN equal to NaN); a tier that raises
counts as one.  The exit code is 1 when "mismatches" is not 0.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from skani_tpu_torch import (CommandParams, SketchParams, engine, stats,
                             synth, map_params_from_sketch)
from skani_tpu_torch.kernels.device_pipeline import (DevicePairEngine,
                                                     resolve_device)
from skani_tpu_torch.params import Mode
from skani_tpu_torch.sketch import Sketch, _finalize_sketch, default_seeder
from skani_tpu_torch.tools.common import (card, drop_resident, environ,
                                          rows_key, same_result,
                                          search_genomes, source_genome,
                                          stages, timed_search)

TIERS_DEFAULT = "main,distant,search,cli"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def make_genomes(n, lo=0.003, hi=0.02, seed=7, length=None):
    """n mutants of the source genome (BENCH_GENOME_LEN bases unless
    `length`) at rates spread linearly over [lo, hi]."""
    seq = source_genome(length or _env_int("BENCH_GENOME_LEN", 5_000_000))
    rng = np.random.default_rng(seed)
    genomes = []
    for i in range(n):
        rate = lo + (hi - lo) * (i / max(n - 1, 1))
        genomes.append((f"mut_{i}", synth.mutate(rng, seq, rate)))
    return genomes


def sketch_genomes(genomes):
    """One single-contig sketch a genome, seeded on the host."""
    params = SketchParams()
    seeder = default_seeder(params)
    out = []
    for name, seq in genomes:
        sk = Sketch(file_name=name, marker_c=params.c, c=params.c,
                    k=params.k)
        sk.contigs = [name]
        sk.contig_lengths = np.array([len(seq)], dtype=np.uint32)
        sk.total_sequence_length = len(seq)
        km, po, ca, ma = seeder(seq, params)
        _finalize_sketch(sk, [km], [po], [ca],
                         [np.zeros(len(km), dtype=np.uint32)], [ma])
        out.append(sk)
    return out, params


def run_pairs_native(sketches, params, pairs):
    from skani_tpu_torch.ani import chain_seeds_native
    cp = CommandParams()
    res = []
    for i, j in pairs:
        mp = map_params_from_sketch(sketches[i], False, cp, None)
        res.append(chain_seeds_native(sketches[i], sketches[j], mp))
    return res


_ENGINE = {}


def run_pairs_device(sketches, params, pairs, host_workers=None,
                     key="eng", device=None):
    """Device pipeline (engine cached across reps, like the CLI path);
    host_workers=None is the engine's default of host steal-workers."""
    dev = resolve_device(device)
    eng = _ENGINE.get(key)
    if eng is None or eng.device != dev \
            or len(eng.sketches) != len(sketches) \
            or any(a is not b for a, b in zip(eng.sketches, sketches)):
        _ENGINE.pop(key, None)
        eng = DevicePairEngine(sketches, params, CommandParams(), device=dev)
        _ENGINE[key] = eng
    return eng.run_pairs(pairs, host_workers=host_workers)


def count_mismatches(res_a, res_b):
    """Pairs whose results differ in ANI, an AF or a CI bound (NaN equal
    to NaN); a missing result counts too."""
    return (sum(not same_result(a, b) for a, b in zip(res_a, res_b))
            + abs(len(res_a) - len(res_b)))


def _best_of(fn, reps=2):
    """(best wall, last result, the stage deltas and wall of each rep)."""
    best, res, runs = float("inf"), None, []
    for _rep in range(reps):
        s0 = stats.snapshot()
        t0 = time.time()
        res = fn()
        dt = time.time() - t0
        runs.append(dict(stages(s0), wall_s=dt))
        best = min(best, dt)
    return best, res, runs


def tier_main(device):
    """The headline tier: all unique pairs of BENCH_GENOMES mutants at
    0.3-2 %, the default path, the device only and native, best of 2."""
    n = _env_int("BENCH_GENOMES", 32)
    t0 = time.time()
    genomes = make_genomes(n)
    sketches, params = sketch_genomes(genomes)
    pairs = [(i, j) for i in range(n) for j in range(n) if i < j]
    prep_s = time.time() - t0

    # warm-up on a small subset, excluded from timing: it builds the
    # engine (the DeviceDb upload) and makes the first launches
    s0 = stats.snapshot()
    run_pairs_device(sketches, params, pairs[:4], device=device)
    warm = stages(s0)

    best_s, res_best, runs_best = _best_of(
        lambda: run_pairs_device(sketches, params, pairs, device=device))
    best_rate = len(pairs) / best_s
    # device-ONLY throughput (no host steal-workers): the accelerator's
    # own number, reported beside the default path
    dev_s, res_dev, runs_dev = _best_of(
        lambda: run_pairs_device(sketches, params, pairs, host_workers=0,
                                 device=device))
    dev_rate = len(pairs) / dev_s
    base_s, res_base, _ = _best_of(
        lambda: run_pairs_native(sketches, params, pairs))
    base_rate = len(pairs) / base_s

    mism = (count_mismatches(res_best, res_base)
            + count_mismatches(res_dev, res_base))
    sys.stderr.write(
        f"# {len(pairs)} pairs of {n} E.coli-scale genomes; "
        f"prep {prep_s:.1f}s; best {best_s:.2f}s ({best_rate:.1f}/s); "
        f"device-only {dev_s:.2f}s ({dev_rate:.1f}/s); "
        f"single-thread-reference {base_s:.2f}s ({base_rate:.1f}/s); "
        f"mismatches {mism}\n")
    return {
        "value": round(best_rate, 2),
        "vs_baseline": round(best_rate / base_rate, 3),
        "device_only": round(dev_rate, 2),
        "device_only_vs_baseline": round(dev_rate / base_rate, 3),
        "genomes": n, "pairs": len(pairs), "prep_s": prep_s,
        "best_s": best_s, "device_only_s": dev_s, "native_1t_s": base_s,
        "pairs_overflow": runs_dev[-1]["pairs_overflow"],
        "db_build_s": warm["db_build_s"],
        "stages": {"best": runs_best, "device_only": runs_dev},
    }, mism


def tier_distant(device):
    """82-95 %-ANI tier: a star of one ancestor and BENCH_DISTANT_GENOMES
    - 1 mutants at 5-18 %, scored ancestor against mutant (23 pairs at
    the defaults).  Sparse anchors and low AF exercise the domains the
    main tier's near-identical mutants never touch."""
    n = _env_int("BENCH_DISTANT_GENOMES", 24)
    # mutant-vs-mutant pairs would sum both rates and fall below the 82 %
    # envelope, so each pair's divergence is the mutant's own rate
    genomes = (make_genomes(1, lo=0.0, hi=0.0, seed=23)
               + make_genomes(n - 1, lo=0.05, hi=0.18, seed=29))
    sketches, params = sketch_genomes(genomes)
    pairs = [(0, j) for j in range(1, n)]

    # the first rep builds the engine: best of 2 keeps the second
    dev_s, res_dev, runs = _best_of(
        lambda: run_pairs_device(sketches, params, pairs, host_workers=0,
                                 key="distant", device=device))
    t0 = time.time()
    res_base = run_pairs_native(sketches, params, pairs)
    base_s = time.time() - t0

    mism = count_mismatches(res_dev, res_base)
    # the tier really covers the 82-95 envelope (nulled results, ani <= 0,
    # are left out of the span but still compared above)
    anis = sorted(r.ani for r in res_base
                  if not np.isnan(r.ani) and r.ani > 0)
    dev_rate = len(pairs) / dev_s
    base_rate = len(pairs) / base_s
    sys.stderr.write(
        f"# distant tier: {len(pairs)} pairs, ANI span "
        f"{anis[0] * 100 if anis else 0:.1f}-"
        f"{anis[-1] * 100 if anis else 0:.1f}; device {dev_rate:.1f}/s "
        f"native {base_rate:.1f}/s; mismatches {mism}\n")
    return {
        "pairs_s_device": round(dev_rate, 2),
        "pairs_s_native_1t": round(base_rate, 2),
        "vs_native": round(dev_rate / base_rate, 3) if base_rate else 0.0,
        "ani_span": [round(anis[0] * 100, 2) if anis else None,
                     round(anis[-1] * 100, 2) if anis else None],
        "pairs": len(pairs),
        "pairs_overflow": runs[-1]["pairs_overflow"],
        "db_build_s": runs[0]["db_build_s"],
        "stages": runs,
    }, mism


def tier_search(device):
    """Search-shaped tier through the REAL search entry point: 3/4 decoys the
    marker screen must reject, a consolidated DB, cold then warm
    (device-resident) searches of 3 queries, then the same search on the
    native executor.  Reference workload: src/search.rs + README.md:15."""
    n = _env_int("BENCH_SEARCH_GENOMES", 512)
    glen = _env_int("BENCH_SEARCH_GENOME_LEN", 150000)
    seq = source_genome(_env_int("BENCH_GENOME_LEN", 5_000_000))[:glen]
    work = tempfile.mkdtemp(prefix="skani_bench_search_")
    try:
        gdir = os.path.join(work, "genomes")
        dbdir = os.path.join(work, "db")
        os.makedirs(gdir)
        paths = search_genomes(gdir, seq, n)
        n_rel = n // 4

        sp = SketchParams()
        t0 = time.time()
        engine.sketch(CommandParams(mode=Mode.SKETCH, out_file_name=dbdir,
                                    ref_files=paths,
                                    threads=os.cpu_count() or 1), sp)
        db_sketch_s = time.time() - t0
        queries = paths[:2] + paths[-1:]

        def one_search(tag):
            dt, res, st = timed_search(
                dbdir, queries, os.path.join(work, f"s_{tag}.tsv"), device)
            return dt / len(queries), res, dict(st, wall_s=dt)

        try:
            cold_q, res_cold, st_cold = one_search("cold")
            warm_q, res_warm, st_warm = one_search("warm")
        finally:
            drop_resident(dbdir)
        with environ(SKANI_TPU_EXECUTOR="native"):
            nat_q, res_nat, st_nat = one_search("native")
        # warm must agree with cold (same entry point, same DB) and with the
        # native executor, row for row on all five fields
        mism = int(rows_key(res_cold) != rows_key(res_warm)) \
            + int(rows_key(res_warm) != rows_key(res_nat))
        sys.stderr.write(
            f"# search tier: {n}-genome DB ({n - n_rel} decoys), "
            f"{len(queries)} queries; cold {cold_q:.2f} s/q, warm "
            f"{warm_q:.2f} s/q, native {nat_q:.2f} s/q, {len(res_warm)} "
            f"hits; mismatches {mism}\n")
        return {
            "db_genomes": n,
            "decoy_fraction": round(1 - n_rel / n, 3),
            "cold_s_per_query": round(cold_q, 3),
            "warm_s_per_query": round(warm_q, 3),
            "hits": len(res_warm),
            "native_s_per_query": nat_q,
            "db_sketch_s": db_sketch_s,
            "load_s": {"cold": st_cold["load_s"], "warm": st_warm["load_s"]},
            "pages": st_cold["search_pages"],
            "page_uploads": {"cold": st_cold["page_uploads"],
                             "warm": st_warm["page_uploads"]},
            "pairs_slots_refused": st_cold["pairs_slots_refused"]
            + st_warm["pairs_slots_refused"],
            "upload_mb": {"cold": st_cold["upload_mb"],
                          "warm": st_warm["upload_mb"]},
            "stages": {"cold": st_cold, "warm": st_warm, "native": st_nat},
        }, mism
    finally:
        shutil.rmtree(work, ignore_errors=True)


_PERF = re.compile(r"pairs\[device=(\d+) host=(\d+) mirrored=(\d+) "
                   r"overflow=(\d+)\]")


def _cli(argv, env):
    """`python -m skani_tpu_torch <argv>` in this checkout: (wall, rc,
    stderr)."""
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "skani_tpu_torch", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=1800)
    return time.time() - t0, r.returncode, r.stderr


def tier_cli_triangle(device):
    """Whole-command CLI triangle: sketching, screening, chaining and the
    sparse write, as a user runs it, under the default executor (the
    card) and under SKANI_TPU_EXECUTOR=native, each at `-t` = cores; the
    two TSVs must be byte-identical.  Catches regressions outside the pair
    engine (parsing, writers, orchestration).  The CLI takes no device, so
    on a CPU device the device run goes in process through the device
    engine on that device."""
    n = _env_int("BENCH_CLI_GENOMES", 14)
    genomes = make_genomes(n, lo=0.003, hi=0.02, seed=41)
    work = tempfile.mkdtemp(prefix="skani_bench_cli_")
    try:
        paths = [synth.write_fasta(os.path.join(work, f"{name}.fa"), name,
                                   [s]) for name, s in genomes]
        cores = str(os.cpu_count() or 1)

        def argv(out):
            return ["triangle", *paths, "-o", out, "--sparse", "-t", cores]

        out_dev = os.path.join(work, "tri.tsv")
        out_nat = os.path.join(work, "tri_native.tsv")
        pairs_device = overflow = None
        if device.type == "cuda":
            env = dict(os.environ)
            env.pop("SKANI_TPU_EXECUTOR", None)
            env.pop("SKANI_TPU_HOST_WORKERS", None)
            wall, rc, err = _cli(argv(out_dev), env)
            m = _PERF.search(err)
            if m:
                pairs_device, overflow = int(m.group(1)), int(m.group(4))
        else:
            from skani_tpu_torch import cli
            from skani_tpu_torch.kernels.pipeline import torch_pair_executor
            sp, cp = cli.parse_args_to_params(
                cli.build_parser().parse_args(argv(out_dev)))
            s0 = stats.snapshot()
            t0 = time.time()
            engine.triangle(cp, sp, executor=torch_pair_executor(
                device=device))
            wall, rc, err = time.time() - t0, 0, ""
            st = stages(s0)
            pairs_device = int(st["pairs_device"])
            overflow = int(st["pairs_overflow"])
        wall_nat, rc_nat, err_nat = _cli(
            argv(out_nat), dict(os.environ, SKANI_TPU_EXECUTOR="native"))
        n_pairs = n * (n - 1) // 2
        rows = identical = 0
        if rc == 0 and rc_nat == 0 and os.path.exists(out_dev) \
                and os.path.exists(out_nat):
            with open(out_dev, "rb") as f:
                got = f.read()
            with open(out_nat, "rb") as f:
                want = f.read()
            rows = max(0, len(got.splitlines()) - 1)
            identical = got == want
        ok = rc == 0 and rc_nat == 0 and rows > 0 and identical
        if not ok:
            sys.stderr.write(err[-2000:] + err_nat[-2000:])
        sys.stderr.write(
            f"# cli tier: triangle over {n} genomes ({n_pairs} pairs): "
            f"device {wall:.1f}s wall ({n_pairs / wall:.1f} pairs/s incl. "
            f"sketching, {pairs_device} pairs on the device), native "
            f"{wall_nat:.1f}s ({n_pairs / wall_nat:.1f} pairs/s), {rows} "
            f"rows, identical {bool(identical)}, rc={rc}/{rc_nat}\n")
        return {
            "pairs_s_wall": round(n_pairs / wall, 2),
            "wall_s": round(wall, 2),
            "rows": rows,
            "pairs_s_wall_native": round(n_pairs / wall_nat, 2),
            "wall_s_native": round(wall_nat, 2),
            "tsv_identical": bool(identical),
            "pairs_device": pairs_device, "pairs_overflow": overflow,
            "threads": int(cores),
        }, 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _tier(name, fn, device):
    """(result, mismatches) of one tier; a tier that raises is reported
    with its error and counts as one mismatch."""
    try:
        return fn(device)
    except Exception as e:
        sys.stderr.write(f"# {name} tier crashed: {e!r}\n")
        return {"error": repr(e)[:200]}, 1


def run(device="cuda") -> dict:
    """Every tier on `device` (CUDA unless the caller names the CPU);
    the JSON object main prints."""
    dev = resolve_device(device)
    tiers_on = os.environ.get("BENCH_TIERS", TIERS_DEFAULT).split(",")
    head, mism = _tier("main", tier_main, dev)
    tiers = {}
    for key, name, fn in (("distant_82_95", "distant", tier_distant),
                          ("search_decoy", "search", tier_search),
                          ("cli_triangle", "cli", tier_cli_triangle)):
        if name in tiers_on:
            tiers[key], m = _tier(name, fn, dev)
            mism += m
    out = {
        "metric": "unique genome-pairs/s (triangle all-vs-all, "
                  "E.coli-scale)",
        "value": head.get("value", 0.0),
        "unit": "pairs/s",
        "vs_baseline": head.get("vs_baseline", 0.0),
        "device_only": head.get("device_only", 0.0),
        "device_only_vs_baseline": head.get("device_only_vs_baseline", 0.0),
        "mismatches": mism,
        "tiers": tiers,
        "device": card(dev),
        "pairs_overflow": head.get("pairs_overflow"),
        "db_build_s": head.get("db_build_s"),
        "main": head,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    a = ap.parse_args(argv)
    out = run(a.device)
    print(json.dumps(out), flush=True)
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
