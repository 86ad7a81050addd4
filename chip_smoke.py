"""Smoke run of skani_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--genomes 32] [--length 5000000]

Phases (each prints one JSON line with its seconds and the depth it ran
at; any failure raises and the script exits non-zero without a result
line):

0. probe   — requires CUDA; prints the card's name and power limit, and
             its int32 lane rate (SMs x 64 INT32 lanes x the maximum SM
             clock), the peak that bounds the DP kernels' operations.
1. build   — builds the CUDA kernel library (nvcc, sm_90a) and the native
             host library (g++) from this checkout, in parallel; prints
             ptxas's registers and spills per kernel and, from
             `cuobjdump -sass` of the library, the SASS instructions of one
             step (the innermost loop holding the warp max) of each DP
             kernel instance, the 2-plane compact DP's by phase.
2. data    — two synthetic genome sets from the seed.  Each: one 5.0 Mbp
             random base with four 1.5 kb repeats in 2, 4, 8 and 200 copies
             (the last stays above every preset's repeat band after
             mutation, so the band drops its k-mers; a repeat just under a
             band would alone overflow the anchor buffer), genomes mutated
             at 0.3 %-3 %, as FASTA.  The first set: 32 genomes, genomes
             0-7 split into 2-8 contigs.  The second ("contigs"): 16
             genomes, every one split into 80-300 contigs, as a draft
             assembly is: more than 64 contigs leave the packed position
             word, so the engine takes the `sorted` generator.
3. triangle — `triangle --sparse --detailed` through the CLI entry point,
             each run once on the device executor (kernel launch counters
             set to 0 just before, read just after) and once on the exact
             native executor; the two TSVs must be byte-identical and at
             least one pair must finish on the device:
             * default (c=125, band 20), genomes 0-15: position-axis join,
               fused fill, 2-plane DP, packed aggregation;
             * `--medium` (c=70, band 35), genomes 0-7: position-axis join,
               index-only fill, windowed query-side gather, 3-plane DP at
               ring 64;
             * `--slow` (c=30, band 83), genomes 0-15: merge join
               (>= 2^17 seed positions, so no dense tables), genome-map
               gather, index-only fill, windowed gather, 3-plane DP at ring
               128, 3-key aggregation;
             * contigs, default preset, 16 genomes: `sorted` generator
               (merge join, four unpacked row gathers, unpacked readback),
               3-plane compact DP with the tag packing;
             * contigs, `--slow`, 8 genomes: `sorted` at band 83: three
               regroup scatters into the padded (1024, R * C_CAP) layout,
               the padded DP `dp_chain` at ring 128, two extraction
               gathers;
             * `-c 20` on genomes 0-7 of the first set: `sorted_packed`
               with a per-chunk cap of 2048, past the compact DPs:
               `dp_chain` and the 3-key aggregation.
4. phase_a — the first device batch of each of those runs on the GPU; the
             default one also on the CPU (plain kernel versions): packed
             outputs must be bit-identical.
4b. padded — the default first batch through `phase_a(compact_dp=False)`
             (the packed padded DP `dp_chain_packed`) and through
             `phase_a(expand_kernel=True)` (`expand_anchors`): rows that
             flag no overflow must equal the default call's; the `sorted`
             and `legacy` generators on small batches, CUDA against CPU;
             and the few-contig slow set through engines with per-chunk
             caps 1024 and 2048 (overflow counts, batch time).
5. joins   — the default preset's first batch through phase_a with the
             three joins (dense_pos, dense, merge) and with the
             single-payload fill: all packed outputs bit-identical to each
             other and to the CPU run, each timed with CUDA events and
             by its host enqueue.
6. kernels — each kernel against its plain version on the card at the
             shapes its path gives it, on adversarial inputs:
             bit-identical (tolerance 0), with medians of CUDA-event times;
             the row gather through a row map at its two call sites, with
             each site's device time, and on the default batch's own two
             calls (captured from its
             phase_a), the rows' copy then the gather beside the
             row-mapped call; the fused two-payload fill on the default
             batch's own targets and payloads, the single-payload fill on
             the contigs batch's and the genome-map gather on the slow
             and `-c 20` batches' (one row each: the row-affine launch and
             the one-thread-a-position launch; each captured from its
             phase_a), each also timed as
             inside its batch (after a 64 MB write and a write of its
             inputs: the output's lines are not in L2); each scatter beside
             the one torch call that computes it (scatter_ into a zeroed
             buffer with a column for the dropped targets); the 2-plane
             compact DP also on the default batch's own DP inputs; the
             padded DP at the
             many-contig slow batch's domain and at the `-c 20` batch's; the
             DP rows carry their SASS instructions per step (the 2-plane
             compact DP's per phase) and the steps their lanes take.  Then
             the microbenchmarks' Pallas kernels (scripts/microbench_*.py,
             "K12"), each by its contract at its script's default shapes
             through the kernel that computes it: the row gather (nine
             gathers along the row and one along axis 0 of a (512, 128)
             tile, transposed) and the multi-payload scatter, against
             numpy's take_along_axis and the script's scatter reference.

The line before the last is the kernel table as one JSON object, the last
line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# published data-sheet peaks (NVIDIA): device-memory bandwidth in bytes/s
# by card.  The DP kernels' compare-and-select work is int32, whose peak is
# the card's int32 lane rate: Hopper issues 64 INT32 lanes per SM per clock
# (half its 128 FP32 lanes, whose 67 TFLOP/s count an FMA as two
# operations), so int32_rate() multiplies the SM count by 64 and by the
# maximum SM clock that nvidia-smi reports
_BW = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
       ("H100", 3.35e12))
_INT32_LANES_PER_SM = 64
# the least DRAM read of scattered int32 words is one 32-byte sector each
_SECTOR = 32
# int32 operations per (anchor, candidate) pair: the least the recurrence
# needs, with the terms of one anchor hoisted, those of one stored anchor
# kept with its slot (its query position, dp * RING, one packed root and
# depth word) and the predicates joined inside the compares (Hopper's ISETP
# takes a predicate operand): d_q 1; d_r - 1 = rp_j * s_i + o_i 1 (the
# anchor's sign and offset hoisted); gap 2 (difference, abs); the range
# tests 5 (d_q <= min(pcl, D_MAX_LIN_LENGTH), d_q != 0, 1 <= d_r <=
# D_MAX_LIN_LENGTH as one unsigned compare, gap <= max_gap, the band
# window); comb 2 (gap * -RING + dp_j * RING, then - age_j + U_t); the
# running max 3 (compare, select the best and the payload): 14, and the
# same-chunk, orientation and valid test of each layout: the cid tag, rev
# and valid bits under one mask 2 (xor-and, compare; K3)
_DP_OPS_PER_CANDIDATE = 16
# rev and valid bits 2 and the chunk/contig word w3 1 (K8)
_DP_WIDE_OPS_PER_CANDIDATE = 17
# one equality of rcv (K10)
_DP_PADDED_OPS_PER_CANDIDATE = 15
# rev and valid bits 2; the contig rides in rprc and fails the d_r tests (K9)
_DP_PACKED_OPS_PER_CANDIDATE = 16
# expand_anchors per output slot: an 11-step binary search of the window
# (compare, select, halve: 3 each) and about 7 for the fetch and the row
_EXPAND_OPS_PER_SLOT = 40
# repeat copies of the synthetic bases
_COPIES = (2, 4, 8, 200)
# every triangle run: its genome set and depth (cut for the runs that are
# not this slice's), the CLI flags, the generator and the join the engine
# must pick by itself (no dense tables are built at >= 2^17 seed positions
# or outside the packed layout), and the kernels the run must launch
_RUNS = {
    "default": dict(
        set="base", depth=16, flags=[], gen="sorted_packed",
        join="dense_pos",
        must=("row_gather", "row_scatter_multi", "dp_chain_compact")),
    "medium": dict(
        set="base", depth=8, flags=["--medium"], gen="sorted_packed",
        join="dense_pos",
        must=("row_gather", "windowed_sorted_gather",
              "dp_chain_compact_wide")),
    "slow": dict(
        set="base", depth=16, flags=["--slow"], gen="sorted_packed",
        join="merge",
        must=("row_gather", "windowed_sorted_gather", "genome_map_gather",
              "dp_chain_compact_wide")),
    "contigs": dict(
        set="contigs", depth=16, flags=[], gen="sorted", join="merge",
        must=("row_gather", "genome_map_gather", "row_scatter",
              "dp_chain_compact_wide")),
    "contigs_slow": dict(
        set="contigs", depth=8, flags=["--slow"], gen="sorted",
        join="merge", must=("row_gather", "genome_map_gather", "dp_chain")),
    "c20": dict(
        set="base", depth=8, flags=["-c", "20"], gen="sorted_packed",
        join="merge",
        must=("row_gather", "genome_map_gather", "windowed_sorted_gather",
              "dp_chain")),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def bandwidth(name: str) -> float:
    for key, bw in _BW:
        if key in name:
            return bw
    raise RuntimeError(f"no data-sheet bandwidth known for {name!r}")


def int32_rate() -> dict:
    """The card's int32 lane rate in operations/s: SMs x 64 x the maximum
    SM clock, with its inputs."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    mhz = float(r.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sms": sms, "int32_lanes_per_sm": _INT32_LANES_PER_SM,
            "max_sm_clock_mhz": mhz,
            "ops_per_s": sms * _INT32_LANES_PER_SM * mhz * 1e6}


_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_SASS_BRA = re.compile(r"BRA (?:`\()?0x([0-9a-f]+)")


def kernel_name(mangled: str):
    """"name<N>" of a kernel instance from its mangled name (N: its
    template arguments, none for a plain kernel).  The name is the
    identifier ending in "_kernel" that its length prefix (the digits
    before it) spans exactly, so names with digits parse too."""
    for m in re.finditer(r"\d+", mangled):
        run = m.group()
        for k in range(len(run)):
            name = mangled[m.end():m.end() + int(run[k:])]
            if re.fullmatch(r"[a-z][a-z0-9_]*_kernel", name):
                rest = mangled[m.end() + len(name):]
                t = re.match(r"I((?:L[ib]\d+E)+)E", rest)
                args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
                return name + (f"<{','.join(args)}>" if args else "")
    return None


def _sass_loops(ins):
    """The loops of one function's SASS: (first address, last address,
    instruction texts) of each backward branch."""
    loops = []
    for a, txt in ins:
        b = _SASS_BRA.search(txt)
        if b and int(b.group(1), 16) < a:
            lo = int(b.group(1), 16)
            loops.append((lo, a, [t for x, t in ins if lo <= x <= a]))
    return loops


def _span(loop) -> int:
    return (loop[1] - loop[0]) // 16 + 1


def k3_phase_counts(loops, ins) -> dict:
    """SASS instructions of K3's (dp_compact_kernel) tile loop (the smallest
    loop with a shuffle), whose phases are straight-line code: `candidate`,
    one band candidate of phase 1 (from the first to the last 128-bit
    shared load, scaled to the load count, over that count); `phase2`, the
    31 rounds (first to last shuffle); `tile_rest`, the rest of the loop,
    run on every tile."""
    none = {"candidate": None, "phase2": None, "tile_rest": None}
    tiles = [l for l in loops if any("SHFL" in t for t in l[2])]
    if not tiles:
        return none
    tile = min(tiles, key=_span)
    in_tile = [(a, t) for a, t in ins if tile[0] <= a <= tile[1]]
    loads = [a for a, t in in_tile if "LDS.128" in t]
    shfl = [a for a, t in in_tile if "SHFL" in t]
    if len(loads) < 2:
        return none
    phase1 = (max(loads) - min(loads)) / 16 * len(loads) / (len(loads) - 1)
    phase2 = (max(shfl) - min(shfl)) // 16 + 1
    return {"candidate": phase1 / len(loads), "phase2": phase2,
            "tile_rest": _span(tile) - phase1 - phase2}


def sass_step_counts(so: str, nvcc: str) -> dict:
    """SASS instructions of one DP step per kernel instance of the library
    `so` (cuobjdump -sass): the span of the innermost backward branch
    whose loop holds a warp max (REDUX), keyed "name<N>"; K3's by phase
    (k3_phase_counts)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    r = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError("cuobjdump failed: " + r.stderr)
    out, fns = {}, []
    for ln in r.stdout.splitlines():
        m = _SASS_FN.search(ln)
        if m:
            fns.append((m.group(1), []))
            continue
        m = _SASS_INS.search(ln)
        if m and fns:
            fns[-1][1].append((int(m.group(1), 16), m.group(2)))
    for fn, ins in fns:
        name = kernel_name(fn)
        if name is None or not name.startswith("dp_"):
            continue
        loops = _sass_loops(ins)
        spans = [_span(l) for l in loops
                 if any("REDUX" in t for t in l[2])]
        out[name] = min(spans) if spans else None
        if name == "dp_compact_kernel":   # and a step of a REDUX loop, if any
            out[name] = dict(k3_phase_counts(loops, ins), step=out[name])
    return out


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Median time of fn() over `reps` calls, CUDA events around each."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def phase(name):
    def deco(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            info = out[1] if isinstance(out, tuple) else {}
            emit(dict({"phase": name,
                       "seconds": time.perf_counter() - t0}, **info))
            return out[0] if isinstance(out, tuple) else out
        return run
    return deco


@phase("build")
def build():
    from skani_tpu_torch import native
    from skani_tpu_torch.kernels import _build
    res = {}

    def nat():
        t0 = time.perf_counter()
        res["native_ok"] = native.get_lib() is not None
        res["native_s"] = time.perf_counter() - t0

    th = threading.Thread(target=nat)
    th.start()
    t0 = time.perf_counter()
    _build.lib()
    res["nvcc_s"] = time.perf_counter() - t0
    th.join()
    if not res["native_ok"]:
        raise RuntimeError("native host library failed to build")
    sass = sass_step_counts(_build.SO, _build.nvcc_path())
    return sass, dict(res, ptxas=ptxas_report(_build.build_log),
                      sass_per_step=sass)


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel instance from ptxas -v."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: |$)", ln)
        if m:
            name = kernel_name(m.group(1)) or m.group(1)
            out.setdefault(name, {})
        elif name and "spill stores" in ln:
            b = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack=b[0], spill_stores=b[1], spill_loads=b[2])
        elif name and "registers" in ln:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


@phase("data")
def make_data(tmp, seed, n_genomes, length):
    from skani_tpu_torch import synth
    genomes = synth.genome_set(seed, n_genomes, length,
                               copies=_COPIES, rates=(0.003, 0.03),
                               n_split=8, contigs=(2, 8))
    drafts = synth.genome_set(seed + 1, 16, length, copies=_COPIES,
                              rates=(0.003, 0.03), n_split=16,
                              contigs=(80, 300))
    sets = {"base": synth.write_genome_set(tmp, genomes),
            "contigs": synth.write_genome_set(tmp, drafts, prefix="d")}
    return sets, {"genomes": {k: len(v) for k, v in sets.items()},
                  "bases": int(sum(sum(len(c) for c in g)
                                   for g in genomes + drafts)),
                  "contigs": {"base": [len(g) for g in genomes],
                              "contigs": [len(g) for g in drafts]}}


def _triangle(argv):
    from skani_tpu_torch import cli, stats
    before = stats.snapshot()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    after = stats.snapshot()
    return wall, {k: after.get(k, 0.0) - before.get(k, 0.0)
                  for k in set(after) | set(before)}


# driver phases, then (device run) the executor's parts: DeviceDb build,
# phase A enqueue, waits for the device->host copy, host finalize (on its
# own thread, overlapped with the next batches)
_SPLIT = ("sketch", "screen", "executor", "write", "db_build", "dispatch",
          "readback", "finalize")


def _counters():
    from skani_tpu_torch.kernels import (dp_compact, dp_pallas,
                                         expand_pallas, gather)
    return (gather.LAUNCHES, dp_compact.LAUNCHES, dp_pallas.LAUNCHES,
            expand_pallas.LAUNCHES)


def reset_launches():
    for d in _counters():
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    out = {}
    for d in _counters():
        out.update(d)
    return out


def _argv(sets, preset):
    run = _RUNS[preset]
    return ["triangle", *sets[run["set"]][:run["depth"]], "--sparse",
            "--detailed", *run["flags"], "-t", str(os.cpu_count())]


def triangle(tmp, sets, preset):
    """One run's triangle on the device and on the native executor."""
    base = _argv(sets, preset)
    paths = sets[_RUNS[preset]["set"]][:_RUNS[preset]["depth"]]
    dev_tsv = os.path.join(tmp, f"device_{preset}.tsv")
    nat_tsv = os.path.join(tmp, f"native_{preset}.tsv")
    os.environ.pop("SKANI_TPU_EXECUTOR", None)
    reset_launches()
    dev_wall, dev_stats = _triangle(base + ["-o", dev_tsv])
    launches = read_launches()
    os.environ["SKANI_TPU_EXECUTOR"] = "native"
    try:
        nat_wall, nat_stats = _triangle(base + ["-o", nat_tsv])
    finally:
        os.environ.pop("SKANI_TPU_EXECUTOR", None)
    with open(dev_tsv, "rb") as f:
        dev_bytes = f.read()
    with open(nat_tsv, "rb") as f:
        nat_bytes = f.read()
    if dev_bytes != nat_bytes:
        raise RuntimeError(f"{preset}: device and native triangle TSVs "
                           f"differ")
    n_rows = len(dev_bytes.splitlines()) - 1
    pairs_dev = int(dev_stats.get("pairs_device", 0))
    overflow = int(dev_stats.get("pairs_overflow", 0))
    if pairs_dev <= overflow:
        raise RuntimeError(f"{preset}: no pair was finished by the device "
                           f"engine ({overflow} of {pairs_dev} overflowed)")
    missing = [k for k in _RUNS[preset]["must"] if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{preset}: kernels of the path never launched: "
                           f"{missing} ({launches})")
    return launches, {
        "preset": preset, "genomes": len(paths),
        "tsv_identical": True, "tsv_rows": n_rows,
        "pairs_scored": pairs_dev, "pairs_device": pairs_dev,
        "pairs_overflow": overflow,
        "overflow_share": overflow / pairs_dev,
        "pairs_mirrored": int(dev_stats.get("pairs_mirrored", 0)),
        "device_batches": int(dev_stats.get("device_batches", 0)),
        "device_wall_s": dev_wall, "native_wall_s": nat_wall,
        "device_pairs_per_s": pairs_dev / dev_wall,
        "native_pairs_per_s": pairs_dev / nat_wall,
        "device_split_s": {k: dev_stats.get(k + "_s", 0.0)
                           for k in _SPLIT},
        "native_split_s": {k: nat_stats.get(k + "_s", 0.0)
                           for k in _SPLIT},
        "launches": launches}


def first_batch(sets, preset):
    """The first device batch of a triangle run, rebuilt the way the CLI's
    executor builds it: same sketches, screened pairs, engine.  Returns
    (engine, first group, all screened pairs)."""
    from skani_tpu_torch import cli, engine, screen
    from skani_tpu_torch.kernels.device_pipeline import DevicePairEngine
    ns = cli.build_parser().parse_args(_argv(sets, preset))
    sp, cp = cli.parse_args_to_params(ns)
    cp.threads = os.cpu_count()
    _p, sks = engine._load_side(cp.ref_files, False, False, sp,
                                threads=cp.threads)
    index = screen.MarkerIndex(sks)
    sv = engine._resolve_screen_val(cp, sp)
    pairs = [(i, int(j)) for i in range(len(sks) - 1)
             for j in screen.screen_refs(sv, index, sks[i], sp,
                                         cp.rescue_small) if j > i]
    eng = DevicePairEngine(sks, sp, cp, device="cuda")
    _out, meta, _mirrors = eng.plan(pairs)
    group = next(eng.groups(meta))
    return eng, group, pairs


def phase_a_parity(sets, preset, cpu_check):
    """One run's first batch through phase_a on the card: event time,
    enqueue time, profile; with `cpu_check` also the CPU run (plain kernel
    versions), which must give the same packed output."""
    from skani_tpu_torch.kernels.device_pipeline import phase_a
    eng, group, _pairs = first_batch(sets, preset)
    args = eng.batch_args(group, group[0][4])
    run = _RUNS[preset]
    if (eng.gen_mode, args["join_mode"]) != (run["gen"], run["join"]):
        raise RuntimeError(
            f"{preset}: the engine took the {eng.gen_mode} generator and "
            f"the {args['join_mode']} join, not {run['gen']} and "
            f"{run['join']}")
    ab = eng.batch_index(group)
    t0 = time.perf_counter()
    got = phase_a(eng.db.arrays, ab, **args)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(5):
        phase_a(eng.db.arrays, ab, **args)
    t_enqueue = (time.perf_counter() - t0) / 5
    gpu_ms = cuda_ms(lambda: phase_a(eng.db.arrays, ab, **args), 10)
    prof = profile_phase_a(lambda: phase_a(eng.db.arrays, ab, **args), 3)
    info = {}
    if cpu_check:
        cpu_db = eng.db.to("cpu")
        t0 = time.perf_counter()
        want = phase_a(cpu_db.arrays, ab.cpu(), **args)
        info = {"cpu_s": time.perf_counter() - t0, "bit_identical": True}
        if not torch.equal(got.cpu(), want):
            raise RuntimeError("phase_a on CUDA differs from phase_a on CPU")
    I, C, R = args["I_CAP"], args["C_CAP"], int(ab.shape[1])
    shapes = {"preset": preset, "genomes": run["depth"],
              "R": R, "pairs": len(group), "A": args["A"],
              "P": eng.db.P, "U": getattr(eng.db, "U", None), "K": eng.db.K,
              "I_CAP": I, "C_CAP": C, "L_CAP": args["L_CAP"],
              "band": args["band"], "gen_mode": eng.gen_mode,
              "join_mode": args["join_mode"],
              # the padded DP's domain, where the run takes it
              "RC": R * C, "padded_plane_bytes": 4 * args["L_CAP"] * R * C}
    return (eng, group, args, ab, got), dict(
        shapes, packed_shape=list(got.shape),
        rows_overflow=int(got[:len(group), -1].sum()),
        gpu_first_call_s=t_gpu,
        # host time to enqueue one batch (no sync) and the CUDA-event time
        # of one batch end to end on the stream
        enqueue_ms=1e3 * t_enqueue,
        enqueue_median_ms=enqueue_ms(lambda: phase_a(eng.db.arrays, ab,
                                                     **args)),
        batch_ms=gpu_ms, profile=prof, **info)


@phase("joins")
def joins(batch):
    """The default preset's first batch through the three joins and the
    single-payload fill on the card: every packed output equals the
    position-axis one (itself held to the CPU run by the phase_a phase)."""
    from skani_tpu_torch.kernels.device_pipeline import (DevicePairEngine,
                                                         phase_a)
    eng, group, args, ab, want = batch
    variants = {"dense_pos": {}, "dense": {"join_mode": "dense"},
                "merge": {"join_mode": "merge"},
                "dense_pos_unfused": {"fused_apk": False}}
    ms, counts = {}, {}
    reset_launches()
    for name, over in variants.items():
        before = read_launches()
        got = phase_a(eng.db.arrays, ab, **dict(args, **over))
        torch.cuda.synchronize()
        after = read_launches()
        counts[name] = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
        if not torch.equal(got, want):
            raise RuntimeError(f"joins: {name} differs from dense_pos")
    launches = read_launches()
    enq = {}
    for name, over in variants.items():
        fn = lambda: phase_a(eng.db.arrays, ab, **dict(args, **over))
        ms[name] = cuda_ms(fn, 10)
        enq[name] = enqueue_ms(fn)
    # the engine's own routing: a forced join is what a user would pass
    for jm in ("dense", "merge"):
        e2 = DevicePairEngine(eng.sketches, eng.sketch_params,
                              eng.command_params, device="cuda",
                              join_mode=jm)
        if e2.batch_args(group, group[0][4])["join_mode"] != jm:
            raise RuntimeError(f"joins: the engine did not take {jm}")
    for k in ("row_scatter", "windowed_sorted_gather", "genome_map_gather"):
        if launches[k] <= 0:
            raise RuntimeError(f"joins: {k} never launched ({launches})")
    return launches, {"preset": "default",
                      "genomes": _RUNS["default"]["depth"],
                      "bit_identical": True, "batch_ms": ms,
                      # median host time to enqueue one batch
                      "enqueue_ms": enq, "launches_by_variant": counts,
                      "launches": launches,
                      "R": int(ab.shape[1]), "A": args["A"],
                      "P": eng.db.P, "U": eng.db.U, "K": eng.db.K}


# this repository's kernels by name, the first tag a name holds taking it
# (K5's row-affine launch is K1's direct kernel with the index-row map)
_OWN_KERNELS = ("row_gather_kernel<4, 1024, true>", "row_gather_kernel",
                "row_gather_staged_kernel", "row_scatter_kernel",
                "windowed_gather_kernel", "genome_map_gather_kernel",
                "dp_compact_kernel", "dp_wide_kernel",
                "dp_chain_packed_kernel", "dp_chain_kernel", "expand_kernel")


def _device_events(fn, reps: int):
    """torch.profiler over `reps` calls of fn(): (CUDA-event ms per call,
    [(kernel name, device microseconds, count)] summed over the calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return a.elapsed_time(b) / reps, [
        (e.key, getattr(e, "self_device_time_total", 0.0), e.count)
        for e in kern]


def device_ms(fn, reps: int = 5):
    """Device time of one fn() call: the time of the kernels it launches,
    without the host's launch cost (torch.profiler).  Every fn timed here
    launches each of its kernels once a call.  The profiler does not
    always report every launch of a back-to-back run (a sum over `reps`
    read up to five times too low, and sometimes nothing at all), so each
    kernel's time is averaged over the launches it did report; None when
    five tries reported none, or no time for them."""
    for _ in range(5):
        _span, dev_us = _device_events(fn, reps)
        ms = sum(t / n for _k, t, n in dev_us if n) / 1e3
        if ms > 0:
            return ms
    return None


def device_ms_in_batch(fn, inputs, reps: int = 5):
    """Device time of this repository's kernels (the _OWN_KERNELS tags) in
    one fn() call made as inside a batch: after a 64 MB write has filled
    the L2 with other dirty lines, and after a write of each input, as the
    batch's previous kernels leave it.  Back to back, the output of the
    last call is still in L2; inside a batch it is not, and the lines the
    call evicts go to device memory.  None when five tries reported
    none of its kernels."""
    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda")

    def step():
        flush.fill_(1)
        for x in inputs:
            x.add_(0)
        fn()

    for _ in range(5):
        _span, dev_us = _device_events(step, reps)
        ms = sum(t / n for k, t, n in dev_us
                 if n and any(g in k for g in _OWN_KERNELS)) / 1e3
        if ms > 0:
            return ms
    return None


def back_to_back_ms(fn, reps: int = 10) -> float:
    """CUDA-event time of `reps` back-to-back fn() calls over their count:
    the stream runs the kernels one after the other, so this is their
    device time wherever a kernel outlasts the host's enqueue of the next
    call (the millisecond DPs), and an upper bound elsewhere."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def enqueue_ms(fn, reps: int = 7) -> float:
    """Median host time to enqueue one fn() call on an idle stream."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return float(np.median(ts))


def profile_phase_a(fn, reps: int) -> dict:
    """Device time of one batch by kernel (torch.profiler, CUDA activity):
    the summed kernel time per batch, its share of the CUDA-event batch
    time, the kernel launch count, and the largest kernels."""
    span_ms, dev_us = _device_events(fn, reps)
    total_ms = sum(t for _k, t, _n in dev_us) / reps / 1e3
    top = sorted(dev_us, key=lambda x: -x[1])[:8]
    # this repository's own kernels by name (ms per batch)
    own = {}
    for k, t, _n in dev_us:
        tag = next((g for g in _OWN_KERNELS if g in k), None)
        if tag is not None:
            own[tag] = own.get(tag, 0.0) + t / reps / 1e3
    return {"span_ms": span_ms, "kernel_ms": total_ms, "own_kernels_ms": own,
            "device_busy_share": total_ms / span_ms if span_ms else None,
            "kernels_per_batch": sum(n for _k, _t, n in dev_us) / reps,
            "top": [[k[:60], t / reps / 1e3] for k, t, _n in top]}


def _same_unless_overflow(name, got, want, n):
    """Rows that flag no overflow in either readback must be equal."""
    clean = (got[:n, -1] == 0) & (want[:n, -1] == 0)
    if not bool(clean.any()):
        raise RuntimeError(f"padded: {name}: every row flags overflow")
    if not torch.equal(got[:n][clean], want[:n][clean]):
        raise RuntimeError(f"padded: {name} differs from the default call")
    return int(clean.sum())


def _small_parity(name, db, ab, args, must):
    """phase_a on a small batch, CUDA against CPU (plain versions)."""
    from skani_tpu_torch.kernels.device_pipeline import phase_a
    before = read_launches()
    got = phase_a(db.arrays, ab, **args)
    torch.cuda.synchronize()
    after = read_launches()
    want = phase_a(db.to("cpu").arrays, ab.cpu(), **args)
    if not torch.equal(got.cpu(), want):
        raise RuntimeError(f"padded: {name}: phase_a on CUDA differs from "
                           f"phase_a on CPU")
    missing = [k for k in must if after[k] <= before[k]]
    if missing:
        raise RuntimeError(f"padded: {name}: never launched {missing}")
    if int(want[:, -2].min()) <= 0 or bool(want[:, -1].all()):
        raise RuntimeError(f"padded: {name}: the batch found no anchors or "
                           f"overflowed on every row")
    return {"rows": int(ab.shape[1]), "rows_overflow": int(want[:, -1].sum()),
            "packed_shape": list(want.shape)}


@phase("padded")
def padded(batch, sets, seed):
    """The default first batch with the compact DP off (dp_chain_packed)
    and with the expansion kernel (expand_anchors) against the default
    call; the `sorted` and `legacy` generators CUDA against CPU on small
    batches; the few-contig slow set at per-chunk caps 1024 and 2048."""
    from skani_tpu_torch import CommandParams, SketchParams, stats, synth
    from skani_tpu_torch.kernels.device_db import DeviceDb
    from skani_tpu_torch.kernels.device_pipeline import (DevicePairEngine,
                                                         phase_a)
    eng, group, args, ab, want = batch
    info = {"R": int(ab.shape[1]), "A": args["A"], "P": eng.db.P,
            "L_CAP": args["L_CAP"], "C_CAP": args["C_CAP"]}
    variants = {"compact_dp_off": ({"compact_dp": False}, "dp_chain_packed"),
                "expand_kernel": ({"expand_kernel": True}, "expand_anchors")}
    reset_launches()
    for name, (over, kernel) in variants.items():
        got = phase_a(eng.db.arrays, ab, **dict(args, **over))
        torch.cuda.synchronize()
        info[name] = {
            "rows_equal": _same_unless_overflow(name, got, want, len(group)),
            "rows_overflow": int(got[:len(group), -1].sum())}
    launches = read_launches()
    for name, (over, kernel) in variants.items():
        if launches[kernel] != 1:
            raise RuntimeError(f"padded: {kernel} launched "
                               f"{launches[kernel]} times, not once")
        info[name]["batch_ms"] = cuda_ms(
            lambda: phase_a(eng.db.arrays, ab, **dict(args, **over)), 10)
        info[name]["profile"] = profile_phase_a(
            lambda: phase_a(eng.db.arrays, ab, **dict(args, **over)), 3)
    info["default_batch_ms"] = cuda_ms(
        lambda: phase_a(eng.db.arrays, ab, **args), 10)

    # small batches, CUDA against CPU: the `sorted` generator (4 genomes of
    # 300 kb in 90-120 contigs) at band 20 (tag packing) and band 35 (the
    # padded DP), with the split mapping gathers (P >= 2^19), and the
    # legacy generator on a DNA database built in its layout, with the
    # packed start pair (P <= 65536) and beyond it
    cp = CommandParams()
    drafts = synth.genome_set(seed + 2, 4, 300_000, copies=(2, 3, 4),
                              n_split=4, contigs=(90, 120), min_len=500)
    for c, kw, must in (
            (125, {}, ("row_scatter", "dp_chain_compact_wide")),
            (70, {}, ("row_scatter", "dp_chain")),
            (125, {"min_p": (1 << 19) + 4096}, ("dp_chain_compact_wide",))):
        sp = SketchParams(c=c)
        sks = [synth.sketch_parts(g, sp, f"f{i}")
               for i, g in enumerate(drafts)]
        e2 = DevicePairEngine(sks, sp, cp, device="cuda", **kw)
        if e2.gen_mode != "sorted":
            raise RuntimeError("padded: expected the sorted generator")
        _o, meta, _m = e2.plan([(i, j) for i in range(4)
                                for j in range(i + 1, 4)])
        g2 = next(e2.groups(meta))
        name = f"sorted_c{c}" + ("_split" if kw else "")
        info[name] = _small_parity(name, e2.db, e2.batch_index(g2),
                                   e2.batch_args(g2, g2[0][4]), must)
    for c, length in ((125, 300_000), (20, 1_500_000)):
        sp = SketchParams(c=c)
        gs = synth.genome_set(seed + 3, 3, length, rates=(0.005, 0.03),
                              n_split=1, contigs=(2, 4))
        sks = [synth.sketch_parts(g, sp, f"l{i}") for i, g in enumerate(gs)]
        db = DeviceDb(sks, "cuda", mode="legacy")
        abl = torch.tensor([[0, 1, 2, 2], [1, 2, 0, 1]], dtype=torch.int32,
                           device="cuda")
        a_l = max(8192, (int(1.15 * db.max_n_pos) + 2047) // 2048 * 2048)
        largs = dict(A=a_l, I_CAP=256, C_CAP=128, L_CAP=2048,
                     band=min(2500 // c, 200), fl=20000, pcl=2500,
                     max_gap=300.0, anchor_score=20.0, min_anchors=3,
                     min_score=45.0, gen_mode="legacy", join_mode="merge")
        info[f"legacy_c{c}"] = dict(
            _small_parity(f"legacy_c{c}", db, abl, largs, ("dp_chain",)),
            P=db.P)

    # what the next per-chunk cap costs: the few-contig slow set (whose
    # closest pairs overflow L_CAP 1024) through engines at both caps
    e1, _g1, pairs = first_batch(sets, "slow")
    engines = {l_cap: DevicePairEngine(
        e1.sketches, e1.sketch_params, e1.command_params, device="cuda",
        l_cap=l_cap) for l_cap in (1024, 2048)}
    caps = {l_cap: {"pairs": len(pairs), "run_pairs_s": [],
                    "pairs_overflow": []} for l_cap in engines}
    ani = {}
    for l_cap in (1024, 2048, 2048, 1024, 1024, 2048):   # in turns
        before = stats.snapshot().get("pairs_overflow", 0)
        t0 = time.perf_counter()
        res = engines[l_cap].run_pairs(pairs)
        caps[l_cap]["run_pairs_s"].append(time.perf_counter() - t0)
        caps[l_cap]["pairs_overflow"].append(
            int(stats.snapshot().get("pairs_overflow", 0) - before))
        ani[l_cap] = np.asarray([r.ani for r in res])
    for l_cap, e in engines.items():
        _o, meta, _m = e.plan(pairs)
        g = next(e.groups(meta))
        a_g, ab_g = e.batch_args(g, g[0][4]), e.batch_index(g)
        caps[l_cap].update(
            batch_ms=cuda_ms(lambda: phase_a(e.db.arrays, ab_g, **a_g), 5),
            R=int(ab_g.shape[1]), C_CAP=a_g["C_CAP"])
    if not np.array_equal(ani[1024], ani[2048], equal_nan=True):
        raise RuntimeError("padded: per-chunk caps 1024 and 2048 gave "
                           "different ANI values")
    info["slow_l_cap"] = caps
    return launches, info


def _sectors(R, K, idx_np, mask=None, rows=None):
    """Distinct 32-byte sectors of a (R, K) int32 table that the in-range
    (and, with `mask`, selected) entries of idx_np touch; with `rows`
    (R,), index row r reads table row rows[r]."""
    rows = np.arange(R) if rows is None else np.asarray(rows)
    rows = np.broadcast_to(rows.astype(np.int64)[:, None], idx_np.shape)
    sec = rows * ((K + 7) // 8) + np.clip(idx_np, 0, K - 1) // 8
    return np.unique(sec if mask is None else sec[mask]).size


def dp_candidates(valid, band) -> int:
    """(anchor, candidate) pairs the recurrence needs: a valid anchor at
    step i of its lane (the last axis) weighs the min(band, i) steps before
    it."""
    tt = np.minimum(np.arange(valid.shape[-1]), band)
    return int((tt * (valid != 0)).sum())


def compact_steps(w1, colc, S, H) -> dict:
    """What the compact-layout lanes of K3 and K8 run on these inputs,
    against the S + H steps of every lane before: the columns a lane scans
    (its S and its halo up to the last column whose col_in_chunk exceeds
    its offset), the valid anchors among them (K8's steps), its 32-column
    tiles and those with a valid anchor (K3 runs both phases on them)."""
    R, A = w1.shape
    nseg = A // S
    scanned, stepped, tiles, run = [], [], [], []
    for seg in range(nseg):
        for r in range(R):
            last = -1
            if seg + 1 < nseg:
                hc = colc[r, (seg + 1) * S:(seg + 1) * S + H]
                hit = np.nonzero(hc > np.arange(H))[0]
                last = int(hit.max()) if hit.size else -1
            T = S + last + 1
            v = np.zeros((T + 31) // 32 * 32, np.int64)
            v[:T] = w1[r, seg * S:seg * S + T] & 1
            scanned.append(T)
            stepped.append(int(v.sum()))
            tiles.append(v.size // 32)
            run.append(int((v.reshape(-1, 32).sum(1) > 0).sum()))
    return {"lanes": len(scanned), "before_per_lane": S + H,
            "scanned_mean": float(np.mean(scanned)),
            "scanned_max": int(np.max(scanned)),
            "anchor_steps_mean": float(np.mean(stepped)),
            "anchor_steps_max": int(np.max(stepped)),
            "tiles_mean": float(np.mean(tiles)),
            "tiles_run_mean": float(np.mean(run))}


def k3_sass_per_lane(st, sp, band):
    """SASS instructions a K3 lane issues on average: each tile's rest, and
    on each tile with a valid anchor the candidate groups of four that the
    band reaches and phase 2."""
    if None in (sp.get("candidate"), sp.get("phase2"),
                sp.get("tile_rest")):
        return None
    return (st["tiles_mean"] * sp["tile_rest"] + st["tiles_run_mean"]
            * (-(-band // 4) * 4 * sp["candidate"] + sp["phase2"]))


def padded_steps(rcv) -> dict:
    """What the lanes of K10 step on these inputs: the valid anchors of a
    lane, against the rows of its 32-row tiles that hold one (the steps
    before)."""
    valid = (rcv & 1) != 0
    L = valid.shape[0]
    tiles = np.add.reduceat(valid, np.arange(0, L, 32), axis=0) > 0
    before = (tiles * np.minimum(32, L - np.arange(0, L, 32))[:, None]
              ).sum(0)
    return {"lanes": int(valid.shape[1]),
            "anchor_steps_mean": float(valid.sum(0).mean()),
            "anchor_steps_max": int(valid.sum(0).max()),
            "before_mean": float(before.mean())}


@phase("kernels")
def kernels(batch, slow_batch, ct_batch, cs_batch, c20_batch, bw, rate,
            sass, name):
    """Every kernel against its plain version on the card.  K1-K3, the
    single-payload scatter, the packed padded DP and the expansion kernel
    at the default batch's shapes (the only path that gives the scatters P
    <= 65536); the windowed gather, the genome map gather and the 3-plane
    DP at the slow batch's; the padded DP at the many-contig slow batch's
    and the -c 20 batch's, where the genome map gather also runs; then
    the microbenchmarks' contracts (K12) at their scripts' shapes.
    Bounds: bytes over the card's memory rate, DP operations over its
    int32 lane rate (`rate`, from int32_rate())."""
    from skani_tpu_torch import synth
    from skani_tpu_torch.kernels import (dp_compact, dp_pallas,
                                         expand_pallas, gather)
    eng, group, args, ab, _ = batch
    dev = torch.device("cuda")
    rng = np.random.default_rng(12345)
    R = int(ab.shape[1])
    A, P, U = args["A"], eng.db.P, eng.db.U
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rows = []
    # device time of the kernel's and the library call's launches alone
    # (torch.profiler), beside the CUDA-event times, which at these sizes
    # are mostly the host's launch cost
    dev_ms, lib_dev_ms = {}, {}
    # where each device time came from: "profiler", or "events" where the
    # profiler reported no launch and back_to_back_ms stands in
    dev_src, lib_dev_src = {}, {}

    def compare(kname, fn, plain, reps, plain_reps, library=None):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        if err != 0 or not all(torch.equal(g, w)
                               for g, w in zip(got, want)):
            raise RuntimeError(f"{kname}: kernel differs from its plain "
                               f"version (max abs err {err})")
        for acc, src, f in ((dev_ms, dev_src, fn),
                            (lib_dev_ms, lib_dev_src, library)):
            if f is not None:
                d = device_ms(f)
                if d is None:   # the profiler reported no launch
                    src[kname] = "events"
                    d = back_to_back_ms(f)
                else:
                    src.setdefault(kname, "profiler")
                # the sum over a kernel's call sites
                acc[kname] = acc.get(kname, 0.0) + d
        return (err, cuda_ms(fn, reps),
                cuda_ms(plain, plain_reps, 1 if plain_reps > 1 else 0),
                None if library is None else cuda_ms(library, reps))

    # row_gather at its two call sites of one batch: the dense_pos join
    # (G, U) table at (R, P) indices, and the ref-side bpk (G, P) table at
    # (R, A) indices, each through the batch's ref rows (repeated genome
    # ids, the first and the last); adversarial words, boundary and
    # out-of-range indices.  Device ms by site
    G = eng.db.G
    g_ms = g_plain = g_lib = g_bytes = 0.0
    g_err = 0
    g_shapes, g_sites = [], []
    for K, N in ((U, P), (P, A)):
        table = t(synth.adversarial_words(rng, (G, K)))
        rows_np = rng.integers(0, G, size=R).astype(np.int32)
        rows_np[:3] = [0, G - 1, 0]
        rows_t = t(rows_np)
        tab_r = table[rows_t.long()]
        idx_np = rng.integers(0, K, size=(R, N)).astype(np.int32)
        idx_np[:, :8] = [0, 1, 127, 128, K - 2, K - 1, -5, K + 7]
        idx = t(idx_np)
        idx_in = t(np.clip(idx_np, 0, K - 1))
        fn = lambda: gather.row_gather(table, idx, rows_t)
        err, ms, pms, lms = compare(
            "row_gather", fn, lambda: gather.row_gather_plain(tab_r, idx),
            20, 20, library=lambda: torch.gather(tab_r, 1, idx_in.long()))
        g_err, g_ms, g_plain, g_lib = (max(g_err, err), g_ms + ms,
                                       g_plain + pms, g_lib + lms)
        # idx read and out written once; of the table, only the distinct
        # 32-byte sectors these (clamped) indices touch in the rows read
        g_bytes += 4 * 2 * R * N + _SECTOR * _sectors(R, K, idx_np,
                                                      rows=rows_np)
        g_shapes.append([[G, K], [R, N], [R]])
        g_sites.append({"table": [G, K], "idx": [R, N],
                        "device_ms": device_ms(fn)})
        del table, tab_r, idx, idx_in
    rows.append(dict(name="row_gather", shape=g_shapes, err=g_err,
                     ms=g_ms, plain_ms=g_plain, library_ms=g_lib,
                     bytes=g_bytes, ops=2 * R * (P + A), per_batch=2,
                     sites=g_sites, source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:601"))

    # row_gather on the default batch's own inputs: its two calls (the
    # dense_pos join of dense_cs, the ref-side gather of bpk), grabbed
    # from its phase_a.  Before: the batch's copy of the rows, then the
    # gather, as a gather without a row map needs; after: the row-mapped
    # call.  Device ms by site
    from skani_tpu_torch.kernels import device_pipeline
    from skani_tpu_torch.kernels.device_pipeline import phase_a

    def grab_calls(batch_, names):
        """The arguments of every call of each device_pipeline kernel
        wrapper in `names` that one phase_a of batch_ makes, cloned, by
        name in call order."""
        beng, _g, bargs, bab, _w = batch_
        got = {n: [] for n in names}
        saved = {n: getattr(device_pipeline, n) for n in names}

        def wrap(n):
            def f(*a, **k):
                got[n].append([x.clone() if torch.is_tensor(x) else x
                               for x in a])
                return saved[n](*a, **k)
            return f

        for n in names:
            setattr(device_pipeline, n, wrap(n))
        try:
            phase_a(beng.db.arrays, bab, **bargs)
        finally:
            for n, f in saved.items():
                setattr(device_pipeline, n, f)
        missing = [n for n in names if not got[n]]
        if missing:
            raise RuntimeError(f"the batch made no call of {missing}")
        return got

    calls = [c[1] for c in grab_calls(batch, ["row_gather"])["row_gather"]]
    if [list(c.shape) for c in calls] != [[R, P], [R, A]]:
        raise RuntimeError(f"row_gather: the default batch made calls "
                           f"{[list(c.shape) for c in calls]}, not its "
                           f"two sites")
    b_rows = ab[1].contiguous()
    b_long = b_rows.long()
    b_np = b_rows.cpu().numpy()
    # one call site at a time: device_ms reads one launch of each kernel
    acc = dict(err=0, ms=0.0, plain_ms=0.0, before_ms=0.0,
               before_device_ms=0.0, bytes=0, ops=0)
    b_sites, shapes = [], []
    for key, c in zip(("dense_cs", "bpk"), calls):
        tb = eng.db.arrays[key]
        before = lambda: gather.row_gather(tb[b_long], c)
        after = lambda: gather.row_gather(tb, c, b_rows)
        err, ms, pms, _ = compare(
            "row_gather[batch]", after,
            lambda: gather.row_gather_plain(tb[b_long], c), 20, 5)
        bdev = device_ms(before)
        acc["err"] = max(acc["err"], err)
        acc["ms"] += ms
        acc["plain_ms"] += pms
        acc["before_ms"] += cuda_ms(before, 20)
        acc["before_device_ms"] = None if None in (
            bdev, acc["before_device_ms"]) else acc["before_device_ms"] + bdev
        acc["bytes"] += 4 * 2 * c.numel() + _SECTOR * _sectors(
            R, tb.shape[1], c.cpu().numpy(), rows=b_np)
        acc["ops"] += 2 * c.numel()
        shapes.append([list(tb.shape), list(c.shape), [R]])
        b_sites.append({"table": [key] + list(tb.shape),
                        "idx": list(c.shape), "device_ms": device_ms(after),
                        "before_device_ms": bdev})
    rows.append(dict(
        name="row_gather[batch]", counter="row_gather", shape=shapes,
        library_ms=None, per_batch=2, sites=b_sites,
        source="skani_tpu_torch/csrc/gather.cu",
        replaces="skani_tpu/kernels/gather_pallas.py:601", **acc))
    del calls

    def scatter_bytes(idx, V, K):
        """Targets read once, the payloads of the kept targets (in [0, K))
        read once, the (R, V, K) output written once."""
        kept = int(((idx >= 0) & (idx < K)).sum())
        return 4 * (idx.numel() + V * kept + idx.shape[0] * V * K)

    def scatter_library(idx, vals, K):
        """The one torch call that computes the scatter: scatter_ into a
        preallocated zeroed (R, V, K + 1) buffer, whose last column takes
        the dropped targets, redirected before the timed call."""
        R, V, P = vals.shape
        tl = torch.where((idx >= 0) & (idx < K), idx,
                         K).long()[:, None, :].expand(R, V, P)
        buf = torch.zeros((R, V, K + 1), dtype=torch.int32, device=dev)
        return lambda: buf.scatter_(2, tl, vals)

    # row_scatter_multi: the fused two-payload fill, (R, 2, P) -> (R, 2, A)
    sidx = t(synth.unique_targets(rng, R, P, A))
    svals = t(synth.adversarial_words(rng, (R, 2, P)))
    err, ms, pms, lms = compare(
        "row_scatter_multi",
        lambda: gather.row_scatter_multi(sidx, svals, A),
        lambda: gather.row_scatter_multi_plain(sidx, svals, A), 20, 20,
        library=scatter_library(sidx, svals, A))
    rows.append(dict(name="row_scatter_multi",
                     shape=[[R, P], [R, 2, P], [R, 2, A]], err=err, ms=ms,
                     plain_ms=pms, library_ms=lms,
                     bytes=scatter_bytes(sidx, 2, A),
                     ops=3 * R * P, per_batch=1,
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:475"))

    # the default batch's own fused fill: phase A's targets (ascending over
    # the emitting positions, the dropped sentinel A between them) and its
    # two payloads, captured from its phase_a
    fidx, fvals, fK = grab_calls(batch, ["row_scatter_multi"])[
        "row_scatter_multi"][0]
    err, ms, pms, lms = compare(
        "row_scatter_multi[batch]",
        lambda: gather.row_scatter_multi(fidx, fvals, fK),
        lambda: gather.row_scatter_multi_plain(fidx, fvals, fK), 20, 20,
        library=scatter_library(fidx, fvals, fK))
    rows.append(dict(name="row_scatter_multi[batch]",
                     counter="row_scatter_multi",
                     device_ms_in_batch=device_ms_in_batch(
                         lambda: gather.row_scatter_multi(fidx, fvals, fK),
                         (fidx, fvals)),
                     shape=[list(fidx.shape), list(fvals.shape),
                            [fidx.shape[0], fvals.shape[1], fK]],
                     err=err, ms=ms, plain_ms=pms, library_ms=lms,
                     bytes=scatter_bytes(fidx, fvals.shape[1], fK),
                     ops=3 * fidx.numel(), per_batch=1,
                     kept_targets=int(((fidx >= 0) & (fidx < fK)).sum()),
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:475"))
    del fidx, fvals

    # the narrow-dot TPU scatter (any payload count) has the wide one's
    # contract and the same wrapper: held here at three payloads.  The main
    # path never runs V = 3: the counter's launches are K2's (V = 2)
    s3vals = t(synth.adversarial_words(rng, (R, 3, P)))
    err, ms, pms, lms = compare(
        "row_scatter_multi[V=3]",
        lambda: gather.row_scatter_multi(sidx, s3vals, A),
        lambda: gather.row_scatter_multi_plain(sidx, s3vals, A), 20, 20,
        library=scatter_library(sidx, s3vals, A))
    rows.append(dict(name="row_scatter_multi[V=3]", counter="row_scatter_multi",
                     shape=[[R, P], [R, 3, P], [R, 3, A]], err=err, ms=ms,
                     plain_ms=pms, library_ms=lms,
                     bytes=scatter_bytes(sidx, 3, A),
                     ops=4 * R * P, per_batch=0, own_launches=0,
                     launches_are="row_scatter_multi at V = 2 (K2)",
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:385"))

    # row_scatter: the single-payload fill (fused_apk=False), (R, P) ->
    # (R, A); dropped targets (negative and >= A), top-bit payloads
    s1vals = svals[:, 0].contiguous()
    err, ms, pms, lms = compare(
        "row_scatter", lambda: gather.row_scatter(sidx, s1vals, A),
        lambda: gather.row_scatter_plain(sidx, s1vals, A), 20, 20,
        library=scatter_library(sidx, s1vals[:, None], A))
    rows.append(dict(name="row_scatter", shape=[[R, P], [R, P], [R, A]],
                     err=err, ms=ms, plain_ms=pms, library_ms=lms,
                     bytes=scatter_bytes(sidx, 1, A), ops=2 * R * P,
                     per_batch=1, source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:302"))

    # the contigs batch's own single-payload fill (its unpacked database
    # takes row_scatter), captured from its phase_a
    cidx, cvals, cK = grab_calls(ct_batch, ["row_scatter"])[
        "row_scatter"][0]
    err, ms, pms, lms = compare(
        "row_scatter[batch]", lambda: gather.row_scatter(cidx, cvals, cK),
        lambda: gather.row_scatter_plain(cidx, cvals, cK), 20, 20,
        library=scatter_library(cidx, cvals[:, None], cK))
    rows.append(dict(name="row_scatter[batch]", counter="row_scatter",
                     device_ms_in_batch=device_ms_in_batch(
                         lambda: gather.row_scatter(cidx, cvals, cK),
                         (cidx, cvals)),
                     shape=[list(cidx.shape), list(cvals.shape),
                            [cidx.shape[0], cK]],
                     err=err, ms=ms, plain_ms=pms, library_ms=lms,
                     bytes=scatter_bytes(cidx, 1, cK),
                     ops=2 * cidx.numel(), per_batch=1,
                     kept_targets=int(((cidx >= 0) & (cidx < cK)).sum()),
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:302"))
    del cidx, cvals

    # dp_chain_compact: chunked streams with segment-crossing chunks, and
    # the real default batch's own DP inputs (captured from its phase_a)
    L_CAP, band = args["L_CAP"], args["band"]
    dp_args = (band, args["pcl"], args["max_gap"], args["anchor_score"],
               L_CAP)
    grabbed = []
    k3 = device_pipeline.dp_chain_compact

    def grab(*a, **k):
        grabbed.append([x.clone() for x in a[:3]])
        return k3(*a, **k)

    device_pipeline.dp_chain_compact = grab
    try:
        phase_a(eng.db.arrays, ab, **args)
    finally:
        device_pipeline.dp_chain_compact = k3
    if len(grabbed) != 1 or list(grabbed[0][0].shape) != [R, A]:
        raise RuntimeError("dp_chain_compact: the default batch did not "
                           "call it once at its (R, A)")
    for key, ins in (("dp_chain_compact",
                      [t(x) for x in synth.dp_stream(rng, R, A, L_CAP)]),
                     ("dp_chain_compact[batch]", grabbed[0])):
        w1, w2, colc = ins
        err, ms, pms, _ = compare(
            key, lambda: dp_compact.dp_chain_compact(w1, w2, colc, *dp_args),
            lambda: dp_compact.dp_chain_compact_plain(w1, w2, colc,
                                                      *dp_args), 20, 2)
        # the profiler once read the batch's call at 0.4x its time: CUDA
        # events over back-to-back calls beside it (the kernel outlasts the
        # host's enqueue of the next call)
        ev_ms = back_to_back_ms(
            lambda: dp_compact.dp_chain_compact(w1, w2, colc, *dp_args), 20)
        w1_np, colc_np = w1.cpu().numpy(), colc.cpu().numpy()
        S = dp_compact.seg_len(A, L_CAP)
        lanes = (A // S) * R
        sms = rate["sms"]
        # the halo columns that the segment layout scans twice are the
        # kernel's cost, not the work's
        rows.append(dict(name=key, counter="dp_chain_compact",
                         shape=[[R, A]] * 3, err=err, ms=ms, plain_ms=pms,
                         library_ms=None, bytes=4 * 5 * R * A,
                         ops=_DP_OPS_PER_CANDIDATE
                         * dp_candidates(w1_np & 1, band), per_batch=1,
                         chain_steps=S + min(L_CAP, S), lanes=lanes,
                         # a block a lane, spread evenly
                         warps_per_sm={"mean": lanes / sms,
                                       "max": -(-lanes // sms)},
                         valid_anchors=int((w1_np & 1).sum()),
                         device_ms_events=ev_ms,
                         sass_per_step=sass.get("dp_compact_kernel"),
                         steps=compact_steps(w1_np, colc_np, S,
                                             min(L_CAP, S)),
                         k3_band=band,
                         source="skani_tpu_torch/csrc/dp_compact.cu",
                         replaces="skani_tpu/kernels/dp_compact.py:233"))
    del grabbed

    # dp_chain_packed: the default batch regrouped one lane per chunk,
    # (L_CAP, R * C_CAP); a lane without anchors, a full colinear lane,
    # validity holes, cross-contig neighbours, tied candidates
    RCp = R * args["C_CAP"]
    EB = int(np.ceil(np.log2(L_CAP)))
    pk_np = synth.padded_dp_case(rng, L_CAP, RCp, packed=True)
    pk = [t(x) for x in pk_np]
    pargs = (band, args["pcl"], args["max_gap"], args["anchor_score"], EB)
    err, ms, pms, _ = compare(
        "dp_chain_packed", lambda: dp_pallas.dp_chain_packed(*pk, *pargs),
        lambda: dp_pallas.dp_chain_packed_plain(*pk, *pargs), 20, 1)
    rows.append(dict(name="dp_chain_packed", shape=[[L_CAP, RCp]] * 2,
                     err=err, ms=ms, plain_ms=pms, library_ms=None,
                     device_ms_events=back_to_back_ms(
                         lambda: dp_pallas.dp_chain_packed(*pk, *pargs), 20),
                     steps=padded_steps(pk_np[0]),
                     bytes=4 * 3 * L_CAP * RCp,
                     ops=_DP_PACKED_OPS_PER_CANDIDATE
                     * dp_candidates((pk_np[0] & 1).T, band), per_batch=1,
                     chain_steps=L_CAP, lanes=RCp,
                     valid_anchors=int((pk_np[0] & 1).sum()),
                     ring=dp_compact.ring_size(band),
                     sass_per_step=sass.get(
                         "dp_chain_packed_kernel"
                         f"<{dp_compact.ring_regs(band)}>"),
                     source="skani_tpu_torch/csrc/dp_padded.cu",
                     replaces="skani_tpu/kernels/dp_pallas.py:414"))

    # expand_anchors at the default batch: rows that emit nothing, fill the
    # buffer exactly, run out of the window, and pass the buffer
    ex_np = synth.expand_case(rng, R, P, A)
    ex = [t(x) for x in ex_np]
    err, ms, pms, _ = compare(
        "expand_anchors", lambda: expand_pallas.expand_anchors(*ex, A),
        lambda: expand_pallas.expand_anchors_plain(*ex, A), 20, 5)
    eovf = expand_pallas.expand_anchors(*ex, A)[2].tolist()
    if eovf[:4] != [0, 0, 1, 0]:
        raise RuntimeError("expand_anchors: overflow flags are not those "
                           f"of the adversarial rows: {eovf[:4]}")
    rows.append(dict(name="expand_anchors",
                     shape=[[R, P]] * 3 + [[R], [R, A], [R, A], [R]],
                     err=err, ms=ms, plain_ms=pms, library_ms=None,
                     bytes=4 * (3 * R * P + R + 2 * R * A + R),
                     ops=_EXPAND_OPS_PER_SLOT * R * A, per_batch=1,
                     rows_flagged=int(sum(eovf)), chain_steps=A // 1024,
                     lanes=R, source="skani_tpu_torch/csrc/expand.cu",
                     replaces="skani_tpu/kernels/expand_pallas.py:105"))

    # dp_chain at the many-contig slow batch's padded domain (L_CAP, R *
    # C_CAP) and at the -c 20 batch's, ring 128 both.  The synthetic lanes
    # hold a valid prefix of uniform random length, which is more work than
    # the real batches have (most of their lanes are empty): the batches'
    # own times are in their profiles
    for key, (_ce, _cg, cargs, cab, _) in (("dp_chain", cs_batch),
                                           ("dp_chain[c20]", c20_batch)):
        Lc, RCc, cband = (cargs["L_CAP"],
                          int(cab.shape[1]) * cargs["C_CAP"], cargs["band"])
        up_np = synth.padded_dp_case(rng, Lc, RCc)
        up = [t(x) for x in up_np]
        uargs = (cband, cargs["pcl"], cargs["max_gap"],
                 cargs["anchor_score"])
        err, ms, pms, _ = compare(
            key, lambda: dp_pallas.dp_chain(*up, *uargs),
            lambda: dp_pallas.dp_chain_plain(*up, *uargs), 10, 1)
        rows.append(dict(name=key, counter="dp_chain",
                         shape=[[Lc, RCc]] * 3, err=err, ms=ms,
                         plain_ms=pms, library_ms=None,
                         bytes=4 * 5 * Lc * RCc,
                             ops=_DP_PADDED_OPS_PER_CANDIDATE
                         * dp_candidates((up_np[2] & 1).T, cband),
                         per_batch=1,
                         chain_steps=Lc, lanes=RCc,
                         valid_anchors=int((up_np[2] & 1).sum()),
                         ring=dp_compact.ring_size(cband),
                         sass_per_step=sass.get(
                             "dp_chain_kernel"
                             f"<{dp_compact.ring_regs(cband)}>"),
                         steps=padded_steps(up_np[2]),
                         source="skani_tpu_torch/csrc/dp_padded.cu",
                         replaces="skani_tpu/kernels/dp_pallas.py:240"))
        del up
    del pk, ex

    # --- the slow batch's shapes ---
    seng, _sgroup, sargs, sab, _ = slow_batch
    R, A, P, K, G = (int(sab.shape[1]), sargs["A"], seng.db.P, seng.db.K,
                     seng.db.G)

    # windowed_sorted_gather: the query-side apk gather, (R, P) table at
    # (R, A) nondecreasing indices, WB = 64; rows with an overflowing tile,
    # an end-clamped window, negative and past-the-end indices
    WB = 64
    wt_np, wi_np = synth.windowed_case(rng, R, P, A, WB)
    wt, wi = t(wt_np), t(wi_np)
    wi_in = t(np.clip(wi_np, 0, P - 1)).long()
    err, ms, pms, lms = compare(
        "windowed_sorted_gather",
        lambda: gather.windowed_sorted_gather(wt, wi, WB),
        lambda: gather.windowed_sorted_gather_plain(wt, wi, WB), 20, 10,
        library=lambda: torch.gather(wt, 1, wi_in))
    _o, wovf = gather.windowed_sorted_gather(wt, wi, WB)
    if not (bool(wovf[2]) and bool(wovf[3]) and not bool(wovf[0])
            and not bool(wovf[1])):
        raise RuntimeError("windowed_sorted_gather: overflow flags are not "
                           "those of the adversarial rows")
    tiles = wi_np.reshape(R, A // 1024, 1024)
    lo = np.clip(tiles.min(axis=2) >> 7, 0, P // 128 - WB) * 128
    rel = tiles - lo[:, :, None]
    inside = ((rel >= 0) & (rel < WB * 128)).reshape(R, A)
    rows.append(dict(name="windowed_sorted_gather", shape=[[R, P], [R, A]],
                     err=err, ms=ms, plain_ms=pms, library_ms=lms,
                     bytes=4 * 2 * R * A + 4 * R
                     + _SECTOR * _sectors(R, P, wi_np, inside),
                     ops=6 * R * A, per_batch=1,
                     rows_flagged=int(wovf.sum()),
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:179"))

    def gmap_bytes(skid_np, a_np, K):
        """Each distinct genome's skid row once, a_idx, the 32-byte jw
        sectors these indices touch, out."""
        R, P = a_np.size, skid_np.shape[1]
        return (4 * (np.unique(a_np).size * P + R + R * P)
                + _SECTOR * _sectors(R, K, skid_np[a_np]))

    # genome_map_gather: skid (G, P), a_idx (R,) with repeated genomes, jw
    # (R, K) -> (R, P); padding positions (skid == 0) in every genome
    skid_np = rng.integers(0, K, size=(G, P)).astype(np.int32)
    skid_np[:, P - 5000:] = 0
    a_np = np.sort(rng.integers(0, G, size=R)).astype(np.int32)
    a_np[:3] = a_np[0]
    skid, a_t = t(skid_np), t(a_np)
    jw = t(synth.adversarial_words(rng, (R, K)))
    err, ms, pms, lms = compare(
        "genome_map_gather",
        lambda: gather.genome_map_gather(skid, a_t, jw),
        lambda: gather.genome_map_gather_plain(skid, a_t, jw), 20, 20,
        library=lambda: torch.gather(jw, 1, skid[a_t.long()].long()))
    rows.append(dict(name="genome_map_gather",
                     shape=[[G, P], [R], [R, K], [R, P]], err=err, ms=ms,
                     plain_ms=pms, library_ms=lms,
                     bytes=gmap_bytes(skid_np, a_np, K),
                     ops=2 * R * P, per_batch=1,
                     dims={"G": G, "R": R, "P": P, "K": K,
                           "distinct_genomes": int(np.unique(a_np).size)},
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces="skani_tpu/kernels/gather_pallas.py:561"))

    # the genome-map gathers of the slow batch (its merge join's position
    # map; the row-affine launch) and of the -c 20 batch (R 29: one thread
    # a position), captured from their phase_a
    for gname, gbatch in (("genome_map_gather[batch]", slow_batch),
                          ("genome_map_gather[c20]", c20_batch)):
        gskid, ga, gjw = grab_calls(gbatch, ["genome_map_gather"])[
            "genome_map_gather"][0]
        ga_np = np.clip(ga.cpu().numpy(), 0, gskid.shape[0] - 1)
        gl = ga.long()
        err, ms, pms, lms = compare(
            gname, lambda: gather.genome_map_gather(gskid, ga, gjw),
            lambda: gather.genome_map_gather_plain(gskid, ga, gjw), 20, 20,
            library=lambda: torch.gather(gjw, 1, gskid[gl].long()))
        (gG, gP), (gR, gK) = gskid.shape, gjw.shape
        rows.append(dict(name=gname, counter="genome_map_gather",
                         device_ms_in_batch=device_ms_in_batch(
                             lambda: gather.genome_map_gather(gskid, ga,
                                                              gjw),
                             (gjw,)),
                         shape=[[gG, gP], [gR], [gR, gK], [gR, gP]],
                         err=err, ms=ms, plain_ms=pms, library_ms=lms,
                         bytes=gmap_bytes(gskid.cpu().numpy(), ga_np, gK),
                         ops=2 * gR * gP, per_batch=1,
                         dims={"G": gG, "R": gR, "P": gP, "K": gK,
                               "distinct_genomes":
                               int(np.unique(ga_np).size)},
                         source="skani_tpu_torch/csrc/gather.cu",
                         replaces="skani_tpu/kernels/gather_pallas.py:561"))
        del gskid, ga, gjw, gl

    # dp_chain_compact_wide at the slow batch's shape (ring 128); its plain
    # version walks S + H steps of ~50 launches each, so it runs once
    L_CAP, band = sargs["L_CAP"], sargs["band"]
    wide_np = synth.dp_stream_wide(rng, R, A, L_CAP)
    wide = [t(x) for x in wide_np]
    dp_args = (band, sargs["pcl"], sargs["max_gap"], sargs["anchor_score"],
               L_CAP)
    err, ms, pms, _ = compare(
        "dp_chain_compact_wide",
        lambda: dp_compact.dp_chain_compact_wide(*wide, *dp_args),
        lambda: dp_compact.dp_chain_compact_wide_plain(*wide, *dp_args),
        20, 1)
    S = dp_compact.seg_len(A, L_CAP)
    candidates = dp_candidates(wide_np[0] & 1, band)
    rows.append(dict(name="dp_chain_compact_wide",
                     shape=[[R, A]] * 4, err=err, ms=ms, plain_ms=pms,
                     library_ms=None, bytes=4 * 6 * R * A,
                     ops=_DP_WIDE_OPS_PER_CANDIDATE * candidates,
                     per_batch=1, chain_steps=S + min(L_CAP, S),
                     lanes=(A // S) * R, ring=dp_compact.ring_size(band),
                     sass_per_step=sass.get(
                         f"dp_wide_kernel<{dp_compact.ring_regs(band)}>"),
                     steps=compact_steps(wide_np[0], wide_np[3], S,
                                         min(L_CAP, S)),
                     source="skani_tpu_torch/csrc/dp_compact.cu",
                     replaces="skani_tpu/kernels/dp_compact.py:248"))
    # the other rings and the tag packing at a reduced shape: exactness
    # and a time each, no bound; bands 160 and 192 hold 5 and 6 registers
    # of slots (dp_wide_kernel<6> spills: its time beside its neighbours')
    variants = []
    for vband, vcap, tag in ((35, 512, False), (200, 512, False),
                             (20, 512, True), (160, 512, False),
                             (192, 512, False)):
        vin_np = synth.dp_stream_wide(rng, 8, 32768, vcap, tag=tag)
        vin = [t(x) for x in vin_np]
        vargs = (vband, sargs["pcl"], sargs["max_gap"],
                 sargs["anchor_score"], vcap)
        _e, vms, vpms, _ = compare(
            f"dp_chain_compact_wide[band {vband}]",
            lambda: dp_compact.dp_chain_compact_wide(*vin, *vargs),
            lambda: dp_compact.dp_chain_compact_wide_plain(*vin, *vargs),
            10, 1)
        variants.append({"band": vband, "ring": dp_compact.ring_size(vband),
                         "l_cap": vcap, "tag_packing": tag,
                         "shape": [8, 32768], "kernel_ms": vms,
                         "plain_ms": vpms, "max_abs_err": 0,
                         "sass_per_step": sass.get(
                             "dp_wide_kernel"
                             f"<{dp_compact.ring_regs(vband)}>"),
                         "steps": compact_steps(
                             vin_np[0], vin_np[3],
                             dp_compact.seg_len(32768, vcap),
                             min(vcap, dp_compact.seg_len(32768, vcap)))})

    # --- the microbenchmarks' Pallas kernels (K12), each by its contract
    # at its script's default shapes, on random int32 tables as the
    # scripts make them: nine gathers along the row (the row gather), one
    # along axis 0 of one tile (the row gather on the transposed tile),
    # one two-payload scatter onto unique targets (the multi scatter).
    # Rows that share a contract and inputs share one measurement
    k12 = "scripts/microbench_"
    for names, K, A, sort in (
            ((("gather_at", "round5.py:93"),
              ("gather_matsum", "round5.py:217"),
              ("gather_ablate", "round5.py:273")), 40960, 49152, False),
            ((("mxu_gather_i8", "phasea.py:100"),
              ("mxu_gather_bw", "phasea.py:151")), 40960, 49152, True),
            ((("gather_taa", "gather2.py:62"),
              ("gather_take", "gather2.py:89")), 126208, 40960, False),
            ((("g_a1", "gather3.py:73"), ("g_blk", "gather3.py:91")),
             126208, 126208, False)):
        R = 32
        tab_np = rng.integers(-(1 << 31), 1 << 31, (R, K),
                              dtype=np.int64).astype(np.int32)
        idx_np = rng.integers(0, K, (R, A)).astype(np.int32)
        if sort:
            idx_np = np.sort(idx_np, axis=1)
        tab, idx = t(tab_np), t(idx_np)
        idx_l = idx.long()
        key = "K12 " + "/".join(n for n, _ in names)
        err, ms, pms, lms = compare(
            key, lambda: gather.row_gather(tab, idx),
            lambda: gather.row_gather_plain(tab, idx), 20, 20,
            library=lambda: torch.gather(tab, 1, idx_l))
        if not np.array_equal(gather.row_gather(tab, idx).cpu().numpy(),
                              np.take_along_axis(tab_np, idx_np, axis=1)):
            raise RuntimeError(f"{key}: differs from take_along_axis")
        for n, rep in names:
            rows.append(dict(
                name=f"K12 {n}", counter="row_gather", timing=key,
                shape=[[R, K], [R, A]], err=err, ms=ms, plain_ms=pms,
                library_ms=lms, per_batch=0,
                bytes=4 * 2 * R * A + _SECTOR * _sectors(R, K, idx_np),
                ops=2 * R * A, source="skani_tpu_torch/csrc/gather.cu",
                replaces=k12 + rep))
        del tab, idx, idx_l
    # g_a0: take_along_axis along axis 0 of one (512, 128) tile
    tab_np = rng.integers(-(1 << 31), 1 << 31, (512, 128),
                          dtype=np.int64).astype(np.int32)
    idx_np = rng.integers(0, 512, (512, 128)).astype(np.int32)
    tab_t, idx_t = t(tab_np.T), t(idx_np.T)
    tab, idx_l = t(tab_np), t(idx_np).long()
    err, ms, pms, lms = compare(
        "K12 g_a0", lambda: gather.row_gather(tab_t, idx_t).T,
        lambda: gather.row_gather_plain(tab_t, idx_t).T, 20, 20,
        library=lambda: torch.gather(tab, 0, idx_l))
    if not np.array_equal(gather.row_gather(tab_t, idx_t).T.cpu().numpy(),
                          np.take_along_axis(tab_np, idx_np, axis=0)):
        raise RuntimeError("K12 g_a0: differs from take_along_axis")
    rows.append(dict(name="K12 g_a0", counter="row_gather",
                     shape=[[512, 128], [512, 128]], err=err, ms=ms,
                     plain_ms=pms, library_ms=lms, per_batch=0,
                     bytes=4 * 3 * 512 * 128, ops=2 * 512 * 128,
                     source="skani_tpu_torch/csrc/gather.cu",
                     replaces=k12 + "gather3.py:116"))
    # scatter_pc: (32, 2, 40960) payloads onto a permutation's first 40960
    # targets of 49152
    R, P, A = 32, 40960, 49152
    tgt_np = np.stack([rng.permutation(A)[:P] for _ in range(R)]
                      ).astype(np.int32)
    sv_np = rng.integers(-(1 << 31), 1 << 31, (R, 2, P),
                         dtype=np.int64).astype(np.int32)
    ref = np.zeros((R, 2, A), np.int32)
    for r in range(R):
        ref[r][:, tgt_np[r]] = sv_np[r]
    tgt, sv = t(tgt_np), t(sv_np)
    err, ms, pms, lms = compare(
        "K12 scatter_pc", lambda: gather.row_scatter_multi(tgt, sv, A),
        lambda: gather.row_scatter_multi_plain(tgt, sv, A), 20, 20,
        library=scatter_library(tgt, sv, A))
    if not np.array_equal(gather.row_scatter_multi(tgt, sv, A).cpu().numpy(),
                          ref):
        raise RuntimeError("K12 scatter_pc: differs from the reference")
    rows.append(dict(name="K12 scatter_pc", counter="row_scatter_multi",
                     shape=[[R, P], [R, 2, P], [R, 2, A]], err=err, ms=ms,
                     plain_ms=pms, library_ms=lms, per_batch=0,
                     bytes=scatter_bytes(tgt, 2, A),
                     ops=3 * R * P, source="skani_tpu_torch/csrc/gather.cu",
                     replaces=k12 + "round5.py:155"))
    # one lane's step chain alone (one warp on the card), 2048 valid
    # anchors in one chunk, band 83: the latency of a step
    lane = {}
    qp1 = np.cumsum(rng.integers(1, 4, size=(1, 2048)), axis=1)
    one = [t(x.astype(np.int32)) for x in (
        qp1 * 4 + 1, qp1 + 1000, np.zeros((1, 2048)), np.arange(2048)[None])]
    one_t = [t(x.T.astype(np.int32)) for x in (
        qp1, qp1 + 1000, np.ones((1, 2048)))]
    clock = rate["max_sm_clock_mhz"] * 1e6
    for key, fn in (
            ("dp_chain_compact_wide", lambda: dp_compact.dp_chain_compact_wide(
                *one, 83, 2500, 300, 20, 1024)),
            ("dp_chain", lambda: dp_pallas.dp_chain(*one_t, 83, 2500, 300,
                                                     20))):
        ms = cuda_ms(fn, 10)
        lane[key] = {"ms": ms, "ns_per_step": ms * 1e6 / 2048,
                     "cycles_per_step": ms * 1e-3 * clock / 2048}
    # the SMs' issue rate on the DP rows: their lanes' steps times the SASS
    # instructions of a step (K3: of its phases) over the device time, per
    # SM and cycle
    for r in rows:
        st, sp = r.get("steps"), r.get("sass_per_step")
        if not (st and sp and dev_ms.get(r["name"])):
            continue
        if "k3_band" in r:
            per_lane = k3_sass_per_lane(st, sp, r["k3_band"])
            cols = st["scanned_mean"]
            if per_lane is None and sp.get("step"):
                # a kernel of one step a column over all S + H columns
                per_lane, cols = r["chain_steps"] * sp["step"], \
                    r["chain_steps"]
            if per_lane is None:
                continue
            r["sass_per_column"] = per_lane / cols
        else:
            per_lane = st["anchor_steps_mean"] * sp
        r["issue_per_sm_cycle"] = (
            st["lanes"] * per_lane
            / (dev_ms[r["name"]] * 1e-3 * rate["sms"] * clock))
    for r in rows:
        t_bytes = r["bytes"] / bw * 1e3
        t_ops = r["ops"] / rate["ops_per_s"] * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        key = r.get("timing", r["name"])
        r["device_ms"] = dev_ms[key]
        r["device_ms_source"] = dev_src[key]
        r.setdefault("counter", r["name"])
        r["library_device_ms"] = lib_dev_ms.get(key)
        r["library_device_ms_source"] = lib_dev_src.get(key)
        emit({"kernel": r["name"], "shape": r["shape"],
              "kernel_ms": r["ms"], "device_ms": r["device_ms"],
              "device_ms_source": r["device_ms_source"],
              "device_ms_events": r.get("device_ms_events"),
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "library_device_ms": r["library_device_ms"],
              "library_device_ms_source": r["library_device_ms_source"],
              "bound_ms": r["bound_ms"],
              "bound_by": r["bound_by"], "bytes": int(r["bytes"]),
              "bytes_bound_ms": t_bytes, "ops": int(r["ops"]),
              "ops_bound_ms": t_ops,
              "launches_per_batch": r["per_batch"],
              "chain_steps": r.get("chain_steps"), "ring": r.get("ring"),
              "lanes": r.get("lanes"),
              "valid_anchors": r.get("valid_anchors"),
              "rows_flagged": r.get("rows_flagged"),
              "sass_per_step": r.get("sass_per_step"),
              "sass_per_column": r.get("sass_per_column"),
              "steps": r.get("steps"),
              "warps_per_sm": r.get("warps_per_sm"),
              "issue_per_sm_cycle": r.get("issue_per_sm_cycle"),
              "sites": r.get("sites"), "before_ms": r.get("before_ms"),
              "before_device_ms": r.get("before_device_ms"),
              "dims": r.get("dims"), "kept_targets": r.get("kept_targets"),
              "device_ms_in_batch": r.get("device_ms_in_batch"),
              "own_launches": r.get("own_launches"),
              "launches_are": r.get("launches_are"), "card": name})
    return rows, {"kernels_checked": len(rows), "tolerance": 0,
                  "one_lane_step": lane,
                  "dp_chain_compact_wide_variants": variants}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=20261016)
    ap.add_argument("--genomes", type=int, default=32)
    ap.add_argument("--length", type=int, default=5_000_000)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate = int32_rate()
    emit({"phase": "probe", "nvidia_smi": smi, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "int32_rate": rate})
    bw = bandwidth(name)
    sass = build()
    # launch counts by path: each path is driven with the counts set to 0
    # just before it and read just after
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="skani_smoke_") as tmp:
        sets = make_data(tmp, a.seed, a.genomes, a.length)
        for preset in _RUNS:
            key = "triangle" if preset == "default" \
                else f"triangle_{preset}"
            by_path[key] = phase(key)(triangle)(tmp, sets, preset)
        batches = {}
        for preset in _RUNS:
            key = "phase_a" if preset == "default" else f"phase_a_{preset}"
            batches[preset] = phase(key)(phase_a_parity)(
                sets, preset, preset == "default")
        batch = batches["default"]
        by_path["padded"] = padded(batch, sets, a.seed)
    by_path["joins"] = joins(batch)
    rows = kernels(batch, batches["slow"], batches["contigs"],
                   batches["contigs_slow"], batches["c20"], bw, rate, sass,
                   name)
    table = []
    for r in rows:
        n = {k: v[r["counter"]] for k, v in by_path.items()
             if v.get(r["counter"])}
        if not n:
            raise RuntimeError(f"{r['name']} was launched on no path")
        row = {"name": r["name"], "route": "cuda", "source": r["source"],
               "replaces": r["replaces"], "counter": r["counter"],
               "launches": sum(n.values()),
               "launches_by_path": n, "max_abs_err": r["err"],
               "ms": r["ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"], "device_ms": r["device_ms"],
               "device_ms_source": r["device_ms_source"],
               "library_device_ms": r["library_device_ms"],
               "library_device_ms_source": r["library_device_ms_source"]}
        for k in ("device_ms_events", "sass_per_step", "sass_per_column",
                  "steps", "lanes", "warps_per_sm", "issue_per_sm_cycle",
                  "sites", "before_ms", "before_device_ms", "dims",
                  "own_launches", "launches_are", "device_ms_in_batch"):
            if r.get(k) is not None:
                row[k] = r[k]
        table.append(row)
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
