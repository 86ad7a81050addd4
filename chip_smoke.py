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
   Every phase but `hybrid` runs on the device-only route
   (SKANI_TPU_EXECUTOR=tpu, SKANI_TPU_HOST_WORKERS=0: every pair list on
   the device engine, no host steal-worker), as the phases of the slices
   before the hybrid executor did.
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
3b. triangle_sketch — `python -m skani_tpu_torch sketch
             --separate-sketches` on the default run's 16 genomes, then
             `triangle --sparse --detailed` on the `.sketch` files on the
             device executor (launch counters set to 0 just before, read
             just after): its TSV must be byte-identical to the default
             run's device and native TSVs; `sketch_s` of both inputs.
3b'. hybrid — the executor's routes on the first run's 16 genomes, CLI
             `triangle --sparse --detailed` at the default preset and at
             `--slow`, three routes in turns over two rounds (device,
             hybrid, native, then the reverse): device only; the defaults
             (the small-batch route and min(2, cores - 2) host
             steal-workers in run_pairs); native at `-t` = cores.  One
             line a run (wall, pairs given to the engines and to the host
             executor, pairs_device / pairs_host / pairs_mirrored /
             pairs_overflow, device batches, the driver's split, kernels
             launched), then the phase line: cores, the worker count in
             effect, walls and pairs/s by route, the hybrid runs' split.
             Then `dist` of one pair and `triangle` of 4 genomes on
             native, the defaults (no device batch: the small-batch
             route) and SKANI_TPU_MIN_PAIRS=0 (device batches).  Fails
             where a TSV differs from native, where on a device route
             pairs_device + pairs_host + pairs_mirrored differs from the
             pairs given to the engines, where a device route scores no
             pair on the card or launches no kernel of its preset's path.
             The hybrid runs' launches are the `hybrid` path's (counters
             at 0 just before each run, read just after).
3c. search — `python -m skani_tpu_torch sketch` of 64 references from
             three bases (the base set's 32 genomes, 16 genomes of a third
             base from seed + 2, the contigs set's 16 drafts) in both
             layouts (a consolidated database and separate `.sketch`
             files), then `search` of 8 queries that are not in it (two
             1 % mutants of each base, two unrelated genomes) through the
             CLI's parser and engine.search, on the native executor on
             each layout and three times on the device (launch counters
             set to 0 just before each, read just after, under `search`,
             `search_paged` and `search_windowed`): on the consolidated
             database resident at the defaults (one page; the drafts make
             it `sorted`) and resident in at least 4 pages under an LRU of
             2 with 2 reserved query rows and one query a window (pages of
             few-contig genomes take `sorted_packed` with the merge join;
             pages re-upload); on the separate-sketch database windowed.
             Each TSV must be byte-identical to the native one on the same
             database; pages, uploads, pairs screened / on the device /
             overflowed, the driver's split and the CUDA-event ms of one
             update_rows chunk (the queries that hit the resident page,
             into its reserved rows).  The default run's page and a
             `sorted_packed` page that the paged run left resident each
             give the kernel table their first batch.
3d. triangle_aai — `sketch -a --separate-sketches` of 8 genomes of 1 Mbp
             (a fifth of the other phases' width: the AA seeder is numpy
             on the host, 40-51 s for these 8 Mbp on an 8-core H100
             host) mutated 1-15 % from a base of their
             own, then `triangle -a --sparse --detailed` on the `.sketch`
             files on the device (counters under `triangle_aai`) and on
             the native executor: byte-identical, at least one pair
             finished on the device; the legacy generator at per-chunk cap
             768, the padded DP at band 33.  Which cap the overflowing
             pairs hit, from the batch's readback and from phase_a again
             with L_CAP or I_CAP doubled.
3e. search_aai — `search` of three of triangle_aai's `.sketch` files (no
             AA seeding again) on that phase's separate-sketch database
             (windowed) and on a consolidated database of the same
             sketches written by the `sketch` subcommand's writer
             (resident: `legacy` pages with reserved query rows), each on
             the device and on the native executor: byte-identical
             (counters under `search_aai`, `search_aai_windowed`).
3f. seeding — device seeding (kernels/seeding.py, csrc/seeding.cu): the
             kernels against their plain version at max abs err 0 on
             edge contigs (lengths about 42, lowercase, N runs, IUPAC
             bytes, a tandem repeat) at four (k, c); the sketch stage of
             the first 8, 16, 32 and 64 of the search phase's 64
             references through the device route and the native one at
             `-t` = cores, in turns, every sketch equal array for array,
             with the device route's split (waiting for reads, the
             batch, the finalize), beside the CUDA start-up of a fresh
             process (what the `sketch` subcommand pays): the sweep that
             sets
             sketch.DEVICE_SEED_MIN_BASES; a CLI `triangle` of the fewest
             sweep genomes whose bases reach it, so that its sketch
             stage takes the card by the rule (counters under `seeding`),
             byte-identical to native, whose native run seeds nothing on
             the card; the kernel row on that triangle's first window of
             contigs (256 M bases): both launches' device ms, and each
             launch's SASS a window (the count launch's rolling 21-mer,
             the write launch's survivors).
3g. fleet — the one-host multi-GPU path on ["cuda:0", "cuda:0"] (two
             engines share the one card): the default run's triangle
             through ShardedPairFleet and ShardedMarkerScreen, and the
             windowed `search` on the separate-sketch database through
             the fleet, each TSV byte-identical to native (counters under
             `fleet_triangle`, `fleet_search`).
3h. multihost — the multi-host launch (multihost.py) as two processes on
             this card, each a `python -c` that joins the group from
             SKANI_TPU_COORDINATOR (gloo on 127.0.0.1 at a free port) /
             SKANI_TPU_NUM_PROCS / SKANI_TPU_PROC_ID, then runs cli.main:
             the default run's triangle (rank 0's TSV byte-identical to
             native, rank 1 writes none; K1 K2 K3 launched, counters under
             `multihost_triangle`), and `search` of the 8 queries on a
             `sketch --shards 2` database of the 64 references (rank 0's
             TSV byte-identical to native on it, each rank reading full
             seeds only for the references it owns; K1 K5 K6 K8 under
             `multihost_search`); each wall beside the single-process
             wall of the same run.  A rank that fails or runs past its
             timeout fails the smoke.
3i. bench  — bench_torch.py's four tiers (main, distant, search, cli) on
             the card at a cut depth (16, 12, 128 and 8 genomes; printed
             as `depth`), under the defaults (host steal-workers, the
             small-batch route): its JSON object in the phase line;
             fails unless mismatches is 0, device_only is above 0 and
             every tier ran (counters under `bench`; the cli tier's
             subprocesses count in their own processes).
3j. scale  — the scale demos of skani_tpu_torch/tools on the device-only
             route: mag_scale_demo's 2 x 65 Mbp single-contig pair (the
             unpacked `sorted` generator, P >= 2^19: the split gathers,
             bucket-scaled caps; both orientations cold and warm, each
             equal to native on all five fields), search_scale_demo on a
             DB of 256 genomes of 150 kb (cold, warm and native rows
             equal; bytes uploaded, pages, peak RSS) and
             triangle_scale_demo on 64 genomes of 40 kb (TSV
             byte-identical to native); counters under `scale`, each
             demo's own in its part of the line.
3k. tools  — the measuring tools of skani_tpu_torch/tools on the
             device-only route: profile_phase_a (every stage prefix of
             phase_a: best wall, host enqueue, launches; the sync floor)
             and profile_host_stage (dispatch cold and warm, the Python
             and native host stage on one readback, which must agree on
             nine fields; the native path's cProfile) on the first batch
             of the bench default (14 genomes of 5 Mbp) and of 20 genomes
             of 150 kb (192 rows: the widened batch); soak_fuzz for a
             minute (no mismatching pair); scaling_probe at 1, 2 and 4
             engines on cuda:0 over 10 genomes of 1 Mbp (results equal to
             one engine's); counters under `tools`.
4. phase_a — the first device batch of each of those runs on the GPU; the
             default one also on the CPU (plain kernel versions): packed
             outputs must be bit-identical.
4b. padded — the default first batch through `phase_a(compact_dp=False)`
             (the packed padded DP `dp_chain_packed`): rows that flag no
             overflow must equal the default call's; the first batch of
             every `sorted_packed` run (default, medium, slow, `-c 20`)
             through `phase_a(expand_kernel=True)` (`expand_anchors`)
             where its shapes allow, the same check, then both paths in
             turns (default, kernel, kernel, default): batch ms, kernels a
             batch and the device ms of the expansion (phase_a's kernel
             time to stage 35 less that to stage 30); the `sorted` and
             `legacy` generators on small batches, CUDA against CPU; and
             the few-contig slow set through engines with per-chunk caps
             1024 and 2048 (overflow counts, batch time).
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
             many-contig slow batch's domain, at the `-c 20` batch's and
             on the AAI batch's own call (`dp_chain[aai]`); every call
             of the row gather, the genome-map gather, the fill scatter
             and the compact DP in the first batch of the resident
             `search` page and of the paged run's `sorted_packed` page
             (`[search]`, `[search_paged]`: reserved query rows, the row
             map reading them); the
             DP rows carry their SASS instructions per step (the 2-plane
             compact DP's per phase) and the steps their lanes take.  Then
             the expansion kernel at the default batch's shapes and on the
             `--medium`, slow and `-c 20` batches' own calls, beside
             torch.searchsorted of the slots in offs (its count alone) for
             scale.  Then
             the microbenchmarks' Pallas kernels (scripts/microbench_*.py,
             "K12"), each by its contract at its script's default shapes
             through the kernel that computes it: the row gather (nine
             gathers along the row and one along axis 0 of a (512, 128)
             tile, transposed) and the multi-payload scatter, against
             numpy's take_along_axis and the script's scatter reference.
             The seeding kernels' row comes from the seeding phase.

The line before the last is the kernel table as one JSON object, the last
line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import argparse
import contextlib
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
# expand_anchors per output slot: an 11-step binary search of the tile's
# sources (compare, select, halve: 3 each) and about 7 for the fetch and the
# row
_EXPAND_OPS_PER_SLOT = 40
# repeat copies of the synthetic bases
_COPIES = (2, 4, 8, 200)
# the TPU kernel each kernel counter's wrapper replaces
_REPLACES = {
    "row_gather": "skani_tpu/kernels/gather_pallas.py:601",
    "genome_map_gather": "skani_tpu/kernels/gather_pallas.py:561",
    "row_scatter": "skani_tpu/kernels/gather_pallas.py:302",
    "row_scatter_multi": "skani_tpu/kernels/gather_pallas.py:475",
    "dp_chain_compact": "skani_tpu/kernels/dp_compact.py:233",
    "dp_chain_compact_wide": "skani_tpu/kernels/dp_compact.py:248"}
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


# the device-only route every phase but `hybrid` runs on: every pair list
# on the device engine, no host steal-worker (the route of PR 1-12's
# phases, so that their launch counts and times stay comparable)
_DEVICE_ONLY = {"SKANI_TPU_EXECUTOR": "tpu", "SKANI_TPU_HOST_WORKERS": "0"}


def device_route() -> None:
    os.environ.update(_DEVICE_ONLY)


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


# the SASS opcodes that issue on the 64-lane integer pipe only (IMAD and
# its moves issue on the FMA pipes; U-prefixed ones once a warp)
_INT_ALU = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "POPC",
            "FLO", "BMSK", "IMNMX", "IABS", "BREV", "PLOP3", "VIADD",
            "VIMNMX"}
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


def _op(txt: str) -> str:
    """The opcode of one SASS instruction (after its predicate)."""
    return txt.split()[1] if txt.startswith("@") else txt.split()[0]


def _sass_count(txts) -> dict:
    """Every instruction of `txts` (no NOP), and those of the 64-lane
    integer pipe alone."""
    ops = [_op(t) for t in txts]
    return {"instructions": sum(1 for o in ops if o != "NOP"),
            "int_alu": sum(1 for o in ops if o.split(".")[0] in _INT_ALU)}


def seed_sass(ins) -> dict:
    """A seeding kernel's SASS: the code outside loops (run once a thread:
    a thread owns 32 windows) and each loop's body, by what it does: the
    count launch's staging loop (it stores to shared memory), the write
    launch's survivor loop (it stores to device memory), and the rest
    (thread 0's contig search, the warp offsets)."""
    loops = _sass_loops(ins)
    inside = set()
    by_kind = {}
    for lo, hi, txts in loops:
        inside.update(a for a, _t in ins if lo <= a <= hi)
        ops = [_op(t).split(".")[0] for t in txts]
        kind = ("stage" if "STS" in ops else "survivor" if "STG" in ops
                else "other")
        c = _sass_count(txts)
        prev = by_kind.get(kind)
        by_kind[kind] = c if prev is None else {
            k: prev[k] + c[k] for k in c}
    return dict(_sass_count([t for a, t in ins if a not in inside]),
                loops=by_kind)


def sass_step_counts(so: str, nvcc: str) -> dict:
    """SASS instructions of one DP step per kernel instance of the library
    `so` (cuobjdump -sass): the span of the innermost backward branch
    whose loop holds a warp max (REDUX), keyed "name<N>"; K3's by phase
    (k3_phase_counts); the seeding kernels' whole bodies (one thread is
    one window)."""
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
        if name is not None and name.startswith("seed_"):
            out[name] = seed_sass(ins)
            continue
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


def host_ms(fn, reps: int) -> float:
    """Median host time of fn() over `reps` calls."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
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
                                         expand_pallas, gather, seeding)
    return (gather.LAUNCHES, dp_compact.LAUNCHES, dp_pallas.LAUNCHES,
            expand_pallas.LAUNCHES, seeding.LAUNCHES)


def reset_launches():
    for d in _counters():
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    from skani_tpu_torch.tools.common import kernel_launches
    return kernel_launches()


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
    device_route()
    reset_launches()
    dev_wall, dev_stats = _triangle(base + ["-o", dev_tsv])
    launches = read_launches()
    os.environ["SKANI_TPU_EXECUTOR"] = "native"
    try:
        nat_wall, nat_stats = _triangle(base + ["-o", nat_tsv])
    finally:
        device_route()
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
    _FASTA_SKETCH_S[preset] = dev_stats.get("sketch_s", 0.0)
    _DEVICE_WALL_S[preset] = dev_wall
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


# the hybrid phase's three routes: device only, the defaults (the small-
# batch route and min(2, cores - 2) host steal-workers), native at -t =
# cores; each run sets its route's variables and removes the other ones
_HYBRID_ROUTES = {
    "device": dict(_DEVICE_ONLY),
    "hybrid": {},
    "native": {"SKANI_TPU_EXECUTOR": "native"}}
_HYBRID_VARS = ("SKANI_TPU_EXECUTOR", "SKANI_TPU_HOST_WORKERS",
                "SKANI_TPU_MIN_PAIRS")
# each preset's rounds, its routes in turns (device, hybrid, native, then
# the reverse)
_HYBRID_PRESETS = ("default", "slow")
_HYBRID_ROUNDS = 2


def _set_route(env) -> None:
    for k in _HYBRID_VARS:
        os.environ.pop(k, None)
    os.environ.update(env)


@contextlib.contextmanager
def _pairs_given():
    """Counts the pairs handed to the device engines' run_pairs and to the
    exact host executor while it is entered (the class and module
    attributes wrapped, restored on exit)."""
    from skani_tpu_torch import engine
    from skani_tpu_torch.kernels.device_pipeline import DevicePairEngine
    n = {"engine": 0, "host": 0}
    run, host = DevicePairEngine.run_pairs, engine._default_pair_executor

    def run_counted(eng, pairs, *a, **k):
        n["engine"] += len(pairs)
        return run(eng, pairs, *a, **k)

    def host_counted(refs, queries, pairs, *a):
        n["host"] += len(pairs)
        return host(refs, queries, pairs, *a)

    DevicePairEngine.run_pairs = run_counted
    engine._default_pair_executor = host_counted
    try:
        yield n
    finally:
        DevicePairEngine.run_pairs = run
        engine._default_pair_executor = host


def _hybrid_run(argv, tsv, env, **info):
    """One CLI run on one route: prints its line (wall, the route's pair
    split, batches, kernels launched) and returns it with its TSV bytes."""
    _set_route(env)
    reset_launches()
    with _pairs_given() as given:
        wall, st = _triangle(argv + ["-o", tsv])
    launches = read_launches()
    with open(tsv, "rb") as f:
        got = f.read()
    line = dict(info, wall_s=wall, pairs_given=dict(given),
                **{k: int(st.get(k, 0)) for k in (
                    "pairs_device", "pairs_host", "pairs_mirrored",
                    "pairs_overflow", "device_batches")},
                split_s={k: st.get(k + "_s", 0.0) for k in _SPLIT},
                launches={k: v for k, v in launches.items() if v})
    emit({"hybrid_run": line})
    return line, got, launches


@phase("hybrid")
def hybrid(tmp, sets):
    """The executor's hybrid route against device only and native: CLI
    `triangle --sparse --detailed` of the base set's 16 genomes at the
    default preset and at `--slow`, the three routes in turns, two rounds;
    then `dist` of one pair and `triangle` of 4 genomes under the defaults
    (the small-batch route: no device batch) and at SKANI_TPU_MIN_PAIRS=0
    (device batches).  Every TSV must be native's bytes; on the device
    routes every pair given to the engines is scored once (device, host
    worker or mirror); the hybrid route must score pairs on the card.
    The hybrid runs' launches are the `hybrid` path's."""
    from skani_tpu_torch.kernels.device_pipeline import default_host_workers
    _set_route(_HYBRID_ROUTES["hybrid"])
    workers = default_host_workers()
    hyb = {k: 0 for k in read_launches()}
    info = {"cores": os.cpu_count(), "host_workers": workers,
            "genomes": 16, "presets": {}}
    try:
        for preset in _HYBRID_PRESETS:
            argv = _argv(sets, preset)
            want, runs = None, {r: [] for r in _HYBRID_ROUTES}
            for rnd in range(_HYBRID_ROUNDS):
                order = list(_HYBRID_ROUTES)
                for route in (order if rnd % 2 == 0 else order[::-1]):
                    tsv = os.path.join(tmp, f"hybrid_{preset}_{route}.tsv")
                    line, got, launches = _hybrid_run(
                        argv, tsv, _HYBRID_ROUTES[route], preset=preset,
                        route=route, round=rnd)
                    if route == "native":
                        want = want or got
                    runs[route].append((line, got, launches))
            for route, rs in runs.items():
                for line, got, launches in rs:
                    if got != want:
                        raise RuntimeError(f"hybrid {preset} {route}: the "
                                           f"TSV differs from native")
                    if route == "native":
                        continue
                    routed = line["pairs_device"] + line["pairs_host"] \
                        + line["pairs_mirrored"]
                    if routed != line["pairs_given"]["engine"]:
                        raise RuntimeError(
                            f"hybrid {preset} {route}: device + host + "
                            f"mirrored = {routed}, pairs scored "
                            f"{line['pairs_given']['engine']}")
                    if line["pairs_device"] <= 0:
                        raise RuntimeError(f"hybrid {preset} {route}: no "
                                           f"pair scored on the card")
                    missing = [k for k in _RUNS[preset]["must"]
                               if launches[k] <= 0]
                    if missing:
                        raise RuntimeError(
                            f"hybrid {preset} {route}: kernels of the path "
                            f"never launched: {missing}")
                    if route == "hybrid":
                        for k, v in launches.items():
                            hyb[k] += v
            n = runs["native"][0][0]["pairs_given"]["host"]
            info["presets"][preset] = {
                "pairs": n, "tsv_identical": True,
                "tsv_rows": len(want.splitlines()) - 1,
                **{f"{r}_wall_s": [x[0]["wall_s"] for x in rs]
                   for r, rs in runs.items()},
                **{f"{r}_pairs_per_s": [n / x[0]["wall_s"] for x in rs]
                   for r, rs in runs.items()},
                "hybrid_split": [{k: x[0][k] for k in (
                    "pairs_device", "pairs_host", "pairs_mirrored",
                    "device_batches")} for x in runs["hybrid"]]}
        # the small-batch route: one pair, then 4 genomes
        small = {}
        for name, argv in (
                ("dist_1", ["dist", sets["base"][0], sets["base"][1],
                            "-t", str(os.cpu_count())]),
                ("triangle_4", ["triangle", *sets["base"][:4], "--sparse",
                                "--detailed", "-t", str(os.cpu_count())])):
            out = {}
            for route, env in (("native", _HYBRID_ROUTES["native"]),
                               ("defaults", {}),
                               ("min_pairs_0", {"SKANI_TPU_MIN_PAIRS": "0"})):
                tsv = os.path.join(tmp, f"hybrid_{name}_{route}.tsv")
                out[route] = _hybrid_run(argv, tsv, env, run=name,
                                         route=route)
            for route in ("defaults", "min_pairs_0"):
                if out[route][1] != out["native"][1]:
                    raise RuntimeError(f"hybrid {name} {route}: the TSV "
                                       f"differs from native")
            batches = {r: out[r][0]["device_batches"]
                       for r in ("defaults", "min_pairs_0")}
            if batches["defaults"] != 0 or batches["min_pairs_0"] <= 0:
                raise RuntimeError(f"hybrid {name}: device batches "
                                   f"{batches}: the small-batch route "
                                   f"did not hold")
            small[name] = {"pairs": out["native"][0]["pairs_given"]["host"],
                           "device_batches": batches,
                           "wall_s": {r: out[r][0]["wall_s"] for r in out}}
        info["small_batch_route"] = small
    finally:
        device_route()
    return hyb, info


# the device run's sketch_s and wall of each triangle on FASTA inputs
_FASTA_SKETCH_S = {}
_DEVICE_WALL_S = {}


@phase("triangle_sketch")
def triangle_sketch(tmp, sets):
    """`sketch --separate-sketches` of the default run's genomes through
    `python -m skani_tpu_torch`, then its triangle on the `.sketch` files
    on the device executor: the TSV must be the default run's bytes."""
    run = _RUNS["default"]
    paths = sets[run["set"]][:run["depth"]]
    out = os.path.join(tmp, "sketches")
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "skani_tpu_torch", "sketch",
                        "--separate-sketches", *paths, "-o", out, "-t",
                        str(os.cpu_count())], capture_output=True, text=True,
                       env=env, timeout=600)
    sketch_cmd_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"triangle_sketch: sketch failed\n"
                           f"{r.stderr[-2000:]}")
    sk_paths = [os.path.join(out, os.path.basename(p) + ".sketch")
                for p in paths]
    tsv = os.path.join(tmp, "device_sketch.tsv")
    device_route()
    reset_launches()
    wall, st = _triangle(["triangle", *sk_paths, "--sparse", "--detailed",
                          "-t", str(os.cpu_count()), "-o", tsv])
    launches = read_launches()
    with open(tsv, "rb") as f:
        got = f.read()
    for who in ("device", "native"):
        with open(os.path.join(tmp, f"{who}_default.tsv"), "rb") as f:
            if f.read() != got:
                raise RuntimeError(f"triangle_sketch: the TSV on .sketch "
                                   f"inputs differs from the {who} TSV on "
                                   f"FASTA inputs")
    pairs_dev = int(st.get("pairs_device", 0))
    if pairs_dev <= int(st.get("pairs_overflow", 0)):
        raise RuntimeError("triangle_sketch: no pair was finished by the "
                           "device engine")
    missing = [k for k in run["must"] if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"triangle_sketch: kernels of the path never "
                           f"launched: {missing} ({launches})")
    return launches, {
        "genomes": len(paths), "tsv_identical": True,
        "tsv_rows": len(got.splitlines()) - 1, "pairs_device": pairs_dev,
        "sketch_cmd_s": sketch_cmd_s,
        "sketch_bytes": sum(os.path.getsize(p) for p in sk_paths),
        # the triangle's own sketch stage: sketching the FASTA files, or
        # reading the .sketch files
        "sketch_s": {"fasta": _FASTA_SKETCH_S.get("default"),
                     "sketch_files": st.get("sketch_s", 0.0)},
        "device_wall_s": wall, "launches": launches}


def _search(argv, **kw):
    """engine.search on the parsed `search` arguments, as cli.main runs it,
    with `kw` as its keyword arguments (the CLI passes none); returns
    (wall seconds, stats deltas, CommandParams)."""
    from skani_tpu_torch import cli, engine, stats
    ns = cli.build_parser().parse_args(argv)
    _sp, cp = cli.parse_args_to_params(ns)
    cp.threads = max(int(ns.threads), 1)
    before = stats.snapshot()
    t0 = time.perf_counter()
    engine.search(cp, **kw)
    wall = time.perf_counter() - t0
    after = stats.snapshot()
    return wall, {k: after.get(k, 0.0) - before.get(k, 0.0)
                  for k in set(after) | set(before)}, cp


def _read_fasta(path):
    from skani_tpu_torch import fastx
    return [s for _name, s in fastx.iter_fastx(path)]


def _sketch_cmd(paths, out, *flags, timeout=600):
    """`python -m skani_tpu_torch sketch` in a child process; seconds."""
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "skani_tpu_torch", "sketch",
                        *flags, *paths, "-o", out, "-t", str(os.cpu_count())],
                       capture_output=True, text=True, env=env,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"sketch {' '.join(flags)} failed\n"
                           f"{r.stderr[-2000:]}")
    return time.perf_counter() - t0


def _page_batch(eng, page_refs, queries, screened, q_slots):
    """The first device batch of a resident page engine on the first chunk
    of queries that hit its page, loaded into its reserved rows as the
    search loads a chunk: (engine, group, phase_a arguments, (2, R) rows,
    None)."""
    local = {j: s for s, j in enumerate(page_refs)}
    chunk = [(q, [local[j] for j in js if j in local])
             for q, js in zip(queries, screened)]
    chunk = [c for c in chunk if c[1]][:q_slots]
    slots = [eng.reserved_base + k for k in range(len(chunk))]
    if not eng.load_slots(slots, [q for q, _r in chunk]):
        raise RuntimeError("search: the page refused its query chunk")
    pairs = [(r, s) for (_q, rs), s in zip(chunk, slots) for r in rs]
    _out, meta, _m = eng.plan(pairs)
    group = next(eng.groups(meta))
    return (eng, group, eng.batch_args(group, group[0][4]),
            eng.batch_index(group), None)


# the search runs: the database each reads, engine.search's keyword
# arguments (the paged run's page size and budget are set from the
# database) and the kernels each must launch.  The consolidated database's
# one page at the default budget holds the draft assemblies, so it takes
# the `sorted` generator; the paged run's pages of few-contig genomes take
# `sorted_packed` with the merge join, as every database with reserved
# rows does.  A separate-sketch database takes the windowed path: one
# engine over each window's screened references and queries
_SEARCH_MUST = {
    "search": ("row_gather", "genome_map_gather", "row_scatter",
               "dp_chain_compact_wide"),
    "search_paged": ("row_gather", "genome_map_gather", "row_scatter_multi",
                     "dp_chain_compact", "row_scatter",
                     "dp_chain_compact_wide"),
    "search_windowed": ("row_gather", "genome_map_gather", "row_scatter",
                        "dp_chain_compact_wide"),
}


@phase("search")
def search(tmp, sets, seed, length):
    """`search` of 8 queries against 64 references from three bases (the
    base set's 32 genomes, the contigs set's 16 drafts and 16 genomes of a
    third base), through the CLI's parser and engine.search: on the
    consolidated database resident at the defaults and resident in at
    least 4 pages under an LRU of 2 with 2 reserved query rows and one
    query a window; on the separate-sketch database windowed.  Each TSV
    byte-identical to the native executor's on the same database.  Returns
    the launch counts by run and, for the kernel table, the first batch of
    the default run's page and of a `sorted_packed` page of the paged
    run."""
    from skani_tpu_torch import db, engine, synth
    from skani_tpu_torch.kernels.device_db import _pack_rows
    third = synth.genome_set(seed + 2, 16, length, copies=_COPIES,
                             rates=(0.003, 0.03), n_split=4, contigs=(2, 8))
    # the third base's genomes, the queries and the databases stay in
    # `sets` for the seeding and fleet phases
    sets["third"] = synth.write_genome_set(tmp, third, prefix="t")
    refs = sets["base"] + sets["third"] + sets["contigs"]
    rng = np.random.default_rng(seed + 3)
    sources = [_read_fasta(sets["base"][31]), _read_fasta(sets["contigs"][15]),
               third[15], _read_fasta(sets["base"][20]),
               _read_fasta(sets["contigs"][10]), third[10]]
    qdir = os.path.join(tmp, "queries")
    os.makedirs(qdir)
    queries = [synth.write_fasta(os.path.join(qdir, f"q{i}.fa"), f"q{i}",
                                 [synth.mutate(rng, np.concatenate(src),
                                               0.01)])
               for i, src in enumerate(sources)]
    for i in range(2):
        queries.append(synth.write_fasta(
            os.path.join(qdir, f"u{i}.fa"), f"u{i}",
            [synth.base_genome(np.random.default_rng(seed + 4 + i),
                               length, copies=_COPIES)]))
    dbs = {"db": os.path.join(tmp, "search_db"),
           "sep": os.path.join(tmp, "search_sep")}
    sets["queries"], sets["search_dbs"] = queries, dbs
    sketch_cmd_s = {"db": _sketch_cmd(refs, dbs["db"]),
                    "sep": _sketch_cmd(refs, dbs["sep"],
                                       "--separate-sketches")}
    ests = [2 * n for _off, n in db.SketchDbReader(dbs["db"]).index]
    page_kb = -(-sum(ests) // (9 * 1024 // 2))       # about 4.5 pages
    runs = {"search": ("db", {}),
            "search_paged": ("db", {"q_slots": 2, "batch": 1,
                                    "page_kb": page_kb,
                                    "hbm_mb": 2.5 * page_kb / 1024}),
            "search_windowed": ("sep", {})}

    def argv(dbk, name):
        return ["search", "-d", dbs[dbk], *queries, "-o",
                os.path.join(tmp, f"{name}.tsv"), "-t", str(os.cpu_count())]

    want, info = {}, {"references": len(refs), "queries": len(queries),
                      "sketch_cmd_s": sketch_cmd_s}
    os.environ["SKANI_TPU_EXECUTOR"] = "native"
    try:
        for dbk in dbs:
            nat_wall, nat_st, _cp = _search(argv(dbk, f"native_{dbk}"))
            with open(os.path.join(tmp, f"native_{dbk}.tsv"), "rb") as f:
                want[dbk] = f.read()
            info[f"native_{dbk}"] = {
                "wall_s": nat_wall,
                "split_s": {k: nat_st.get(k + "_s", 0.0)
                            for k in _SPLIT + ("load",)}}
    finally:
        device_route()
    n_rows = len(want["db"].splitlines()) - 1
    if n_rows < 6 * 16:
        raise RuntimeError(f"search: only {n_rows} native hits")
    info["tsv_rows"] = n_rows
    info["native_layouts_identical"] = want["db"] == want["sep"]
    # the queries as the search sketches them, and each one's screened
    # references, for the kernel table's batches
    sp, ref_markers = db.read_markers_bin(os.path.join(dbs["db"],
                                                       "markers.bin"))
    by_run, kept = {}, {}
    for name, (dbk, kw) in runs.items():
        engine._resident_engines.clear()
        torch.cuda.empty_cache()
        reset_launches()
        wall, st, cp = _search(argv(dbk, name), **kw)
        launches = read_launches()
        with open(os.path.join(tmp, f"{name}.tsv"), "rb") as f:
            if f.read() != want[dbk]:
                raise RuntimeError(f"{name}: device and native search TSVs "
                                   f"differ")
        pairs_dev = int(st.get("pairs_device", 0))
        overflow = int(st.get("pairs_overflow", 0))
        if pairs_dev <= overflow:
            raise RuntimeError(f"{name}: no pair was finished by the "
                               f"device engine")
        missing = [k for k in _SEARCH_MUST[name] if launches[k] <= 0]
        if missing:
            raise RuntimeError(f"{name}: kernels of the path never "
                               f"launched: {missing} ({launches})")
        pages = int(st.get("search_pages", 0))
        uploads = int(st.get("page_uploads", 0))
        if (pages > 0) != (dbk == "db"):
            raise RuntimeError(f"{name}: {pages} resident pages")
        if name == "search_paged" and not (pages >= 4 and uploads > pages):
            raise RuntimeError(f"search_paged: {uploads} uploads of "
                               f"{pages} pages (needs >= 4 pages and "
                               f"re-uploads)")
        if dbk == "db":
            # the page engines this run left resident: (its references,
            # engine, q_slots)
            kept[name] = [(k[3], e, kw.get("q_slots", 64))
                          for k, e in engine._resident_engines.items()]
        by_run[name] = launches
        info[name] = {
            "database": dbk, "kw": kw, "tsv_identical": True,
            "pages": pages, "page_uploads": uploads,
            "pairs_screened": int(st.get("pairs_screened", 0)),
            "pairs_device": pairs_dev, "pairs_overflow": overflow,
            "pairs_slots_refused": int(st.get("pairs_slots_refused", 0)),
            "device_batches": int(st.get("device_batches", 0)),
            "device_wall_s": wall,
            "split_s": {k: st.get(k + "_s", 0.0)
                        for k in _SPLIT + ("load",)},
            "launches": launches}
    engine._resident_engines.clear()
    qsks = list(engine._iter_query_sketches(cp, sp))
    index = engine._make_marker_index(ref_markers) if cp.screen else None
    sv = engine._resolve_screen_val(cp, sp)
    screened = [engine._screen_query(q, ref_markers, index, sv, sp)
                for q in qsks]
    # the default run's one page, and a `sorted_packed` page that the
    # paged run left resident
    (page_refs, eng, q_slots), = kept["search"]
    packed = [k for k in kept["search_paged"]
              if k[1].gen_mode == "sorted_packed"]
    if not packed:
        raise RuntimeError("search_paged: no sorted_packed page is "
                           "resident after the run")
    batches = {"search": _page_batch(eng, page_refs, qsks, screened,
                                     q_slots),
               "search_paged": _page_batch(packed[0][1], packed[0][0], qsks,
                                           screened, packed[0][2])}
    for key, b in batches.items():
        info[f"{key}_batch"] = {
            "gen_mode": b[0].gen_mode, "join_mode": b[2]["join_mode"],
            "G": b[0].db.G, "K": b[0].db.K, "P": b[0].db.P,
            "reserved_base": b[0].reserved_base, "R": int(b[3].shape[1]),
            "pairs": len(b[1]), "A": b[2]["A"]}
    # one update_rows chunk at the default q_slots: the queries that hit
    # the default run's page, into its reserved rows
    chunk = [q for q, js in zip(qsks, screened) if js][:q_slots]
    slots = [eng.reserved_base + k for k in range(len(chunk))]
    info["update_rows"] = {
        "rows": len(slots), "gen_mode": eng.gen_mode, "K": eng.db.K,
        "P": eng.db.P, "tables": sorted(eng.db.arrays),
        "bytes": sum(v[0].numel() * v.element_size() * len(slots)
                     for v in eng.db.arrays.values()),
        "ms": cuda_ms(lambda: eng.db.update_rows(slots, chunk), 5),
        # the host's share: packing the rows at the database's (K, P)
        "host_pack_ms": host_ms(lambda: _pack_rows(
            chunk, eng.db.K, eng.db.P, eng.db.mode != "legacy",
            eng.db.threads), 5)}
    # the update_rows timing rewrote the chunk's rows with the same
    # queries: the default batch reads them as it was built
    return (by_run, batches), info


@phase("triangle_aai")
def triangle_aai(tmp, seed):
    """`sketch -a --separate-sketches` of 8 genomes of 1 Mbp mutated 1-15 %
    from a base of their own, then `triangle -a --sparse --detailed` on
    the `.sketch` files on the device and on the native executor: the
    TSVs must be byte-identical, with at least one pair finished on the
    device (the legacy generator, per-chunk cap 768, the padded DP at band
    500 // 15)."""
    from skani_tpu_torch import CommandParams, db, synth
    from skani_tpu_torch.kernels.device_pipeline import DevicePairEngine
    gs = synth.genome_set(seed + 6, 8, 1_000_000, rates=(0.01, 0.15),
                          n_split=2, contigs=(2, 4))
    paths = synth.write_genome_set(os.path.join(tmp, "aai"), gs, "aa")
    out = os.path.join(tmp, "aai_sketches")
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "skani_tpu_torch", "sketch",
                        "-a", "--separate-sketches", *paths, "-o", out, "-t",
                        str(os.cpu_count())], capture_output=True, text=True,
                       env=env, timeout=900)
    seeding_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"triangle_aai: sketch -a failed\n"
                           f"{r.stderr[-2000:]}")
    sk_paths = [os.path.join(out, os.path.basename(p) + ".sketch")
                for p in paths]
    base = ["triangle", "-a", *sk_paths, "--sparse", "--detailed", "-t",
            str(os.cpu_count())]
    dev_tsv = os.path.join(tmp, "aai_device.tsv")
    nat_tsv = os.path.join(tmp, "aai_native.tsv")
    reset_launches()
    dev_wall, st = _triangle(base + ["-o", dev_tsv])
    launches = read_launches()
    os.environ["SKANI_TPU_EXECUTOR"] = "native"
    try:
        nat_wall, _nst = _triangle(base + ["-o", nat_tsv])
    finally:
        device_route()
    with open(dev_tsv, "rb") as f:
        got = f.read()
    with open(nat_tsv, "rb") as f:
        if f.read() != got:
            raise RuntimeError("triangle_aai: device and native TSVs "
                               "differ")
    pairs_dev = int(st.get("pairs_device", 0))
    overflow = int(st.get("pairs_overflow", 0))
    if pairs_dev <= overflow:
        raise RuntimeError(f"triangle_aai: no pair was finished by the "
                           f"device engine ({overflow} of {pairs_dev} "
                           f"overflowed)")
    missing = [k for k in ("row_gather", "dp_chain") if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"triangle_aai: kernels of the path never "
                           f"launched: {missing} ({launches})")
    # the first batch of an engine over the sketches, for the kernel table's
    # K10 row on the batch's own call
    sp, sks = db.sketches_from_sketch(sk_paths)
    eng = DevicePairEngine(sks, sp, CommandParams(), device="cuda")
    _out, meta, _m = eng.plan([(i, j) for i in range(len(sks))
                               for j in range(i + 1, len(sks))])
    group = next(eng.groups(meta))
    batch = (eng, group, eng.batch_args(group, group[0][4]),
             eng.batch_index(group), None)
    return (launches, batch), {
        "genomes": len(paths), "tsv_identical": True,
        "tsv_rows": len(got.splitlines()) - 1, "gen_mode": eng.gen_mode,
        "L_CAP": eng.L_CAP, "A": eng.A, "c": sp.c, "k": sp.k,
        "width_bp": 1_000_000, "overflow_causes": _overflow_causes(batch),
        "seeds": [len(s.seed_pos) for s in sks], "aai_seeding_s": seeding_s,
        "pairs_device": pairs_dev, "pairs_overflow": overflow,
        "device_batches": int(st.get("device_batches", 0)),
        "device_wall_s": dev_wall, "native_wall_s": nat_wall,
        "device_split_s": {k: st.get(k + "_s", 0.0) for k in _SPLIT},
        "launches": launches}


@phase("search_aai")
def search_aai(tmp):
    """`search` on AAI databases of the triangle_aai phase's sketches (no
    AA seeding again): the separate-sketch database that phase's `sketch
    -a --separate-sketches` wrote, windowed, and a consolidated database
    of the same sketches written by the `sketch` subcommand's writer,
    resident (`legacy` pages with reserved query rows); three of the
    `.sketch` files as queries.  Each TSV byte-identical to the native
    executor's on the same database; launch counts under `search_aai` and
    `search_aai_windowed`."""
    from skani_tpu_torch import db, engine
    sep = os.path.join(tmp, "aai_sketches")
    sk_paths = sorted(os.path.join(sep, f) for f in os.listdir(sep)
                      if f.endswith(".sketch"))
    params, sks = db.sketches_from_sketch(sk_paths)
    cdb = os.path.join(tmp, "aai_db")
    os.makedirs(cdb)
    writer = db.SketchDbWriter(cdb)
    for sk in sks:
        writer.add_sketch(params, sk)
    writer.finalize()
    db.write_markers_bin(os.path.join(cdb, "markers.bin"), params,
                         [sk.get_markers_only() for sk in sks])
    queries = sk_paths[:3]
    runs = {"search_aai": cdb, "search_aai_windowed": sep}
    by_run, info = {}, {"references": len(sks), "queries": len(queries)}
    for key, folder in runs.items():
        def argv(who):
            return ["search", "-d", folder, *queries, "--detailed", "-o",
                    os.path.join(tmp, f"{key}_{who}.tsv"), "-t",
                    str(os.cpu_count())]
        os.environ["SKANI_TPU_EXECUTOR"] = "native"
        try:
            nat_wall, _nst, _cp = _search(argv("native"))
        finally:
            device_route()
        engine._resident_engines.clear()
        reset_launches()
        wall, st, _cp = _search(argv("device"))
        launches = read_launches()
        engine._resident_engines.clear()
        with open(os.path.join(tmp, f"{key}_native.tsv"), "rb") as f:
            want = f.read()
        with open(os.path.join(tmp, f"{key}_device.tsv"), "rb") as f:
            if f.read() != want:
                raise RuntimeError(f"{key}: device and native search TSVs "
                                   f"differ")
        pairs_dev = int(st.get("pairs_device", 0))
        overflow = int(st.get("pairs_overflow", 0))
        if pairs_dev <= overflow:
            raise RuntimeError(f"{key}: no pair was finished by the device "
                               f"engine ({overflow} of {pairs_dev})")
        missing = [k for k in ("row_gather", "dp_chain") if launches[k] <= 0]
        if missing:
            raise RuntimeError(f"{key}: kernels of the path never "
                               f"launched: {missing} ({launches})")
        pages = int(st.get("search_pages", 0))
        if (pages > 0) != (key == "search_aai"):
            raise RuntimeError(f"{key}: {pages} resident pages")
        by_run[key] = launches
        info[key] = {"tsv_identical": True,
                     "tsv_rows": len(want.splitlines()) - 1,
                     "pages": pages, "pairs_device": pairs_dev,
                     "pairs_overflow": overflow, "device_wall_s": wall,
                     "native_wall_s": nat_wall,
                     "split_s": {k: st.get(k + "_s", 0.0)
                                 for k in _SPLIT + ("load",)},
                     "launches": launches}
    return by_run, info


# genome counts of the seeding sweep: the search phase's 64 references
# (the base set's 32, the third base's 16, the 16 drafts), then 64 of a
# fourth base
_SEED_SWEEP = (8, 16, 32, 48, 64, 96, 128)

# int32-equivalent operations that FracMinHash seeding needs a window, the
# bound's operations term (counted as the DP rows count theirs: what the
# function needs, not what a kernel spends).  A rolling 21-mer: one new
# base a window.  A 64-bit shift, add, xor, not or compare counts 2, an
# operation on one 32-bit half 1, a multiply by a 32-bit constant
# (IMAD.WIDE.U32 and IMAD) 2.
_SEED_OPS_A_WINDOW = {
    "encode": 1,            # byte -> 2-bit code and N flag (table)
    "forward_21mer": 4,     # F = (F << 2 | code) & (2^42 - 1): shl 2, or, and
    "reverse_21mer": 5,     # R = R >> 2 | (3 - code) << 40: shr 2, sub, shl, or
    "n_resume": 3,          # last N position: select; max(20, i - k + 1); compare
    "seed_kmers": 2,        # fs, rs: the low 2k <= 32 bits of F and R
    "canonical_min": 2,     # fs < rs, min
    "mm_hash64": 24,        # of a 32-bit key: ~(key + key << 21) 6, three
                            # xor-shifts 4 each, three constant multiplies 2 each
    "keep_test": 3,         # h < thr (64-bit) and the N test
    "mark_test": 3,         # h < thr_m (64-bit) and keep
    "compaction": 4,        # ballot and popc of keep and of mark
}
_SEED_OPS_A_SEED = 3        # position w + 20, two store addresses
_SEED_OPS_A_MARKER = 4      # min(F, R): 64-bit compare and select
_SKETCH_ARRAYS = ("contig_lengths", "seed_kmers", "seed_starts", "seed_pos",
                  "seed_contig", "seed_canon", "marker_seeds")


def _same_sketches(got, want, what):
    """Every sketch of `got` equal to `want`'s, array for array."""
    if [s.file_name for s in got] != [s.file_name for s in want]:
        raise RuntimeError(f"{what}: the sketches' files differ")
    for g, w in zip(got, want):
        if g.contigs != w.contigs \
                or g.total_sequence_length != w.total_sequence_length:
            raise RuntimeError(f"{what}: {g.file_name}'s contigs differ")
        for f in _SKETCH_ARRAYS:
            a, b = getattr(g, f), getattr(w, f)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise RuntimeError(f"{what}: {g.file_name}'s {f} differs")


def _edge_contigs(rng):
    """The seeding tests' edge cases: lengths about 42, lowercase, runs of
    N (one below base 20, one inside the last 16 bases), other IUPAC
    bytes and U, and a tandem repeat."""
    def acgt(n):
        return np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, size=n)].copy()
    out = [acgt(n) for n in (0, 41, 42, 43, 500, 4097)]
    s = acgt(30000)
    s[::3] += 32
    out.append(s)
    s = acgt(30000)
    s[19], s[20], s[-15], s[-1] = ord("N"), ord("n"), ord("n"), ord("N")
    for a in rng.integers(25, 29000, size=15):
        s[a:a + int(rng.integers(1, 40))] = ord("N")
    out.append(s)
    s = acgt(30000)
    iu = np.frombuffer(b"RYKMSWBDHVrykmswbdhv-.*Xx", np.uint8)
    pos = rng.integers(0, len(s), size=600)
    s[pos] = iu[rng.integers(0, len(iu), size=len(pos))]
    s[1000:1100] = ord("U")
    out.append(s)
    out.append(np.frombuffer(b"ACGTTG" * 6000, np.uint8).copy())
    return out


def _context_s():
    """Seconds a fresh process takes to start CUDA and load the (built)
    kernel library: what the `sketch` subcommand, which starts no engine,
    pays before its first seeding launch; and its `import torch`, which
    both routes pay."""
    code = ("import sys, time\n"
            "t0 = time.perf_counter()\n"
            "import torch\n"
            "t1 = time.perf_counter()\n"
            "torch.zeros(1, device='cuda')\n"
            "torch.cuda.synchronize()\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "from skani_tpu_torch.kernels import _build\n"
            "_build.lib()\n"
            "print(t1 - t0, time.perf_counter() - t1)\n")
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.dirname(os.path.abspath(__file__))],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError("context start-up probe failed\n" + r.stderr)
    imp, ctx = (float(x) for x in r.stdout.split())
    return {"import_torch_s": imp, "context_and_library_s": ctx}


def _rule_from(sweep, key):
    """The bases hint of the smallest sweep point from which the device
    route (its time under `key`) beat native at that point and every
    larger one, or None."""
    win = None
    for p in reversed(sweep):
        if p[key] >= min(p["native_s"]):
            break
        win = p["bases_hint"]
    return win


def _cold_extrapolation(sweep, startup_s):
    """Where the cold device route would meet native, on the line through
    the two largest sweep points (None when native grows no faster)."""
    a, b = sweep[-2], sweep[-1]
    db_ = b["bases_hint"] - a["bases_hint"]
    s_nat = (min(b["native_s"]) - min(a["native_s"])) / db_
    s_dev = (min(b["device_s"]) - min(a["device_s"])) / db_
    gap = min(b["device_s"]) + startup_s - min(b["native_s"])
    if s_nat <= s_dev:
        return None
    return int(b["bases_hint"] + max(gap, 0.0) / (s_nat - s_dev))


def seed_sass_per_window(sass, windows, seeds):
    """SASS a window of each seeding launch, of the integer pipe and in
    all (seed_sass): the count launch's code outside loops over the 32
    windows of its thread, plus its staging loop at its trips a thread
    (the tile's words over the threads); the write launch's code outside
    loops over 32 windows, plus its survivor loop once a survivor (lanes
    that a divergent warp leaves idle not counted).  Thread 0's contig
    search and the warp-offset loop are left out (a few iterations a
    block of 8192 windows)."""
    from skani_tpu_torch.kernels import seeding
    cnt, wrt = sass.get("seed_count_kernel"), sass.get("seed_write_kernel")
    if not cnt or not wrt:
        return None
    words = (seeding.BLOCK_WINDOWS + 20 + 3) // 4 + 1   # kTileWords
    trips = words / seeding.THREADS
    out = {}
    for key in ("int_alu", "instructions"):
        stage = cnt["loops"].get("stage", {}).get(key, 0)
        surv = wrt["loops"].get("survivor", {}).get(key, 0)
        out[key] = {"count": (cnt[key] + stage * trips) / seeding.RUN,
                    "write": wrt[key] / seeding.RUN + surv * seeds / windows,
                    "write_per_survivor": surv}
    return out


@phase("seeding")
def seeding_phase(tmp, sets, seed, length, bw, rate, sass, name):
    """Device seeding: the kernels against the plain version on the edge
    contigs (four (k, c)); the sketch stage over the first 8 to 128 of the
    search phase's references and 64 genomes of a fourth base, the device
    route against the native one at `-t` = cores in turns (native, device,
    device, native), every sketch equal array for array; a fresh process's
    `import torch` and CUDA start-up, which the `sketch` subcommand's
    device route pays on top (cold); where each rule's constant sits
    against the sweep; a CLI `triangle` of the fewest sweep genomes whose
    bases reach DEVICE_SEED_MIN_BASES, so that its sketch stage takes the
    card by the rule (counters under `seeding`), byte-identical to native;
    then the kernel row on that triangle's first window of contigs."""
    from skani_tpu_torch import SketchParams, native, sketch, stats, synth
    from skani_tpu_torch.kernels import seeding
    dev = torch.device("cuda")
    cores = os.cpu_count()
    sp = SketchParams()
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def check(b, o, k, c, m, what):
        got = seeding.seed_batch(b, o, k, c, m)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        want = seeding.seed_batch_plain(b, o, k, c, m)
        e1.record()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise RuntimeError(f"fmh_seeds: kernel differs from its "
                                   f"plain version ({what})")
        return got, e0.elapsed_time(e1)

    edge = [t(x) for x in seeding._flat(_edge_contigs(
        np.random.default_rng(77)))]
    edge_seeds = {}
    for k, c in ((15, 125), (16, 30), (15, 200), (15, 30)):
        got, _ms = check(*edge, k, c, SketchParams(c=c, k=k).marker_c,
                         f"edge contigs, k {k}, c {c}")
        edge_seeds[f"k{k}_c{c}"] = [len(got[0]), len(got[3])]

    fourth = synth.genome_set(seed + 9, 64, length, copies=_COPIES,
                              rates=(0.003, 0.05), n_split=16,
                              contigs=(2, 8))
    refs = sets["base"] + sets["third"] + sets["contigs"] \
        + synth.write_genome_set(tmp, fourth, prefix="s")
    del fourth
    ctx = _context_s()
    startup_s = ctx["import_torch_s"] + ctx["context_and_library_s"]
    sweep = []
    for n in _SEED_SWEEP:
        paths = refs[:n]
        times = {"native": [], "device": []}
        first = {}
        split = {}
        for who in ("native", "device", "device", "native"):
            seeder = native.fmh_seeds_native if who == "native" \
                else seeding.DeviceSeeder(dev)
            torch.cuda.synchronize()
            before = stats.snapshot()
            t0 = time.perf_counter()
            sks = sketch.fastx_to_sketches(paths, sp, threads=cores,
                                           seeder=seeder)
            times[who].append(time.perf_counter() - t0)
            after = stats.snapshot()
            first.setdefault(who, sks)
            if who == "device":
                # the route's main thread: waiting for reads, the batch
                # (flatten, upload, kernels, download), the finalize
                split = {k: after.get(k, 0.0) - before.get(k, 0.0)
                         for k in ("seed_read_wait_s", "seed_batch_s",
                                   "seed_finalize_s")}
        _same_sketches(first["device"], first["native"],
                       f"seeding sweep, {n} genomes")
        sweep.append({
            "genomes": n, "bases_hint": sketch._total_bases_hint(paths),
            "bases": sum(s.total_sequence_length for s in first["native"]),
            "native_s": times["native"], "device_s": times["device"],
            "device_split_s": split,
            "device_warm_s": min(times["device"]),
            "device_cold_s": min(times["device"]) + startup_s})
    # where each route wins from on: warm for dist / triangle / search,
    # whose run imports torch and starts CUDA anyway; cold for the
    # `sketch` subcommand, whose native route imports no torch; and
    # whether a point that a rule sends to the card lost there
    rules = {}
    for key, const in (("warm", sketch.DEVICE_SEED_MIN_BASES),
                       ("cold", sketch.DEVICE_SEED_MIN_BASES_COLD)):
        rules[key] = {
            "constant": const,
            "device_wins_from_bases": _rule_from(sweep, f"device_{key}_s"),
            "carded_points_lost": [
                p["genomes"] for p in sweep if p["bases_hint"] >= const
                and p[f"device_{key}_s"] >= min(p["native_s"])],
            "losing_points": [p["genomes"] for p in sweep
                              if p[f"device_{key}_s"] >= min(p["native_s"])]}
    rules["cold"]["extrapolated_crossover_bases"] = _cold_extrapolation(
        sweep, startup_s)
    n_cli = next((p["genomes"] for p in sweep
                  if p["bases_hint"] >= sketch.DEVICE_SEED_MIN_BASES), None)
    if n_cli is None:
        raise RuntimeError(f"seeding: no sweep point reaches "
                           f"DEVICE_SEED_MIN_BASES "
                           f"{sketch.DEVICE_SEED_MIN_BASES}")

    paths = refs[:n_cli]
    argv = ["triangle", *paths, "--sparse", "--detailed", "-t", str(cores)]
    dev_tsv = os.path.join(tmp, "seeding_device.tsv")
    nat_tsv = os.path.join(tmp, "seeding_native.tsv")
    reset_launches()
    dev_wall, dev_st = _triangle(argv + ["-o", dev_tsv])
    launches = read_launches()
    if launches["fmh_seeds"] <= 0:
        raise RuntimeError("seeding: the triangle's sketch stage did not "
                           "take the device route")
    reset_launches()
    os.environ["SKANI_TPU_EXECUTOR"] = "native"
    try:
        nat_wall, nat_st = _triangle(argv + ["-o", nat_tsv])
    finally:
        device_route()
    if read_launches()["fmh_seeds"] != 0:
        raise RuntimeError("seeding: the native executor seeded on the card")
    with open(dev_tsv, "rb") as f:
        got = f.read()
    with open(nat_tsv, "rb") as f:
        if f.read() != got:
            raise RuntimeError("seeding: device and native triangle TSVs "
                               "differ")
    if int(dev_st.get("pairs_device", 0)) <= int(
            dev_st.get("pairs_overflow", 0)):
        raise RuntimeError("seeding: no pair was finished on the card")
    if launches["row_gather"] <= 0:
        raise RuntimeError(f"seeding: the engine never launched ({launches})")

    # the kernel row: the triangle's first window of contigs (the route
    # seeds the contigs of its files in one batch until they pass
    # DEVICE_SEED_WINDOW_BASES)
    contigs = []
    for p in paths:
        contigs += [c for c in _read_fasta(p) if len(c) >= 500]
        if sum(len(c) for c in contigs) >= sketch.DEVICE_SEED_WINDOW_BASES:
            break
    b, o = (t(x) for x in seeding._flat(contigs))
    k, c, m = sp.k, sp.c, sp.marker_c
    out, pms = check(b, o, k, c, m, f"the {n_cli}-genome batch")
    fn = lambda: seeding.seed_batch(b, o, k, c, m)
    ms = cuda_ms(fn, 10)
    dms = device_ms(fn)
    src = "profiler"
    if dms is None:
        src, dms = "events", back_to_back_ms(fn)
    _span, ev = _device_events(fn, 5)
    own = {k_: t_ / n_ / 1e3 for k_, t_, n_ in ev
           if n_ and "seed_" in k_}
    windows = sum(len(x) - 20 for x in contigs if len(x) >= 42)
    n_keep, n_mark = len(out[0]), len(out[3])
    # bytes: each base read once, the offsets, 9 bytes a seed (kmer,
    # position, flag) and 8 a marker written once; operations: what the
    # function needs a window, a seed and a marker (_SEED_OPS_A_WINDOW)
    # over the int32 lane rate.  Each launch's SASS a window is kept beside
    # it (seed_sass_per_window)
    nbytes = b.numel() + 8 * o.numel() + 9 * n_keep + 8 * n_mark
    per_window = seed_sass_per_window(sass, windows, n_keep)
    ops_window = sum(_SEED_OPS_A_WINDOW.values())
    ops = windows * ops_window + n_keep * _SEED_OPS_A_SEED \
        + n_mark * _SEED_OPS_A_MARKER
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / rate["ops_per_s"] * 1e3
    row = {"name": "fmh_seeds", "counter": "fmh_seeds",
           "shape": [[int(b.numel())], [int(o.numel())]],
           "source": "skani_tpu_torch/csrc/seeding.cu",
           "replaces": "skani_tpu/kernels/seeding_tpu.py:91",
           "err": 0, "ms": ms, "plain_ms": pms, "library_ms": None,
           "library_device_ms": None, "library_device_ms_source": None,
           "device_ms": dms, "device_ms_source": src,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops, "bytes_bound_ms": t_bytes,
           "ops_bound_ms": t_ops, "ops_per_window": ops_window,
           "ops_per_window_terms": _SEED_OPS_A_WINDOW,
           "sass_per_window": per_window and per_window["int_alu"],
           "sass_per_window_all": per_window and per_window["instructions"],
           "sass_count_kernel": sass.get("seed_count_kernel"),
           "sass_write_kernel": sass.get("seed_write_kernel"),
           "kernels_device_ms": own, "windows": windows, "seeds": n_keep,
           "markers": n_mark, "contigs": len(contigs), "card": name}
    emit({"kernel": "fmh_seeds", **{k_: v for k_, v in row.items()
                                     if k_ not in ("name", "err")}})
    return (launches, row), {
        "edge_seeds": edge_seeds, "context": ctx, "sweep": sweep,
        "threads": cores, "rules": rules,
        "triangle": {"genomes": n_cli, "tsv_identical": True,
                     "tsv_rows": len(got.splitlines()) - 1,
                     "device_wall_s": dev_wall, "native_wall_s": nat_wall,
                     "device_sketch_s": dev_st.get("sketch_s", 0.0),
                     "native_sketch_s": nat_st.get("sketch_s", 0.0),
                     "pairs_device": int(dev_st.get("pairs_device", 0)),
                     "launches": launches}}


def _engine_cmd(argv, **kw):
    """engine.dist / engine.triangle on the parsed CLI arguments, as
    cli.main runs them, with `kw` as their keyword arguments (the CLI
    passes none); returns (wall seconds, stats deltas)."""
    from skani_tpu_torch import cli, engine, stats
    ns = cli.build_parser().parse_args(argv)
    sp, cp = cli.parse_args_to_params(ns)
    cp.threads = max(int(ns.threads), 1)
    before = stats.snapshot()
    t0 = time.perf_counter()
    getattr(engine, argv[0])(cp, sp, **kw)
    wall = time.perf_counter() - t0
    after = stats.snapshot()
    return wall, {k: after.get(k, 0.0) - before.get(k, 0.0)
                  for k in set(after) | set(before)}


# the fleet of the one card: two engines on it
_FLEET = ["cuda:0", "cuda:0"]


@phase("fleet")
def fleet(tmp, sets):
    """The one-host multi-GPU path on ["cuda:0", "cuda:0"] (two engines
    share the card): the default run's triangle through ShardedPairFleet
    with its marker index a ShardedMarkerScreen (counters under
    `fleet_triangle`), and the windowed `search` on the separate-sketch
    database through the fleet (`fleet_search`); each TSV byte-identical
    to the native one of the same run."""
    tri_tsv = os.path.join(tmp, "fleet_triangle.tsv")
    reset_launches()
    tri_wall, tri_st = _engine_cmd(_argv(sets, "default") + ["-o", tri_tsv],
                                   devices=_FLEET, sharded_screen=True)
    tri = read_launches()
    srch_tsv = os.path.join(tmp, "fleet_search.tsv")
    reset_launches()
    srch_wall, srch_st, _cp = _search(
        ["search", "-d", sets["search_dbs"]["sep"], *sets["queries"], "-o",
         srch_tsv, "-t", str(os.cpu_count())], devices=_FLEET)
    srch = read_launches()
    info = {"devices": _FLEET}
    for key, tsv, want, st, wall, launches, must in (
            ("fleet_triangle", tri_tsv, "native_default.tsv", tri_st,
             tri_wall, tri, _RUNS["default"]["must"]),
            ("fleet_search", srch_tsv, "native_sep.tsv", srch_st, srch_wall,
             srch, _SEARCH_MUST["search_windowed"])):
        with open(tsv, "rb") as f:
            got = f.read()
        with open(os.path.join(tmp, want), "rb") as f:
            if f.read() != got:
                raise RuntimeError(f"{key}: the fleet's TSV differs from "
                                   f"native")
        pairs_dev = int(st.get("pairs_device", 0))
        if pairs_dev <= int(st.get("pairs_overflow", 0)):
            raise RuntimeError(f"{key}: no pair was finished on the card")
        missing = [k for k in must if launches[k] <= 0]
        if missing:
            raise RuntimeError(f"{key}: kernels of the path never "
                               f"launched: {missing} ({launches})")
        info[key] = {"tsv_identical": True,
                     "tsv_rows": len(got.splitlines()) - 1,
                     "pairs_device": pairs_dev,
                     "pairs_overflow": int(st.get("pairs_overflow", 0)),
                     "device_batches": int(st.get("device_batches", 0)),
                     "wall_s": wall,
                     "split_s": {k: st.get(k + "_s", 0.0)
                                 for k in _SPLIT},
                     "launches": launches}
    return {"fleet_triangle": tri, "fleet_search": srch}, info


# one process of the multi-host runtime: joins the group from the launch
# variables, counts the references it reads with full seeds from the
# database, runs cli.main on its own arguments (argv[2]: a JSON list, one
# a rank) with the launch counters at 0 just before, and prints its
# counters, its references and its wall as one JSON line
_MH_WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import chip_smoke
from skani_tpu_torch import cli, db, multihost
assert multihost.init_from_env()
rank = multihost.rank()
loaded = []
get = db.SketchDbReader.get_sketch
def counted(self, j):
    loaded.append(int(j))
    return get(self, j)
db.SketchDbReader.get_sketch = counted
chip_smoke.reset_launches()
t0 = time.perf_counter()
rc = cli.main(json.loads(sys.argv[2])[rank])
wall = time.perf_counter() - t0
print("MULTIHOST " + json.dumps({
    "rank": rank, "rc": rc, "wall_s": wall,
    "launches": chip_smoke.read_launches(),
    "loaded": sorted(set(loaded))}), flush=True)
"""
_MH_PROCS = 2
_MH_TIMEOUT = 300


def _multihost_run(argvs):
    """cli.main on a runtime of _MH_PROCS processes on this card (gloo on
    127.0.0.1 at a free port), rank r on argvs[r]: (wall seconds, each
    rank's JSON line).  A rank that exits non-zero or runs past the
    timeout fails the phase; every process is stopped before it returns."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.perf_counter()
    try:
        for r in range(_MH_PROCS):
            env = dict(os.environ, PYTHONPATH=repo,
                       SKANI_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       SKANI_TPU_NUM_PROCS=str(_MH_PROCS),
                       SKANI_TPU_PROC_ID=str(r))
            env.pop("SKANI_TPU_EXECUTOR", None)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MH_WORKER, repo, json.dumps(argvs)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env))
        deadline = t0 + _MH_TIMEOUT
        outs = []
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multihost: rank {r} ran past "
                                   f"{_MH_TIMEOUT} s")
            if p.returncode != 0:
                raise RuntimeError(f"multihost: rank {r} exited "
                                   f"{p.returncode}\n{err[-3000:]}")
            line = [x for x in out.splitlines()
                    if x.startswith("MULTIHOST ")]
            if not line:
                raise RuntimeError(f"multihost: rank {r} printed no "
                                   f"result\n{err[-3000:]}")
            outs.append(json.loads(line[-1][len("MULTIHOST "):]))
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if [o["rank"] for o in outs] != list(range(_MH_PROCS)) \
            or any(o["rc"] != 0 for o in outs):
        raise RuntimeError(f"multihost: ranks {outs}")
    return wall, outs


def _summed(outs) -> dict:
    return {k: sum(o["launches"][k] for o in outs)
            for k in outs[0]["launches"]}


@phase("multihost")
def multihost_phase(tmp, sets):
    """The multi-host launch (multihost.py) as two processes on this card:
    (i) the default run's `triangle --sparse --detailed` of the base set's
    16 genomes, rank 0's TSV byte-identical to native_default.tsv, rank 1
    writing none, the ranks' summed launches of K1, K2 and K3 above 0
    (counters under `multihost_triangle`); (ii) `sketch --shards 2` of the
    search phase's 64 references into a consolidated database, then
    `search` of its 8 queries: rank 0's TSV byte-identical to native on
    that database, each rank reading full seeds only for the references it
    owns (global device g % 2: one card a process), the summed launches of
    K1, K5, K6 and K8 above 0 (`multihost_search`).  Each wall beside the
    single-process wall of the same run on the same card (the search's:
    resident, the CLI's default on a consolidated database): two ranks
    share the card, so the walls show the path, not scaling."""
    from skani_tpu_torch import engine
    info = {"processes": _MH_PROCS, "devices": ["cuda:0"] * _MH_PROCS}
    by_path = {}
    # (i) triangle
    outs = [os.path.join(tmp, f"mh_triangle{r}.tsv") for r in range(2)]
    wall, ranks = _multihost_run([_argv(sets, "default") + ["-o", o]
                                  for o in outs])
    with open(outs[0], "rb") as f:
        got = f.read()
    with open(os.path.join(tmp, "native_default.tsv"), "rb") as f:
        if f.read() != got:
            raise RuntimeError("multihost_triangle: rank 0's TSV differs "
                               "from native")
    if os.path.exists(outs[1]):
        raise RuntimeError("multihost_triangle: rank 1 wrote a TSV")
    launches = _summed(ranks)
    missing = [k for k in _RUNS["default"]["must"] if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"multihost_triangle: kernels of the path never "
                           f"launched: {missing} ({launches})")
    by_path["multihost_triangle"] = launches
    info["multihost_triangle"] = {
        "tsv_identical": True, "tsv_rows": len(got.splitlines()) - 1,
        "wall_s": wall, "rank_cli_wall_s": [o["wall_s"] for o in ranks],
        "single_process_wall_s": _DEVICE_WALL_S.get("default"),
        "launches_by_rank": [o["launches"] for o in ranks],
        "launches": launches}
    # (ii) search on a database sharded for two processes
    refs = sets["base"] + sets["third"] + sets["contigs"]
    db_sh = os.path.join(tmp, "search_db_shards")
    sketch_s = _sketch_cmd(refs, db_sh, "--shards", "2")

    def argv(out):
        return ["search", "-d", db_sh, *sets["queries"], "-o", out, "-t",
                str(os.cpu_count())]

    nat_tsv = os.path.join(tmp, "native_shards.tsv")
    os.environ["SKANI_TPU_EXECUTOR"] = "native"
    try:
        nat_wall, _st, _cp = _search(argv(nat_tsv))
    finally:
        device_route()
    with open(nat_tsv, "rb") as f:
        want = f.read()
    engine._resident_engines.clear()
    one_tsv = os.path.join(tmp, "single_shards.tsv")
    one_wall, _st, _cp = _search(argv(one_tsv))
    engine._resident_engines.clear()
    torch.cuda.empty_cache()
    with open(one_tsv, "rb") as f:
        if f.read() != want:
            raise RuntimeError("multihost_search: the single-process device "
                               "search differs from native")
    outs = [os.path.join(tmp, f"mh_search{r}.tsv") for r in range(2)]
    wall, ranks = _multihost_run([argv(o) for o in outs])
    with open(outs[0], "rb") as f:
        if f.read() != want:
            raise RuntimeError("multihost_search: rank 0's TSV differs from "
                               "native on the same database")
    if os.path.exists(outs[1]):
        raise RuntimeError("multihost_search: rank 1 wrote a TSV")
    for o in ranks:
        foreign = [j for j in o["loaded"] if j % _MH_PROCS != o["rank"]]
        if not o["loaded"] or foreign:
            raise RuntimeError(f"multihost_search: rank {o['rank']} read "
                               f"full seeds of {o['loaded']} (not its own: "
                               f"{foreign})")
    launches = _summed(ranks)
    missing = [k for k in _SEARCH_MUST["search_windowed"]
               if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"multihost_search: kernels of the path never "
                           f"launched: {missing} ({launches})")
    by_path["multihost_search"] = launches
    info["multihost_search"] = {
        "tsv_identical": True, "tsv_rows": len(want.splitlines()) - 1,
        "references": len(refs), "sketch_shards_s": sketch_s,
        "wall_s": wall, "rank_cli_wall_s": [o["wall_s"] for o in ranks],
        "single_process_wall_s": one_wall, "native_wall_s": nat_wall,
        "loaded_by_rank": [len(o["loaded"]) for o in ranks],
        "launches_by_rank": [o["launches"] for o in ranks],
        "launches": launches}
    return by_path, info


# the bench phase's depth: bench_torch.py's tiers cut so that the smoke
# keeps inside its limit (its defaults: 32, 24, 512 and 14 genomes)
_BENCH_DEPTH = {"BENCH_GENOMES": "16", "BENCH_DISTANT_GENOMES": "12",
                "BENCH_SEARCH_GENOMES": "128", "BENCH_CLI_GENOMES": "8"}
# the kernels the bench's main tier must launch (the default preset's
# path) and its search tier's (resident pages with reserved rows: the
# merge join)
_BENCH_MUST = _RUNS["default"]["must"] + ("genome_map_gather",)


@phase("bench")
def bench_phase():
    """bench_torch.py's tiers on the card at _BENCH_DEPTH, under the
    defaults (host steal-workers, the small-batch route), as a user runs
    it: the phase line holds its JSON object.  Fails unless mismatches is
    0, device_only is above 0 and every tier ran."""
    import bench_torch
    from skani_tpu_torch.tools.common import environ
    _set_route({})
    try:
        with environ(BENCH_TIERS=None, **_BENCH_DEPTH):
            reset_launches()
            out = bench_torch.run("cuda")
            launches = read_launches()
    finally:
        device_route()
        bench_torch._ENGINE.clear()
        torch.cuda.empty_cache()
    failed = [k for k, v in [("main", out["main"])]
              + list(out["tiers"].items()) if "error" in v]
    missing = [k for k in ("distant_82_95", "search_decoy", "cli_triangle")
               if k not in out["tiers"]]
    if failed or missing or out["mismatches"] != 0 \
            or not out["device_only"] > 0:
        raise RuntimeError(f"bench: mismatches {out['mismatches']}, "
                           f"device_only {out['device_only']}, tiers "
                           f"failed {failed}, missing {missing}")
    never = [k for k in _BENCH_MUST if launches[k] <= 0]
    if never:
        raise RuntimeError(f"bench: kernels of the path never launched: "
                           f"{never} ({launches})")
    return launches, {"depth": _BENCH_DEPTH, "bench": out,
                      "launches": launches}


# the scale phase: the MAG pair at its full width (2 x 65 Mbp, past 2^24
# positions and 2^19 seed rows), a search DB of 256 genomes of 150 kb and
# a streamed triangle of 64 genomes of 40 kb
_SCALE = {"mag_len": 65_000_000, "mag_div": 0.02, "db_genomes": 256,
          "db_genome_len": 150_000, "tri_genomes": 64, "tri_bp": 40_000}


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


@phase("scale")
def scale_phase(tmp):
    """The three scale demos (skani_tpu_torch/tools) on the card at
    _SCALE, on the device-only route: the MAG pair (the unpacked `sorted`
    generator, P >= 2^19: the split gathers; both orientations equal to
    native), search_scale_demo (cold, warm and native rows equal) and
    triangle_scale_demo (TSV byte-identical to native).  Launches of all
    three are the `scale` path's; each demo's line holds its own."""
    from skani_tpu_torch.tools import (mag_scale_demo, search_scale_demo,
                                       triangle_scale_demo)
    runs = {
        "mag": lambda: mag_scale_demo.run(
            _SCALE["mag_len"], _SCALE["mag_div"], "cuda", log=_log),
        "search": lambda: search_scale_demo.run(
            os.path.join(tmp, "scale_search"), _SCALE["db_genomes"],
            _SCALE["db_genome_len"], "cuda", log=_log),
        "triangle": lambda: triangle_scale_demo.run(
            _SCALE["tri_genomes"], _SCALE["tri_bp"], "cuda",
            os.path.join(tmp, "scale_triangle"), log=_log)}
    info, total = {"depth": _SCALE}, {}
    for name, fn in runs.items():
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        launches = read_launches()
        torch.cuda.empty_cache()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if out["mismatches"]:
            raise RuntimeError(f"scale {name}: {out['mismatches']} "
                               f"mismatches")
        info[name] = dict(out, seconds=time.perf_counter() - t0,
                          launches={k: v for k, v in launches.items() if v})
    mag = info["mag"]
    if mag["gen_mode"] != "sorted" or mag["P"] < (1 << 19) \
            or not mag["launches"]:
        raise RuntimeError(f"scale mag: mode {mag['gen_mode']}, P "
                           f"{mag['P']}, launches {mag['launches']}")
    return total, info


# the tools phase: profile_phase_a and profile_host_stage on two first
# batches (the bench default, bench.py's 14 genomes of 5 Mbp; 20 genomes of
# 150 kb, whose first bucket (A 8192) _r_for widens to 192 rows), the soak
# for a minute, the scaling probe at 1, 2 and 4 engines on cuda:0 (10
# genomes of 1 Mbp)
_TOOLS = {"batches": {"bench": (14, 5_000_000), "widened": (20, 150_000)},
          "widened_rows": 192, "stage_reps": 3, "host_reps": 3,
          "soak_minutes": 1.0, "probe_genomes": 10,
          "probe_length": 1_000_000, "probe_engines": (1, 2, 4)}


@phase("tools")
def tools_phase():
    """The four measuring tools of skani_tpu_torch/tools on the card at
    _TOOLS, on the device-only route: each batch's stage prefixes (best
    wall, host enqueue, launches) and host stage (Python and native
    finalize, which must agree), the soak (no mismatching pair), the
    scaling probe (every engine count's results equal to one engine's).
    Launches of all four are the `tools` path's."""
    from skani_tpu_torch.tools import (profile_host_stage, profile_phase_a,
                                       scaling_probe, soak_fuzz)
    from skani_tpu_torch.tools.common import first_batch
    reset_launches()
    info = {"depth": _TOOLS}
    for name, (n, length) in _TOOLS["batches"].items():
        t0 = time.perf_counter()
        eng, group = first_batch(n, length, "cuda")
        stages = profile_phase_a.profile(eng, group,
                                         reps=_TOOLS["stage_reps"])
        host = profile_host_stage.profile(eng, group,
                                          reps=_TOOLS["host_reps"])
        host.pop("packed")
        del eng
        torch.cuda.empty_cache()
        if host["mismatches"]:
            raise RuntimeError(f"tools {name}: the Python and native "
                               f"finalize differ: {host['mismatch_fields']}")
        info[name] = {"genomes": n, "length": length,
                      "seconds": time.perf_counter() - t0,
                      "phase_a": stages, "host_stage": host}
    rows = info["widened"]["phase_a"]["R"]
    if rows != _TOOLS["widened_rows"]:
        raise RuntimeError(f"tools: the widened batch has {rows} rows, not "
                           f"{_TOOLS['widened_rows']}")
    info["soak"] = soak_fuzz.soak(_TOOLS["soak_minutes"], device="cuda",
                                  log=_log)
    if info["soak"]["mismatching_pairs"]:
        raise RuntimeError(f"tools soak: {info['soak']}")
    info["scaling"] = scaling_probe.run(
        _TOOLS["probe_genomes"], _TOOLS["probe_length"],
        _TOOLS["probe_engines"], "cuda", log=_log)
    bad = [r for r in info["scaling"]
           if r["mismatches"] or sum(r["counts"]) != r["pairs"]]
    if bad:
        raise RuntimeError(f"tools scaling probe: {bad}")
    launches = read_launches()
    never = [k for k in _RUNS["default"]["must"] if launches[k] <= 0]
    if never:
        raise RuntimeError(f"tools: kernels of the path never launched: "
                           f"{never} ({launches})")
    info["launches"] = launches
    return launches, info


def _overflow_causes(batch):
    """Which cap the batch's overflowing pairs hit, from its own phase_a
    readback (per row: chunks, anchors, overflow flag): anchors past A and
    chunks past C_CAP directly; a chunk past L_CAP or intervals past I_CAP
    by the rows whose flag clears when phase_a runs again with that cap
    doubled (and with both doubled)."""
    from skani_tpu_torch.kernels.device_pipeline import phase_a
    eng, group, args, ab, _ = batch
    n = len(group)

    def scalars(**over):
        out = phase_a(eng.db.arrays, ab, **dict(args, **over))
        return out[:n, -3:].cpu().numpy()

    sc = scalars()
    flagged = sc[:, 2] != 0
    out = {"pairs": n, "flagged": int(flagged.sum()),
           "A": [args["A"], int((flagged & (sc[:, 1] > args["A"])).sum())],
           "C_CAP": [args["C_CAP"],
                     int((flagged & (sc[:, 0] > args["C_CAP"])).sum())],
           "anchors_max": int(sc[:, 1].max()),
           "chunks_max": int(sc[:, 0].max())}
    both = {}
    for cap in ("L_CAP", "I_CAP"):
        both[cap] = 2 * args[cap]
        cleared = flagged & (scalars(**{cap: both[cap]})[:, 2] == 0)
        out[f"cleared_at_2x_{cap}"] = [both[cap], int(cleared.sum())]
    out["cleared_at_2x_both"] = int(
        (flagged & (scalars(**both)[:, 2] == 0)).sum())
    return out


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
                "dp_chain_packed_kernel", "dp_chain_kernel",
                "expand_cursor_kernel", "expand_kernel",
                "seed_count_kernel", "seed_write_kernel")


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


def expansion_ms(fn, reps: int = 3):
    """Device ms of phase A's slot -> source expansion in one batch: the
    profiler's summed kernel time of the call fn(stage) at stage 35 (the
    expansion's outputs) less that at stage 30 (its inputs); neither stage
    exit launches a kernel of its own."""
    return (profile_phase_a(lambda: fn(35), reps)["kernel_ms"]
            - profile_phase_a(lambda: fn(30), reps)["kernel_ms"])


# the sorted_packed runs whose first batch the expansion kernel takes
_EXPAND_RUNS = ("default", "medium", "slow", "c20")


@phase("padded")
def padded(batches, sets, seed):
    """The default first batch with the compact DP off (dp_chain_packed)
    against the default call; the first batch of every sorted_packed run
    with the expansion kernel (expand_anchors) against the default call,
    then both paths timed in turns; the `sorted` and `legacy` generators
    CUDA against CPU on small batches; the few-contig slow set at per-chunk
    caps 1024 and 2048."""
    from skani_tpu_torch import CommandParams, SketchParams, stats, synth
    from skani_tpu_torch.kernels.device_db import DeviceDb
    from skani_tpu_torch.kernels.device_pipeline import (DevicePairEngine,
                                                         phase_a)
    from skani_tpu_torch.kernels.expand_pallas import expand_ok
    eng, group, args, ab, want = batches["default"]
    info = {"R": int(ab.shape[1]), "A": args["A"], "P": eng.db.P,
            "L_CAP": args["L_CAP"], "C_CAP": args["C_CAP"]}
    reset_launches()
    got = phase_a(eng.db.arrays, ab, **dict(args, compact_dp=False))
    torch.cuda.synchronize()
    info["compact_dp_off"] = {
        "rows_equal": _same_unless_overflow("compact_dp_off", got, want,
                                            len(group)),
        "rows_overflow": int(got[:len(group), -1].sum())}
    expand = {}
    for preset in _EXPAND_RUNS:
        e, g, a, b, w = batches[preset]
        P, A = e.db.P, a["A"]
        ex = expand[preset] = {"R": int(b.shape[1]), "P": P, "A": A,
                               "join_mode": a["join_mode"]}
        if not expand_ok(P, A):
            ex["skipped"] = (f"expand_ok(P={P}, A={A}) does not hold: the "
                             f"kernel takes A % 1024 == 0, P % 128 == 0 "
                             f"and P >= 2048")
            continue
        got = phase_a(e.db.arrays, b, **dict(a, expand_kernel=True))
        torch.cuda.synchronize()
        n = len(g)
        ex["rows_equal"] = _same_unless_overflow(
            f"expand_kernel[{preset}]", got, w, n)
        ex["rows_overflow"] = {"default": int(w[:n, -1].sum()),
                               "expand_kernel": int(got[:n, -1].sum())}
        if len(set(ex["rows_overflow"].values())) != 1:
            raise RuntimeError(f"padded: expand_kernel[{preset}]: rows "
                               f"overflowing {ex['rows_overflow']}")
    launches = read_launches()
    n_ok = sum("skipped" not in x for x in expand.values())
    for kernel, times in (("dp_chain_packed", 1), ("expand_anchors", n_ok)):
        if launches[kernel] != times or times == 0:
            raise RuntimeError(f"padded: {kernel} launched "
                               f"{launches[kernel]} times, not {times}")
    fn = lambda: phase_a(eng.db.arrays, ab, **dict(args, compact_dp=False))
    info["compact_dp_off"]["batch_ms"] = cuda_ms(fn, 10)
    info["compact_dp_off"]["profile"] = profile_phase_a(fn, 3)
    info["default_batch_ms"] = cuda_ms(
        lambda: phase_a(eng.db.arrays, ab, **args), 10)
    # the two expansions of each batch in turns: batch ms, the profiler's
    # kernels a batch and summed kernel ms, this repository's kernels by
    # name, and the expansion's device ms
    for preset, ex in expand.items():
        if "skipped" in ex:
            continue
        e, _g, a, b, _w = batches[preset]
        paths = {"default": a, "expand_kernel": dict(a, expand_kernel=True)}
        runs = {k: {"batch_ms": [], "kernels_per_batch": [], "kernel_ms": [],
                    "expansion_ms": [], "own_kernels_ms": []}
                for k in paths}
        for key in ("default", "expand_kernel", "expand_kernel", "default"):
            fn = lambda: phase_a(e.db.arrays, b, **paths[key])
            r = runs[key]
            r["batch_ms"].append(cuda_ms(fn, 10))
            prof = profile_phase_a(fn, 3)
            r["kernels_per_batch"].append(prof["kernels_per_batch"])
            r["kernel_ms"].append(prof["kernel_ms"])
            r["own_kernels_ms"].append(prof["own_kernels_ms"])
            r["expansion_ms"].append(expansion_ms(
                lambda st: phase_a(e.db.arrays, b,
                                   **dict(paths[key], stage=st))))
        ex.update(runs)
    info["expand_kernel"] = expand

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
def kernels(batch, medium_batch, slow_batch, ct_batch, cs_batch, c20_batch,
            aai_batch, search_batches, bw, rate, sass, name):
    """Every kernel against its plain version on the card.  K1-K3, the
    single-payload scatter, the packed padded DP and the expansion kernel
    at the default batch's shapes (the only path that gives the scatters P
    <= 65536); the windowed gather, the genome map gather and the 3-plane
    DP at the slow batch's; the padded DP at the many-contig slow batch's
    and the -c 20 batch's, where the genome map gather also runs, and on
    the AAI batch's own call (L_CAP 768, band 33); every kernel of the
    search batches (a resident `sorted` page and a `sorted_packed` page
    with reserved query rows) on their own calls; then
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

    def grab_calls(batch_, names, **over):
        """The arguments of every call of each device_pipeline kernel
        wrapper in `names` that one phase_a of batch_ (its arguments
        updated by `over`) makes, cloned, by name in call order."""
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
            phase_a(beng.db.arrays, bab, **dict(bargs, **over))
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

    def expand_bytes(offs, total, rows_t, A):
        """What the expansion needs on these inputs.  Each slot's source
        by the tile rule (G, the slot's upper bound in its row of offs,
        clamped into the tile's window); of offs, each row's positions up
        to one past its last valid slot's source (where the count ends)
        and the source of each slot at or past `total` (one a tile); of bs
        and apk, the 32-byte sectors that hold a slot's source, apk by
        distinct genome row; total and the row map read, aw and brow (R,
        A) and ovf written once."""
        o = offs.cpu().numpy()
        R_, P_ = o.shape
        nv = np.clip(total.cpu().numpy().astype(np.int64), 0, A)
        g = np.stack([np.searchsorted(o[r], np.arange(A), side="right")
                      for r in range(R_)])
        src = np.empty((R_, A), np.int64)
        cur = np.zeros(R_, np.int64)
        for t0 in range(0, A, 1024):
            cur = np.clip(cur, 0, P_ // 128 - 16)
            w0 = cur[:, None] * 128
            cnt = np.clip(g[:, t0:t0 + 1024] - w0, 0, 2048)
            src[:, t0:t0 + 1024] = w0 + cnt - 1
            cur = cur + ((cnt[:, -1] - 1) >> 7)
        some = src >= 0
        last = np.array([np.searchsorted(o[r], nv[r] - 1, side="right")
                         for r in range(R_)])
        need = np.arange(P_)[None, :] <= np.minimum(last, P_ - 1)[:, None]
        past = some & (np.arange(A)[None, :] >= nv[:, None])
        need[np.nonzero(past)[0], src[past]] = True
        rows_np = rows_t.cpu().numpy()
        sectors = (_sectors(R_, P_, src, mask=some)
                   + _sectors(R_, P_, src, mask=some, rows=rows_np))
        return 4 * (int(need.sum()) + 3 * R_ + 2 * R_ * A) \
            + _SECTOR * sectors

    def count_scale(offs, A):
        """torch.searchsorted of every slot in its row of offs: the count
        alone, one library call, beside the kernel for scale (event ms,
        device ms)."""
        sl = torch.arange(A, dtype=torch.int32, device=dev)[None, :].expand(
            offs.shape[0], A).contiguous()
        f = lambda: torch.searchsorted(offs, sl, right=True)
        return {"count_searchsorted_ms": cuda_ms(f, 20),
                "count_searchsorted_device_ms": device_ms(f)}

    # expand_anchors at the default batch: rows that emit nothing, fill the
    # buffer exactly, run out of the window, and pass the buffer; apk (R,
    # P) through the identity row map
    ex_np = synth.expand_case(rng, R, P, A)
    ex = [t(x) for x in ex_np] + [torch.arange(R, dtype=torch.int32,
                                               device=dev)]
    err, ms, pms, _ = compare(
        "expand_anchors", lambda: expand_pallas.expand_anchors(*ex[:4], A,
                                                               ex[4]),
        lambda: expand_pallas.expand_anchors_plain(*ex[:4], A, ex[4]), 20, 5)
    eovf = expand_pallas.expand_anchors(*ex[:4], A, ex[4])[2].tolist()
    if eovf[:4] != [0, 0, 1, 0]:
        raise RuntimeError("expand_anchors: overflow flags are not those "
                           f"of the adversarial rows: {eovf[:4]}")
    rows.append(dict(name="expand_anchors",
                     shape=[[R, P]] * 3 + [[R], [R, A], [R, A], [R]],
                     err=err, ms=ms, plain_ms=pms, library_ms=None,
                     bytes=expand_bytes(ex[0], ex[3], ex[4], A),
                     ops=_EXPAND_OPS_PER_SLOT * R * A, per_batch=1,
                     rows_flagged=int(sum(eovf)), ovf=eovf,
                     **count_scale(ex[0], A),
                     source="skani_tpu_torch/csrc/expand.cu",
                     replaces="skani_tpu/kernels/expand_pallas.py:105"))

    # expand_anchors on the --medium, slow and -c 20 batches' own calls
    # (phase_a with expand_kernel=True): apk through the row map of the
    # query genomes; the overflow flags are held with the outputs
    for key, batch_ in (("medium", medium_batch), ("slow", slow_batch),
                        ("c20", c20_batch)):
        eoffs, ebs, eapk, etot, eA, erows = grab_calls(
            batch_, ["expand_anchors"], expand_kernel=True)[
            "expand_anchors"][0]
        Re = int(eoffs.shape[0])
        fn = lambda: expand_pallas.expand_anchors(eoffs, ebs, eapk, etot, eA,
                                                  erows)
        err, ms, pms, _ = compare(
            f"expand_anchors[{key}]", fn,
            lambda: expand_pallas.expand_anchors_plain(
                eoffs, ebs, eapk, etot, eA, erows), 20, 2)
        eovf = fn()[2].tolist()
        rows.append(dict(name=f"expand_anchors[{key}]",
                         counter="expand_anchors",
                         device_ms_in_batch=device_ms_in_batch(fn,
                                                               (eoffs, ebs)),
                         shape=[list(eoffs.shape)] * 2 + [
                             list(eapk.shape), [Re], [Re, eA], [Re, eA],
                             [Re]],
                         err=err, ms=ms, plain_ms=pms, library_ms=None,
                         bytes=expand_bytes(eoffs, etot, erows, eA),
                         ops=_EXPAND_OPS_PER_SLOT * Re * eA, per_batch=1,
                         rows_flagged=int(sum(eovf)), ovf=eovf,
                         **count_scale(eoffs, eA),
                         dims={"G": int(eapk.shape[0]), "R": Re,
                               "P": int(eoffs.shape[1]), "A": eA,
                               "distinct_genomes":
                               int(np.unique(erows.cpu().numpy()).size)},
                         source="skani_tpu_torch/csrc/expand.cu",
                         replaces="skani_tpu/kernels/expand_pallas.py:105"))
        del eoffs, ebs, eapk, etot, erows

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

    # dp_chain on the AAI batch's own call: the legacy generator's padded
    # layout (768, R * C_CAP) at band 500 // 15
    call = grab_calls(aai_batch, ["dp_chain"])["dp_chain"][0]
    up, uargs = call[:3], call[3:]
    Lc, RCc = up[0].shape
    rcv_np = up[2].cpu().numpy()
    err, ms, pms, _ = compare(
        "dp_chain[aai]", lambda: dp_pallas.dp_chain(*up, *uargs),
        lambda: dp_pallas.dp_chain_plain(*up, *uargs), 10, 1)
    rows.append(dict(name="dp_chain[aai]", counter="dp_chain",
                     shape=[[Lc, RCc]] * 3, err=err, ms=ms, plain_ms=pms,
                     library_ms=None, bytes=4 * 5 * Lc * RCc,
                     ops=_DP_PADDED_OPS_PER_CANDIDATE
                     * dp_candidates((rcv_np & 1).T, uargs[0]),
                     per_batch=1, chain_steps=Lc, lanes=RCc,
                     valid_anchors=int((rcv_np & 1).sum()),
                     ring=dp_compact.ring_size(uargs[0]),
                     sass_per_step=sass.get(
                         f"dp_chain_kernel<{dp_compact.ring_regs(uargs[0])}>"),
                     steps=padded_steps(rcv_np),
                     source="skani_tpu_torch/csrc/dp_padded.cu",
                     replaces="skani_tpu/kernels/dp_pallas.py:240"))
    del up, call

    # the search batches' own calls: the default run's resident page (the
    # `sorted` generator over 64 references and 64 reserved query rows)
    # and a `sorted_packed` page of the paged run (2 reserved rows), each
    # on its first query chunk.  Every call of each kernel in its phase_a,
    # held against the plain version on the same inputs; times, bytes and
    # operations summed over the calls
    def gmap_bytes(skid_np, a_np, K):
        """Each distinct genome's skid row once, a_idx, the 32-byte jw
        sectors these indices touch, out."""
        R, P = a_np.size, skid_np.shape[1]
        return (4 * (np.unique(a_np).size * P + R + R * P)
                + _SECTOR * _sectors(R, K, skid_np[a_np]))

    def gather_spec(c):
        tb, idx = c[0], c[1]
        rows_t = c[2] if len(c) > 2 else None
        R_, K_ = idx.shape[0], tb.shape[1]
        rows_np = None if rows_t is None else np.clip(
            rows_t.cpu().numpy(), 0, tb.shape[0] - 1)
        return (lambda: gather.row_gather(*c),
                lambda: gather.row_gather_plain(*c), None,
                4 * (2 * idx.numel() + (0 if rows_t is None else R_))
                + _SECTOR * _sectors(R_, K_, idx.cpu().numpy(),
                                     rows=rows_np),
                2 * idx.numel(), [list(x.shape) for x in c])

    def gmap_spec(c):
        gskid, ga, gjw = c
        gl = ga.long().clamp(0, gskid.shape[0] - 1)
        return (lambda: gather.genome_map_gather(*c),
                lambda: gather.genome_map_gather_plain(*c),
                lambda: torch.gather(gjw, 1, gskid[gl].long()),
                gmap_bytes(gskid.cpu().numpy(),
                           np.clip(ga.cpu().numpy(), 0, gskid.shape[0] - 1),
                           gjw.shape[1]),
                2 * gjw.shape[0] * gskid.shape[1],
                [list(gskid.shape), list(ga.shape), list(gjw.shape)])

    def scatter_spec(name, plain):
        def spec(c):
            idx, vals, K_ = c
            V = 1 if vals.dim() == 2 else vals.shape[1]
            return (lambda: getattr(gather, name)(*c),
                    lambda: plain(*c),
                    scatter_library(idx, vals if V > 1 else vals[:, None],
                                    K_),
                    scatter_bytes(idx, V, K_), (V + 1) * idx.numel(),
                    [list(idx.shape), list(vals.shape), K_])
        return spec

    def dp_spec(name, plain, planes, per_candidate):
        def spec(c):
            ins, rest = c[:planes + 1], c[planes + 1:]
            R_, A_ = ins[0].shape
            return (lambda: getattr(dp_compact, name)(*ins, *rest),
                    lambda: plain(*ins, *rest), None,
                    4 * (planes + 3) * R_ * A_,
                    per_candidate * dp_candidates(
                        ins[0].cpu().numpy() & 1, rest[0]),
                    [[R_, A_]] * (planes + 1))
        return spec

    specs = {
        "row_gather": gather_spec, "genome_map_gather": gmap_spec,
        "row_scatter": scatter_spec("row_scatter", gather.row_scatter_plain),
        "row_scatter_multi": scatter_spec("row_scatter_multi",
                                          gather.row_scatter_multi_plain),
        "dp_chain_compact": dp_spec(
            "dp_chain_compact", dp_compact.dp_chain_compact_plain, 2,
            _DP_OPS_PER_CANDIDATE),
        "dp_chain_compact_wide": dp_spec(
            "dp_chain_compact_wide", dp_compact.dp_chain_compact_wide_plain,
            3, _DP_WIDE_OPS_PER_CANDIDATE)}
    for tag, names in (("search", ("row_gather", "genome_map_gather",
                                   "row_scatter", "dp_chain_compact_wide")),
                       ("search_paged", ("row_gather", "genome_map_gather",
                                         "row_scatter_multi",
                                         "dp_chain_compact"))):
        sb = search_batches[tag]
        got = grab_calls(sb, list(names))
        for n in names:
            key = f"{n}[{tag}]"
            acc = dict(err=0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bytes=0, ops=0)
            shapes = []
            slow = n.startswith("dp_")
            for c in got[n]:
                fn, plain, lib, nbytes, ops, shape = specs[n](c)
                err, ms, pms, lms = compare(key, fn, plain, 20,
                                            1 if slow else 5, library=lib)
                acc["err"] = max(acc["err"], err)
                acc["ms"] += ms
                acc["plain_ms"] += pms
                acc["library_ms"] = None if lms is None \
                    or acc["library_ms"] is None else acc["library_ms"] + lms
                acc["bytes"] += nbytes
                acc["ops"] += ops
                shapes.append(shape)
            beng = sb[0]
            rows.append(dict(
                name=key, counter=n, shape=shapes, per_batch=len(got[n]),
                dims={"G": beng.db.G, "K": beng.db.K, "P": beng.db.P,
                      "reserved_base": beng.reserved_base,
                      "R": int(sb[3].shape[1]), "A": sb[2]["A"],
                      "gen_mode": beng.gen_mode},
                source=("skani_tpu_torch/csrc/dp_compact.cu" if slow
                        else "skani_tpu_torch/csrc/gather.cu"),
                replaces=_REPLACES[n], **acc))
        del got

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
              "rows_flagged": r.get("rows_flagged"), "ovf": r.get("ovf"),
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
              "launches_are": r.get("launches_are"),
              "count_searchsorted_ms": r.get("count_searchsorted_ms"),
              "count_searchsorted_device_ms":
              r.get("count_searchsorted_device_ms"), "card": name})
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
    device_route()
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
        by_path["triangle_sketch"] = triangle_sketch(tmp, sets)
        by_path["hybrid"] = hybrid(tmp, sets)
        search_runs, search_batches = search(tmp, sets, a.seed, a.length)
        by_path.update(search_runs)
        by_path["triangle_aai"], aai_batch = triangle_aai(tmp, a.seed)
        by_path.update(search_aai(tmp))
        by_path["seeding"], seed_row = seeding_phase(
            tmp, sets, a.seed, a.length, bw, rate, sass, name)
        by_path.update(fleet(tmp, sets))
        by_path.update(multihost_phase(tmp, sets))
        by_path["bench"] = bench_phase()
        by_path["scale"] = scale_phase(tmp)
        by_path["tools"] = tools_phase()
        batches = {}
        for preset in _RUNS:
            key = "phase_a" if preset == "default" else f"phase_a_{preset}"
            batches[preset] = phase(key)(phase_a_parity)(
                sets, preset, preset == "default")
        batch = batches["default"]
        by_path["padded"] = padded(batches, sets, a.seed)
    by_path["joins"] = joins(batch)
    rows = kernels(batch, batches["medium"], batches["slow"],
                   batches["contigs"], batches["contigs_slow"],
                   batches["c20"], aai_batch, search_batches, bw, rate,
                   sass, name) + [seed_row]
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
                  "own_launches", "launches_are", "device_ms_in_batch",
                  "count_searchsorted_ms", "count_searchsorted_device_ms",
                  "ops_per_window", "sass_per_window", "sass_per_window_all",
                  "kernels_device_ms",
                  "windows",
                  "seeds", "markers"):
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
