"""Eukaryote-MAG-scale demo: a ~65 Mbp genome pair scored on the card,
exact against the native path.

This is the tier the reference exercises with its TOPAZ eukaryote MAG
fixtures (reference: tests/tests.rs:82-128): a single-contig genome this
size

  * exceeds the packed position word (pos >= 2^24 - 64K), forcing the
    UNPACKED `sorted` generation mode;
  * exceeds 2^19 seed-position rows, forcing the split-gather join
    branch (the packed b_start << 12 | cnt join word runs out of bits);
  * needs bucket-scaled chunk/interval caps (~3250 real 20 kb fragments
    vs the 512 default).

    python -m skani_tpu_torch.tools.mag_scale_demo [--device cuda|cpu]
        [--min-p N]

Env: BENCH_MAG_LEN (default 65_000_000), BENCH_MAG_DIV (default 0.02).
A genome shorter than 2^24 bases stays in the packed `sorted_packed`
mode; `--min-p (1 << 19) + 4096` still sends it down the split-gather
branch (the tests' small run).  Prints the engine's mode, A, P and caps,
the cold and warm device runs of both orientations (host_workers=0) and
the native ones, each pair held on ANI, both AFs and both CI bounds, then
one JSON line; exits 1 on any mismatch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .. import CommandParams, SketchParams, stats, synth
from ..ani import chain_seeds_native
from ..kernels.device_db import PACK_POS_BITS
from ..kernels.device_pipeline import DevicePairEngine, resolve_device
from ..params import map_params_from_sketch
from ..sketch import Sketch, _finalize_sketch, default_seeder
from .common import card, same_result, stages

BASES = synth.BASES


def _mk_sketch(seq, sp, name):
    seeder = default_seeder(sp)
    sk = Sketch(file_name=name, marker_c=sp.marker_c, c=sp.c, k=sp.k)
    sk.contigs.append(f"{name}_c0")
    sk.contig_lengths = np.append(sk.contig_lengths, np.uint32(len(seq)))
    sk.total_sequence_length = len(seq)
    km, po, ca, ma = seeder(seq, sp)
    _finalize_sketch(sk, [km], [po], [ca],
                     [np.full(len(km), 0, np.uint32)], [ma])
    return sk


def _expected_mode(length: int):
    """The generator a single-contig genome of `length` bases must take:
    `sorted` past the packed position word, `sorted_packed` well under
    it, either in the 64 kb margin below 2^24."""
    if length >= 1 << PACK_POS_BITS:
        return ("sorted",)
    if length <= (1 << PACK_POS_BITS) - 65536:
        return ("sorted_packed",)
    return ("sorted", "sorted_packed")


def run(length: int, div: float, device=None, min_p: int = 0,
        log=print) -> dict:
    """The demo at `length` bases and `div` divergence on `device`
    (default CUDA): its numbers, "mismatches" among them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(3)
    t0 = time.time()
    base = BASES[rng.integers(0, 4, size=length)]
    other = base.copy()
    nm = int(length * div)
    p = rng.choice(length, size=nm, replace=False)
    other[p] = BASES[rng.integers(0, 4, size=nm)]
    log(f"synthesized 2 x {length / 1e6:.0f} Mbp genomes "
        f"({div:.1%} divergence) in {time.time() - t0:.1f}s")

    sp = SketchParams()          # default c=125 / k=15
    cp = CommandParams()
    t0 = time.time()
    sks = [_mk_sketch(base, sp, "magA"), _mk_sketch(other, sp, "magB")]
    sketch_s = time.time() - t0
    log(f"sketched in {sketch_s:.1f}s "
        f"({len(sks[0].seed_pos)} / {len(sks[1].seed_pos)} seed "
        f"positions)")

    mp = map_params_from_sketch(sks[0], False, cp, None)
    t0 = time.time()
    want = [chain_seeds_native(sks[0], sks[1], mp),
            chain_seeds_native(sks[1], sks[0], mp)]
    t_native = time.time() - t0
    log(f"native: {t_native:.1f}s for 2 ordered pairs "
        f"(ANI {want[0].ani * 100:.2f}, AF "
        f"{want[0].align_fraction_query * 100:.1f}/"
        f"{want[0].align_fraction_ref * 100:.1f})")

    t0 = time.time()
    eng = DevicePairEngine(sks, sp, cp, device=dev, min_p=min_p)
    build_s = time.time() - t0
    modes = _expected_mode(length)
    if eng.gen_mode not in modes:
        raise AssertionError(f"gen_mode {eng.gen_mode!r}, expected one of "
                             f"{modes} at {length} bases")
    if eng.db.P < (1 << 19):      # the split-gather join
        raise AssertionError(f"P {eng.db.P} < 2^19")
    icap, ccap = eng._caps_for(eng._bucket_a(0, 1))
    log(f"engine: mode={eng.gen_mode} join={eng.join_mode} "
        f"A={eng.A} P={eng.db.P} C_CAP={ccap} I_CAP={icap} "
        f"(built in {build_s:.1f}s)")

    pairs = [(0, 1), (1, 0)]
    s0 = stats.snapshot()
    t0 = time.time()
    got = eng.run_pairs(pairs, host_workers=0)   # device only, no stealing
    t_cold = time.time() - t0
    st_cold = stages(s0)
    log(f"device (cold, incl. first launches): {t_cold:.1f}s")
    s0 = stats.snapshot()
    t0 = time.time()
    got = eng.run_pairs(pairs, host_workers=0)
    t_dev = time.time() - t0
    st_warm = stages(s0)
    log(f"device (warm): {t_dev:.1f}s for 2 ordered pairs")

    bad = 0
    for a, b in zip(got, want):
        ok = same_result(a, b)
        if not ok:
            log(f"MISMATCH: device ({a.ani}, {a.align_fraction_query}) "
                f"!= native ({b.ani}, {b.align_fraction_query})")
        bad += not ok
    bad += abs(len(got) - len(want))
    log(f"exactness: {'OK' if bad == 0 else f'{bad} MISMATCHES'}; "
        f"device {t_dev / 2:.2f} s/pair vs native "
        f"{t_native / 2:.2f} s/pair")
    return {
        "length": length, "div": div, "device": card(dev),
        "seed_positions": [len(s.seed_pos) for s in sks],
        "gen_mode": eng.gen_mode, "join_mode": eng.join_mode,
        "A": eng.A, "P": eng.db.P, "C_CAP": ccap, "I_CAP": icap,
        "min_p": min_p, "sketch_s": sketch_s, "engine_build_s": build_s,
        "native_s_per_pair": t_native / 2,
        "device_cold_s_per_pair": t_cold / 2,
        "device_warm_s_per_pair": t_dev / 2,
        "stages": {"cold": st_cold, "warm": st_warm},
        "ani": float(want[0].ani), "mismatches": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--min-p", type=int, default=0,
                    help="floor of the padded seed-position width")
    a = ap.parse_args(argv)
    out = run(int(os.environ.get("BENCH_MAG_LEN", "65000000")),
              float(os.environ.get("BENCH_MAG_DIV", "0.02")),
              a.device, a.min_p)
    print(json.dumps(out), flush=True)
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
