"""Streaming all-vs-all demo: N synthetic genomes through `triangle`
--sparse with bounded executor batches and 5000-row intermediate flushes.

Evidence for the scale claims: peak RSS stays flat (pairs are generated
row by row and results leave through append-mode flushes) while the pair
count grows quadratically.  Defaults: 300 genomes of ~40 kb -> 44,850
candidate pairs on one host.  The run on the device executor (the card)
is followed by the same run on the native executor; the two TSVs must be
byte-identical (exit 1 otherwise).

    python -m skani_tpu_torch.tools.triangle_scale_demo [n_genomes]
        [genome_bp] [--device cuda|cpu]

On `--device cpu` the device run takes the device engine on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from .. import CommandParams, SketchParams, engine, stats, synth
from ..kernels.device_pipeline import resolve_device
from .common import card, peak_rss_mb, stages

BASES = synth.BASES


def run(n: int, bp: int, device=None, work=None, log=print) -> dict:
    """The demo on `device` (default CUDA): its numbers, "mismatches"
    among them."""
    from ..kernels.pipeline import torch_pair_executor
    dev = resolve_device(device)
    rng = np.random.default_rng(11)
    base = BASES[rng.integers(0, 4, bp)]
    tmp = work or tempfile.mkdtemp(prefix="skani_tri_scale_")
    os.makedirs(tmp, exist_ok=True)
    paths = []
    for g in range(n):
        s = synth.mutate(rng, base, rng.uniform(0.002, 0.08))
        paths.append(synth.write_fasta(os.path.join(tmp, f"g{g:04d}.fa"),
                                       f"g{g:04d}", [s]))

    def one(tag, executor):
        out = os.path.join(tmp, f"tri_{tag}.tsv")
        cp = CommandParams(ref_files=paths, out_file_name=out, sparse=True,
                           screen=True, threads=3)
        s0 = stats.snapshot()
        t0 = time.monotonic()
        engine.triangle(cp, SketchParams(), executor=executor)
        dt = time.monotonic() - t0
        with open(out, "rb") as f:
            data = f.read()
        return dt, data, stages(s0)

    dt, got, st = one("device", torch_pair_executor(device=dev))
    rows = len(got.splitlines()) - 1
    rss_mb = peak_rss_mb()
    log(f"{n} genomes ({bp} bp), {n * (n - 1) // 2} candidate pairs -> "
        f"{rows} result rows in {dt:.1f}s; peak RSS {rss_mb:.0f} MB")
    dt_nat, want, _ = one("native", engine._default_pair_executor)
    bad = int(got != want)
    log(f"native executor: {dt_nat:.1f}s; TSV "
        f"{'identical' if not bad else 'DIFFERS'}")
    return {"genomes": n, "bp": bp, "candidate_pairs": n * (n - 1) // 2,
            "rows": rows, "wall_s": dt, "native_wall_s": dt_nat,
            "peak_rss_mb": rss_mb, "stages": st, "device": card(dev),
            "mismatches": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_genomes", nargs="?", type=int, default=300)
    ap.add_argument("genome_bp", nargs="?", type=int, default=40_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = run(a.n_genomes, a.genome_bp, a.device)
    print(json.dumps(out), flush=True)
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
