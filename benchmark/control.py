"""The control of a cell's correctness check: the plain reference put in
the program's place, its estimates in float32 (the precision below the
float64 that the configuration states), held to the float64 reference on
the same sample as a run's check, at the cell's own sizes.  It has to
come out not correct; the benchmark's runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed: the control's readings beside the cell's limits.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402
from benchmark.run import Context  # noqa: E402


def control_readings(cell: str, seed: int, device: str, workdir: str,
                     cache_dir: str, overrides: dict = None) -> dict:
    """The control's readings on `seed`: inputs made as a run makes them
    (no window, no program call), then the float32 reference against the
    float64 one."""
    ctx = Context(cell, seed, 0.0, device, workdir, cache_dir, False,
                  overrides)
    drv = harness.driver(ctx.workload["driver"])
    drv.prepare(ctx)
    return drv.control(ctx, device, np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    harness.setup_env()
    limits = harness.workload(args.workload)["limits"]
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="skani_control_")
        try:
            r = control_readings(args.workload, seed, "cuda", workdir,
                                 harness.CACHE_DIR)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        failed = [k for k, lim in limits.items() if r[k] > lim]
        bad += not failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": r, "limits": limits,
                          "control_fails": failed}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
