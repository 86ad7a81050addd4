"""The benchmark of skani_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell in benchmark/workloads/<cell>.json, its configuration in
benchmark/configs/, its driver in benchmark/drivers/ and its metrics in
benchmark/metrics/ (the cells each metric of BENCHMARK.json lists).  It
checks that exactly the cell's chips are visible CUDA devices, builds the
inputs from the seed and warms up (`setup_s`, from process start), drives
the program for `--seconds` (timed with the profiler off; `--trace 1`
runs the window under torch.profiler with the benchmark's spans, and
reports the per-layer metrics), then holds what the window produced to
the plain reference, and prints one JSON line last on standard output.
Exit 0 only with a result; a run without the cell's CUDA devices, or
that finds JAX or the JAX package loaded after its window, prints none.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


class Context:
    """A run's state, handed to the driver."""

    def __init__(self, cell: str, seed: int, seconds: float, device: str,
                 workdir: str, cache_dir: str, trace: bool,
                 overrides: dict = None):
        overrides = overrides or {}
        self.cell = cell
        self.workload = harness.workload(cell)
        self.config = harness.config(self.workload["config"])
        self.config.update(overrides.get("config", {}))
        self.traffic = self.workload["traffic"]
        self.traffic.update(overrides.get("traffic", {}))
        self.seed = seed
        self.seconds = seconds
        self.device = device
        self.workdir = workdir
        self.cache_dir = cache_dir
        self.hooks = harness.Hooks()
        self.timings = {}
        self.spans = harness.Spans() if trace else None


def dp_roofline_hooks(ctx, launches: list) -> None:
    """Traced run: each DP launch's frozen operation and byte counts, on
    its own inputs, and CUDA events around it."""
    import torch
    from skani_tpu_torch.kernels import device_pipeline
    from benchmark.roofline import dp_counts

    def make(kind):
        def wrap(fn):
            def wrapped(*a, **kw):
                ops, nbytes = dp_counts.counts(kind, a)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **kw)
                e1.record()
                launches.append((kind, ops, nbytes, e0, e1))
                return out
            return wrapped
        return wrap

    for kind in dp_counts.KINDS:
        ctx.hooks.wrap(device_pipeline, kind, make(kind))


def dp_launch_counters() -> dict:
    from skani_tpu_torch.kernels import dp_compact, dp_pallas
    return {**dp_compact.LAUNCHES, **dp_pallas.LAUNCHES}


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", workdir: str = None,
             cache_dir: str = None, overrides: dict = None) -> dict:
    """One run; returns the result line's object.  `device` "cpu" (the
    program's plain kernel versions) and `overrides` (keys of the
    configuration and the traffic replaced, to shrink a cell) are for
    the tests alone."""
    import torch
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="skani_bench_")
    ctx = Context(cell, seed, seconds, device, workdir,
                  cache_dir or harness.CACHE_DIR, trace, overrides)
    drv = harness.driver(ctx.workload["driver"])
    bench = harness.benchmark_json()
    run = harness.Run(cell=cell, seed=seed, trace=trace)
    if device == "cpu":
        _route_to_cpu(ctx)
    try:
        drv.setup(ctx)
        if device == "cuda":
            torch.cuda.synchronize()
        # what set-up wrote (inputs, a first run's database) goes to disk
        # now, not while the window runs
        os.sync()
        run.setup_s = time.perf_counter() - T_START
        launches = []
        prof = None
        if trace:
            drv.install_spans(ctx)
            if device == "cuda":
                dp_roofline_hooks(ctx, launches)
                counters0 = dp_launch_counters()
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
        units, run.window_s, caps = drv.window(ctx, seconds)
        if device == "cuda":
            torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        run.units = units
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        ctx.hooks.close()
        if prof is not None:
            run.profile = _read_profile(prof, launches,
                                        dp_launch_counters(), counters0)
            del prof
        _free_program_state(device)
        t_check = time.perf_counter()
        readings = drv.check(ctx, units, caps, device)
        readings["check_s"] = time.perf_counter() - t_check
    finally:
        ctx.hooks.close()
        if own_tmp:
            shutil.rmtree(workdir, ignore_errors=True)

    limits = ctx.workload["limits"]
    failed = sum(1 for u in units if not u.ok)
    checks = {name: {"value": readings[name], "limit": lim}
              for name, lim in limits.items()}
    checks["failed"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in harness.cell_metrics(bench, cell, kind):
        v = harness.metric_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if device == "cuda":
        kind_name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
    else:
        kind_name, count = "cpu", 0
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": kind_name, "count": count, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(units), "failed": failed,
           "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["readings"] = {k: v for k, v in readings.items()
                       if k not in checks}
    out["readings"].update(window_s=run.window_s, **ctx.timings)
    out["readings"]["walls"] = [round(u.wall, 4) for u in units]
    out["readings"]["errors"] = [u.error for u in units if not u.ok][:3]
    if run.profile is not None:
        out["readings"]["dp_launches"] = run.profile["dp"]["counts"]
    out["checks"] = checks
    # looked at last: the check and the metric readers run after the
    # window, and what they load counts too
    found = harness.forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    return out


class ForbiddenModules(RuntimeError):
    pass


def _route_to_cpu(ctx) -> None:
    """Tests only: the engine and the search path on the CPU (plain
    kernel versions), everything else as on the card."""
    from skani_tpu_torch import engine
    ctx.hooks.wrap(engine, "triangle",
                   lambda fn: lambda cp, sp, executor=None, **kw:
                   fn(cp, sp, executor, devices=["cpu"], **kw))
    ctx.hooks.wrap(engine, "search",
                   lambda fn: lambda cp, executor=None, **kw:
                   fn(cp, executor, device="cpu", **kw))


def _free_program_state(device: str) -> None:
    from skani_tpu_torch import engine
    engine._resident_engines.clear()
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def _read_profile(prof, launches, counters1, counters0) -> dict:
    """Busy and idle from the trace; the DP launches' least time against
    their device time (the profiler's, where its DP kernel count matches
    the program's launch counters, else the CUDA events')."""
    import torch
    from benchmark.roofline import dp_counts
    events = prof.events()
    starts = [e.time_range.start for e in events]
    ends = [e.time_range.end for e in events]
    t0_us, t1_us = min(starts), max(ends)
    summary = harness.summarize_trace(events, t0_us, t1_us)
    dp_prof = [(n, d) for n, _s, d in summary.pop("device_events")
               if dp_counts.kernel_kind(n)]
    counted = sum(counters1[k] - counters0.get(k, 0) for k in counters1)
    peaks = dp_counts.peaks(torch.cuda.get_device_name(0))
    least = sum(dp_counts.least_seconds(ops, nb, peaks)
                for _k, ops, nb, _e0, _e1 in launches)
    ev_s = sum(e0.elapsed_time(e1) / 1e3
               for _k, _o, _b, e0, e1 in launches)
    prof_s = sum(d for _n, d in dp_prof) / 1e6
    use_prof = len(dp_prof) == counted == len(launches)
    summary["dp"] = dict(
        least_s=least, device_s=prof_s if use_prof else ev_s,
        source="profiler" if use_prof else "cuda_events",
        counts={"profiler": len(dp_prof), "launch_counters": counted,
                "wrapped": len(launches), "profiler_s": prof_s,
                "events_s": ev_s})
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.setup_env()
    chips = next(w["chips"] for w in harness.benchmark_json()["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() != chips:
        print(f"{torch.cuda.device_count()} CUDA devices visible; the cell "
              f"{args.workload} runs on exactly {chips}", file=sys.stderr)
        return 2
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace))
    except ForbiddenModules as e:
        print(f"modules loaded that the benchmark forbids: {e}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
