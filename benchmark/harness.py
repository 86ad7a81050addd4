"""The benchmark's machinery: discovery by name, the run record that the
metric readers read, hooks on the program's module attributes, spans and
the reading of the profiler's trace.

A cell is `workloads/<cell>.json` (its configuration, its driver and the
driver's traffic parameters, and the limits of its correctness numbers);
a configuration is `configs/<config>.json`; a driver is
`drivers/<driver>.py`; a metric is `metrics/<metric>.py`, whose
`read(run)` returns a number or None.  Nothing here imports the program:
the drivers do.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the benchmark's caches (the search database), at a fixed path inside
#: the checkout, so that only a checkout's first run builds them
CACHE_DIR = os.path.join(HERE, ".cache")
#: modules that no run may hold once its window has closed, compared by
#: whole top-level name ("skani_tpu_torch" is not "skani_tpu")
FORBIDDEN = ("jax", "jaxlib", "flax", "skani_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def config(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def benchmark_json() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load_file(os.path.join(HERE, "drivers", f"{name}.py"),
                      f"bench_driver_{name}")


def metric_reader(name: str) -> Callable:
    mod = _load_file(os.path.join(HERE, "metrics", f"{name}.py"),
                     "bench_metric_" + name.replace(".", "_"))
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell`
    reports: those that list it, or that list no cells."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that FORBIDDEN holds, whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def setup_env() -> None:
    """Caches of libraries the program may load, at fixed paths inside
    the checkout (the program's own kernel builds already live in its
    package directory); keep `transformers` from loading JAX."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(CACHE_DIR, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# --- the run record --------------------------------------------------------

@dataclasses.dataclass
class Unit:
    """One job or call of the window."""
    wall: float
    ok: bool
    work: float                      # pairs of a job, 1 for a call
    stats: Dict[str, float]          # the program's stats deltas
    spans: Dict[str, float]          # benchmark span seconds (traced run)
    counts: Dict[str, float]         # benchmark counts (sizes, passes)
    error: str = ""


@dataclasses.dataclass
class Run:
    """What a run measured; every metric reader reads one of these."""
    cell: str
    seed: int
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    units: List[Unit] = dataclasses.field(default_factory=list)
    profile: Optional[dict] = None   # trace summary (traced run only)

    def ok_units(self) -> List[Unit]:
        return [u for u in self.units if u.ok]

    def total(self, key: str, where: str = "stats") -> float:
        return sum(getattr(u, where).get(key, 0.0) for u in self.ok_units())


# --- hooks -----------------------------------------------------------------

class Hooks:
    """Replaces attributes of the program's modules and classes with
    wrappers and puts every one back on close()."""

    def __init__(self):
        self._saved = []

    def wrap(self, owner, attr: str, make: Callable) -> None:
        orig = getattr(owner, attr)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def close(self) -> None:
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)


class Spans:
    """Benchmark spans around calls into the program's layers (traced
    runs only): seconds summed by name until take(), and a `bench:<name>`
    range in the profiler's trace."""

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._lock = threading.Lock()

    def span(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            import torch
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("bench:" + name):
                    return fn(*a, **kw)
            finally:
                self.add(name, time.perf_counter() - t0)
        return wrapped

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds

    def take(self) -> Dict[str, float]:
        with self._lock:
            acc, self._acc = self._acc, {}
        return acc


def stats_delta(after: Dict[str, float], before: Dict[str, float]
                ) -> Dict[str, float]:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0) != 0.0}


# --- the profiler's trace --------------------------------------------------

def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize_trace(events, t0_us: float, t1_us: float,
                    top: int = 10) -> dict:
    """From the profiler's events: device intervals (kernels, copies and
    sets) merged, busy seconds within [t0_us, t1_us], device operations by
    total time, idle gaps each labelled by the innermost `bench:` range
    open at its middle, and the device operations themselves
    (name, start_us, dur_us)."""
    dev, spans = [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith("bench:"):
            # a range appears on the host's timeline and, as an
            # annotation, on the device's: only the host's is a span
            if not _is_device(e):
                spans.append((tr.start, tr.end, e.name[6:]))
        elif _is_device(e) and not getattr(e, "is_user_annotation", False):
            dev.append((e.name, tr.start, tr.end - tr.start))
    merged = _merge([[max(s, t0_us), min(s + d, t1_us)] for _n, s, d in dev
                     if s + d > t0_us and s < t1_us])
    busy_us = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for n, _s, d in dev:
        by_name[n] = by_name.get(n, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = t0_us
    for s, e in merged + [[t1_us, t1_us]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans.sort(key=lambda x: (x[0], -x[1]))

    def label(mid):
        inner = None
        for s, e, n in spans:
            if s <= mid <= e and (inner is None or s >= inner[0]):
                inner = (s, e, n)
        return inner[2] if inner else "outside any span"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return dict(
        busy_s=busy_us / 1e6, window_s=(t1_us - t0_us) / 1e6,
        device_ops=[[n, d / 1e6] for n, d in ops],
        idle_gaps=[[label((s + e) / 2), (e - s) / 1e6] for s, e in longest],
        device_events=dev)


def _is_device(e) -> bool:
    dt = getattr(e, "device_type", None)
    return dt is not None and "CUDA" in str(dt)
