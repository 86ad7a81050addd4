"""Process-wide driver/engine accounting: counters and spans.

Answers the "where did the wall time go" question for a whole driver run
(the gap between batch-level device throughput and end-to-end driver
throughput): per-phase wall time, pair routing (device vs host-steal vs
mirrored, and the exact per-pair fallback for overflow rows), the device
batch count and the bytes uploaded to the device (`upload_bytes`).

`add` bumps a counter.  `span(name)` times a block of work where it
happens and adds its wall seconds to the counter `<name>_s`, always.
Spans nest on each thread (a thread-local stack), and each adds its
duration to its parent's child time.  A root span (`root_span`:
`triangle`, `search`, `dist`, one per driver call) takes a call id from a
process counter and also adds `<name>_self_s`, its duration less the spans directly under it
on its thread: the time inside the call that no span accounts for.

Only while a torch profiler is recording does a span open a
`torch.profiler.record_function` range, named `skt:<name>`, and
`skt:<name>#<call id>` for a root; ranges of the threads a call starts
lie inside its root's interval on the profiler's clock, so they are
matched to the call by time.  Without a profiler a span costs two
perf_counter reads and a lock, makes no torch call and never
synchronizes the device, so the counters stay always on.

Drivers emit one summary log line at the end of a run (`driver_report`,
engine.py); `tools/idle_by_span.py` splits the device's idle time by
the innermost `skt:` range open over it.

reference analog: skani logs coarse phase times only (src/dist.rs:180-186
"Generating sketch time"/"ANI calculation time"); the routing accounting
is specific to the batched device engine.
"""
from __future__ import annotations

import functools
import itertools
import sys
import threading
import time
from typing import Dict, Optional

_lock = threading.Lock()
_counters: Dict[str, float] = {}
_local = threading.local()
_call_ids = itertools.count(1)


def add(name: str, value: float = 1.0) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def _profiling() -> bool:
    """True while a torch profiler records (no torch import otherwise:
    without torch loaded no profiler can run)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))


class span:
    """`with stats.span(name) as s:` times the block into `<name>_s`; see
    the module docstring.  `root=True` opens a driver call: the span takes
    a call id and reports `<name>_self_s`.  `s.seconds` holds the duration
    after the block, and `s.call` a root's call id."""

    __slots__ = ("name", "root", "call", "seconds", "_child", "_parent",
                 "_range", "_t0")

    def __init__(self, name: str, root: bool = False):
        self.name = name
        self.root = root
        self.call: Optional[int] = None
        self.seconds = 0.0

    def __enter__(self) -> "span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self._parent = stack[-1] if stack else None
        self._child = 0.0
        self._range = None
        if self.root:
            self.call = next(_call_ids)
        if _profiling():
            import torch
            label = "skt:" + self.name
            if self.call is not None:
                label += f"#{self.call}"
            self._range = torch.profiler.record_function(label)
            self._range.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        self.seconds = dt
        _local.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self._parent is not None:
            self._parent._child += dt
        key = self.name + "_s"
        with _lock:
            _counters[key] = _counters.get(key, 0.0) + dt
            if self.root:
                key = self.name + "_self_s"
                _counters[key] = _counters.get(key, 0.0) + dt - self._child
        return False

    def self_seconds(self) -> float:
        """An open span's time so far less the spans directly under it on
        its thread."""
        return time.perf_counter() - self._t0 - self._child


def root_span(name: str):
    """Decorator: each call of the function runs inside the root span
    `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(name, root=True):
                return fn(*a, **kw)
        return wrapped
    return wrap


def _open_root() -> Optional[span]:
    """The innermost root span open on this thread, if any."""
    for s in reversed(getattr(_local, "stack", None) or ()):
        if s.root:
            return s
    return None


def snapshot() -> Dict[str, float]:
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()


def driver_report(driver: str, wall_s: float,
                  since: Dict[str, float] | None = None) -> str:
    """One-line end-of-driver summary. Counters are process-global and
    monotonic; pass `since` (a snapshot() taken at driver entry) to
    report only this run's deltas.  Phases and their splits appear where
    they took time; inside a driver call, `uncovered` is its root span's
    time so far that no span under it accounts for."""
    c = snapshot()
    base = since or {}

    def g(k):
        return c.get(k, 0.0) - base.get(k, 0.0)

    phases = " ".join(
        f"{k}={g(k + '_s'):.2f}s"
        for k in ("sketch", "index", "screen", "markers_read", "db_open",
                  "load", "executor", "write")
        if g(k + "_s") > 0.0)
    split = " ".join(
        f"{name}={g(k):.2f}s"
        for name, k in (("sketch_read", "sketch_read_s"),
                        ("sketch_seed", "sketch_seed_s"),
                        ("db_pack", "db_pack_s"),
                        ("db_upload", "db_upload_s"),
                        ("update_rows_pack", "update_rows_pack_s"),
                        ("update_rows_upload", "update_rows_upload_s"),
                        ("dispatch", "dispatch_s"),
                        ("drain", "run_pairs_drain_s"),
                        ("steal", "steal_s"))
        if g(k) > 0.0)
    pairs = (f"pairs[device={int(g('pairs_device'))}"
             f" host={int(g('pairs_host'))}"
             f" mirrored={int(g('pairs_mirrored'))}"
             f" overflow={int(g('pairs_overflow'))}]")
    markers = (f"markers[native={int(g('markers_native'))}"
               f" fallback={int(g('markers_fallback'))}]"
               if g("markers_native") or g("markers_fallback") else "")
    sketch = (f"sketch[native={int(g('sketch_native'))}"
              f" fallback={int(g('sketch_fallback'))}]"
              if g("sketch_native") or g("sketch_fallback") else "")
    db_pack = (f"db_pack[native={int(g('db_pack_native'))}"
               f" fallback={int(g('db_pack_fallback'))}]"
               if g("db_pack_native") or g("db_pack_fallback") else "")
    dev = (f"batches={int(g('device_batches'))}"
           f" readback={g('readback_s'):.2f}s"
           f" finalize={g('finalize_s'):.2f}s"
           f" upload_mb={g('upload_bytes') / 1e6:.1f}")
    root = _open_root()
    if root is not None:
        dev += f" uncovered={root.self_seconds():.2f}s"
    return " ".join(p for p in (f"perf[{driver}]: wall={wall_s:.2f}s",
                                phases, split, sketch, markers, db_pack,
                                pairs, dev) if p)
