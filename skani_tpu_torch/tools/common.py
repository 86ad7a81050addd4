"""What bench_torch.py and the scale demos share: the synthetic source
genome, the exact comparison of two results, the card's name and power
limit, the commands' stage counters as deltas, environment overrides and
peak RSS.  Imports no JAX."""
from __future__ import annotations

import contextlib
import functools
import os
import resource
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import stats, synth

# the synthetic stand-in for an E. coli-scale assembly: one random base
# with four repeats in 2, 4, 8 and 200 copies (chip_smoke.py's base, from
# its default seed)
SOURCE_SEED = 20261016
SOURCE_COPIES = (2, 4, 8, 200)
SOURCE_LEN = 5_000_000

# the five fields a result is compared on
FIELDS = ("ani", "align_fraction_query", "align_fraction_ref", "ci_lower",
          "ci_upper")

# stats counters of the commands and the engine (stats.driver_report's
# stages, the engine's split and the resident search's accounting)
STAGES = ("sketch_s", "screen_s", "load_s", "executor_s", "write_s",
          "db_build_s", "dispatch_s", "readback_s", "finalize_s",
          "pairs_device", "pairs_host", "pairs_mirrored", "pairs_overflow",
          "device_batches", "pairs_screened", "pairs_slots_refused",
          "search_pages", "page_uploads")


@functools.lru_cache(maxsize=2)
def source_genome(length: int = SOURCE_LEN) -> np.ndarray:
    """The source genome at `length` bases.  The repeats keep their share
    of the genome at every length (1.5 kb each at 5 Mbp, at least 32
    bases), so that a short genome is not all repeat copies."""
    repeat_len = min(1500, max(32, length // 3333))
    return synth.base_genome(np.random.default_rng(SOURCE_SEED), length,
                             copies=list(SOURCE_COPIES),
                             repeat_len=repeat_len)


def search_genomes(out_dir: str, seq: np.ndarray, n: int) -> List[str]:
    """FASTA files of n genomes of len(seq) bases: the first n // 4
    mutants of `seq` at 0.5-4 % (the queries' true neighbourhood), the
    rest uniform random decoys that the marker screen must reject."""
    rng = np.random.default_rng(11)
    n_rel = n // 4
    paths = []
    for i in range(n):
        if i < n_rel:
            s = synth.mutate(rng, seq, 0.005 + 0.035 * i / max(n_rel - 1, 1))
        else:
            s = synth.BASES[rng.integers(0, 4, size=len(seq))]
        paths.append(synth.write_fasta(
            os.path.join(out_dir, f"g{i:05d}.fa"), f"g{i}", [s]))
    return paths


def timed_search(db_dir: str, queries: List[str], out: str, device):
    """engine.search of `queries` against the consolidated database in
    `db_dir` (marker screening, learned ANI, every hit kept): (seconds,
    results, the STAGES deltas with the MB uploaded as upload_mb)."""
    from .. import CommandParams, engine
    from ..kernels import device_db
    from ..params import Mode
    cp = CommandParams(
        mode=Mode.SEARCH, out_file_name=out,
        ref_files=[os.path.join(db_dir, f) for f in os.listdir(db_dir)],
        query_files=queries, refs_are_sketch=True, screen=True,
        max_results=10 ** 7, min_aligned_frac=-1.0,
        both_min_aligned_frac=-0.01, learned_ani=True,
        threads=os.cpu_count() or 1)
    s0 = stats.snapshot()
    up0 = device_db.UPLOAD_BYTES[0]
    t0 = time.time()
    res = engine.search(cp, device=device)
    dt = time.time() - t0
    return dt, res, dict(stages(s0),
                         upload_mb=(device_db.UPLOAD_BYTES[0] - up0) / 1e6)


def same_result(a, b) -> bool:
    """True when two results agree exactly on ANI, both AFs and both CI
    bounds, NaN equal to NaN."""
    for f in FIELDS:
        x, y = float(getattr(a, f)), float(getattr(b, f))
        if x != y and not (np.isnan(x) and np.isnan(y)):
            return False
    return True


def rows_key(res):
    """A search's or a command's rows in a fixed order with all five
    fields, NaN written as a string so that NaN equals NaN."""
    return sorted((r.ref_file, r.query_file)
                  + tuple(repr(float(getattr(r, f))) for f in FIELDS)
                  for r in res)


def drop_resident(db_dir: str) -> None:
    """Forget the resident `search` pages of the database in `db_dir`
    (engine._resident_engines keeps them across calls)."""
    from .. import engine
    real = os.path.realpath(db_dir)
    for k in [k for k in engine._resident_engines if k[0][0] == real]:
        del engine._resident_engines[k]


def card(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    r = subprocess.run(["nvidia-smi", f"--id={dev.index or 0}",
                        "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + r.stderr)
    return r.stdout.strip().splitlines()[0]


def stages(before: Dict[str, float],
           after: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The STAGES counters since `before` (a stats.snapshot())."""
    after = stats.snapshot() if after is None else after
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in STAGES}


@contextlib.contextmanager
def environ(**kv):
    """Environment variables set for the block (None removes one), then
    restored."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
