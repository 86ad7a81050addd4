"""Scale demo: consolidated sketch-DB construction + memory-light search.

Synthesizes a database of N genomes (default 256; BENCH_DB_GENOMES to
change): one quarter derivatives of the synthetic source genome
(tools/common.py source_genome) at 0.5-4 % divergence (the query's true
neighborhood), the rest random decoy genomes that marker screening must
reject.  Then:

  1. builds the consolidated database (sketches.db / index.db /
     markers.bin, skani's v0.3 format) and reports construction rate;
  2. searches 3 queries against it on the device, cold (pages uploaded)
     then warm (resident), reporting per-query latency, hits, the bytes
     uploaded (kernels/device_db.py UPLOAD_BYTES), pages and page uploads
     (only screened-in sketches are lazily loaded from the mmapped
     database, reference: src/search.rs:146-166);
  3. runs the same search on the native executor: the three searches'
     rows must agree on all five fields (exit 1 otherwise).

    python -m skani_tpu_torch.tools.search_scale_demo [out_dir]
        [--device cuda|cpu]

Env: BENCH_DB_GENOMES, BENCH_DB_GENOME_LEN (0, the default: the whole 5
Mbp source; cap it, e.g. 150000, for 10k+ genome databases), and
SKANI_SCALE_PHASE = all (default) | build (synth + DB only, needs no
card) | search (reuse an existing out_dir DB).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from .. import CommandParams, SketchParams, engine
from ..kernels.device_pipeline import resolve_device
from ..params import Mode
from .common import (card, drop_resident, environ, peak_rss_mb, rows_key,
                     search_genomes, source_genome, timed_search)


def synth_genomes(out_dir: str, n: int, glen: int):
    seq = source_genome()
    return search_genomes(out_dir, seq[:glen] if glen else seq, n)


def run(work: str, n: int, glen: int = 0, device=None, phase: str = "all",
        log=print) -> dict:
    """The demo in `work` on `device` (default CUDA; the `build` phase
    needs none): its numbers, "mismatches" among them."""
    dev = resolve_device(device) if phase != "build" else None
    gdir = os.path.join(work, "genomes")
    dbdir = os.path.join(work, "db")
    os.makedirs(gdir, exist_ok=True)
    out = {"db_genomes": n, "genome_len": glen or len(source_genome()),
           "mismatches": 0}

    if phase in ("all", "build"):
        if os.path.exists(dbdir):
            shutil.rmtree(dbdir)
        t0 = time.time()
        paths = synth_genomes(gdir, n, glen)
        log(f"synthesized {n} genomes in {time.time() - t0:.1f}s")

        sp = SketchParams()
        cp = CommandParams(mode=Mode.SKETCH, out_file_name=dbdir,
                           ref_files=paths, threads=os.cpu_count() or 1)
        t0 = time.time()
        engine.sketch(cp, sp)
        dt = time.time() - t0
        db_bytes = sum(os.path.getsize(os.path.join(dbdir, f))
                       for f in os.listdir(dbdir))
        log(f"DB construction: {n} genomes in {dt:.1f}s "
            f"({n / dt:.1f} genomes/s), {db_bytes / 1e6:.1f} MB on disk")
        out.update(build_s=dt, genomes_per_s=n / dt, db_mb=db_bytes / 1e6)
        if phase == "build":
            log(f"workdir: {work}")
            return out
    else:
        paths = sorted(os.path.join(gdir, f) for f in os.listdir(gdir))
        if len(paths) != n:
            raise ValueError(f"{gdir} holds {len(paths)} genomes, not {n}")

    queries = paths[:2] + paths[-1:]

    def run_search(tag):
        dt, res, st = timed_search(
            dbdir, queries, os.path.join(work, f"search_{tag}.tsv"), dev)
        log(f"search[{tag}]: {len(queries)} queries vs {n}-genome DB in "
            f"{dt:.1f}s ({dt / len(queries):.2f} s/query), {len(res)} "
            f"hits, {st['upload_mb']:.1f} MB uploaded, "
            f"{int(st['search_pages'])} page(s), "
            f"{int(st['page_uploads'])} page upload(s)")
        out[tag] = dict(s_per_query=dt / len(queries), hits=len(res),
                        upload_mb=st.pop("upload_mb"), stages=st)
        return rows_key(res)

    # the first run pays residency (the upload) and the first launches;
    # the repeat shows the steady per-query cost the resident design buys
    try:
        cold = run_search("cold")
        warm = run_search("warm")
    finally:
        drop_resident(dbdir)
    with environ(SKANI_TPU_EXECUTOR="native"):
        native = run_search("native")
    out["mismatches"] = int(cold != warm) + int(warm != native)
    out["peak_rss_mb"] = peak_rss_mb()
    out["device"] = card(dev)
    log(f"exactness: cold / warm / native rows "
        f"{'agree' if not out['mismatches'] else 'DIFFER'}")
    log(f"peak RSS: {out['peak_rss_mb']:.0f} MB")
    log(f"workdir: {work}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    work = a.out_dir or tempfile.mkdtemp(prefix="skani_scale_")
    out = run(work, int(os.environ.get("BENCH_DB_GENOMES", "256")),
              int(os.environ.get("BENCH_DB_GENOME_LEN", "0")), a.device,
              os.environ.get("SKANI_SCALE_PHASE", "all"))
    print(json.dumps(out), flush=True)
    return 1 if out["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
