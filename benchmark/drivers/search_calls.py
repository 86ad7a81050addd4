"""`search_calls`: one client placing new genomes one at a time against a
prebuilt consolidated database, in a closed loop.

Each call is `engine.search(cp)` with no executor (the resident-page
path a user's call takes), its parameters parsed from `skani search -d
<db> <query.fa> -o <out>` as one CLI invocation builds them.  The
database is made once per checkout by the program's own sketch path
(synth.sketch_parts, db.SketchDbWriter) from sequences held in memory,
and kept under the benchmark's cache directory, keyed by the content of
the configuration and of the generator.  Queries are written to the run's
temporary directory at set-up; none repeats within a run.  Nothing
passes from one call to the next but what the program keeps by itself
(its resident pages).

What a call produces is captured as it is produced (the query's sketch,
the references its screen passes, its results, its TSV) and held, after
the window, to the reference on calls drawn from the seed, each of
another genus.  Every call's screen passes and TSV rows are also held to
what the design fixes outside the query's genus: references of another
genus (unrelated random bases) never pass and are never written.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import genomes, harness
from benchmark.reference import pipeline as refp
from benchmark.reference import sketch as refsk

#: queries made at set-up: this many times the window's length over the
#: last warm call's wall time (and 10 more), so that the pool outlasts
#: the window at any speed of the program
POOL_MARGIN = 2.0


def db_dir(ctx) -> str:
    """The database's directory under the cache, keyed by content."""
    h = hashlib.sha256()
    for p in (os.path.join(harness.HERE, "configs",
                           ctx.workload["config"] + ".json"),
              os.path.join(harness.HERE, "genomes.py")):
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(ctx.cache_dir,
                        f"{ctx.workload['config']}-{h.hexdigest()[:16]}")


def ensure_db(ctx) -> str:
    """Build the database once: every reference generated, sketched by
    the program and written to a consolidated database."""
    from skani_tpu_torch import SketchParams, db, synth
    final = db_dir(ctx)
    if os.path.exists(os.path.join(final, "markers.bin")):
        return final
    cfg = ctx.config
    pre = cfg["preset"]
    sp = SketchParams(c=pre["c"], k=pre["k"], marker_c=pre["marker_c"])
    part = final + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    os.makedirs(part)
    writer = db.SketchDbWriter(part)
    markers = []
    refs = genomes.search_db_design(cfg)
    by_genus = {}
    for r in refs:
        by_genus.setdefault(r["genus"], []).append(r)

    def one(args):
        r, bases = args
        parts = genomes.reference_contigs(cfg, r, bases)
        return synth.sketch_parts(parts, sp, r["name"])

    with ThreadPoolExecutor(max_workers=min(8, harness.cores())) as ex:
        for ge in sorted(by_genus):
            bases = {}
            r0 = by_genus[ge][0]
            bases[(r0["base_seed"], r0["length"])] = genomes.species_base(
                cfg["genome"], r0["base_seed"], r0["length"])
            for sk in ex.map(one, [(r, bases) for r in by_genus[ge]]):
                writer.add_sketch(sp, sk)
                markers.append(sk.get_markers_only())
    writer.finalize()
    db.write_markers_bin(os.path.join(part, "markers.bin"), sp, markers)
    os.rename(part, final)
    return final


def prepare(ctx) -> None:
    """The inputs: the database (once a checkout), the run's query
    design, and the warm-up queries' FASTA files."""
    t0 = time.perf_counter()
    ctx.db = ensure_db(ctx)
    ctx.timings["db_s"] = time.perf_counter() - t0
    tr = ctx.traffic
    ctx.queries = []
    design_queries(ctx, tr["warm_calls"])
    ctx.query_files = {}
    ctx.next_query = tr["warm_calls"]
    write_queries(ctx, range(ctx.next_query))


def design_queries(ctx, n: int) -> None:
    """The designs of the run's first `n` queries (the design of a query
    does not depend on how many follow it)."""
    if len(ctx.queries) < n:
        ctx.queries = genomes.query_design(ctx.config, ctx.traffic,
                                           ctx.seed, n)


def write_queries(ctx, indices) -> None:
    """The FASTA files of queries `indices` in the run's directory."""
    qdir = os.path.join(ctx.workdir, "queries")
    os.makedirs(qdir, exist_ok=True)

    def one(qi):
        q = ctx.queries[qi]
        parts = genomes.query_contigs(ctx.config, q)
        return qi, genomes.write_fasta(genomes.fasta_path(qdir, q["name"]),
                                       q["name"], parts)

    todo = [qi for qi in indices if qi not in ctx.query_files]
    with ThreadPoolExecutor(max_workers=min(8, harness.cores())) as ex:
        ctx.query_files.update(ex.map(one, todo))


def setup(ctx) -> None:
    """The inputs, the capture hooks, then `warm_calls` calls (the first
    loads the database's resident page); then the window's queries, as
    many as POOL_MARGIN asks (written at set-up, never inside the
    window)."""
    from skani_tpu_torch import engine
    prepare(ctx)
    cap = ctx.capture = {"sketch": None, "screened": None}

    def keep_sketches(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            cap["sketch"] = out[0] if len(out) == 1 else out
            return out
        return wrapped

    def keep_screen(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            cap["screened"] = list(out)
            return out
        return wrapped

    ctx.hooks.wrap(engine, "fastx_to_sketches", keep_sketches)
    ctx.hooks.wrap(engine, "_screen_query", keep_screen)
    ctx.calls_run = 0
    wall = None
    for i in range(ctx.next_query):
        t0 = time.perf_counter()
        call(ctx, i)
        wall = time.perf_counter() - t0
        ctx.timings[f"warm{i}_s"] = wall
    n = int(POOL_MARGIN * ctx.seconds / wall) + 10
    t0 = time.perf_counter()
    design_queries(ctx, ctx.next_query + n)
    write_queries(ctx, range(ctx.next_query, ctx.next_query + n))
    ctx.timings["pool_s"] = time.perf_counter() - t0
    ctx.timings["pool"] = n


def install_spans(ctx) -> None:
    """The traced run's spans around each layer's entry point."""
    from skani_tpu_torch import db, engine, writers
    from skani_tpu_torch.kernels import device_db, device_pipeline
    sp = ctx.spans
    for owner, attr, name in (
            (engine, "fastx_to_sketches", "sketch"),
            (engine, "_screen_query", "screen"),
            (db, "read_markers_bin", "load"),
            (db.SketchDbReader, "__init__", "load"),
            (engine, "_load_parallel", "load"),
            (device_db.DeviceDb, "__init__", "db_build"),
            (device_db.DeviceDb, "update_rows", "update_rows"),
            (device_pipeline.DevicePairEngine, "run_pairs", "run_pairs"),
            (writers, "write_query_ref_list", "write")):
        ctx.hooks.wrap(owner, attr, lambda fn, n=name: sp.span(n, fn))


def call(ctx, qi: int):
    """One `skani search` call of query `qi`; returns (results, TSV)."""
    from skani_tpu_torch import cli, engine
    out = os.path.join(ctx.workdir, f"call{ctx.calls_run}.tsv")
    ctx.calls_run += 1
    argv = (["search", "-d", ctx.db, ctx.query_files[qi]]
            + ctx.traffic["cli"] + ["-o", out, "-t", str(harness.cores())])
    args = cli.build_parser().parse_args(argv)
    _sp, cp = cli.parse_args_to_params(args)
    cp.threads = max(int(args.threads), 1)
    return engine.search(cp), out


def window(ctx, seconds: float):
    """Calls back to back until `seconds` have passed at a call's end.
    Returns (units, window seconds, per-call captures)."""
    from skani_tpu_torch import stats
    import torch
    units, caps = [], []
    t0 = time.perf_counter()
    while True:
        qi = ctx.next_query
        if qi not in ctx.query_files:
            raise RuntimeError(f"the window outran the {qi - 1} queries "
                               f"made at set-up")
        ctx.next_query += 1
        before = stats.snapshot()
        t1 = time.perf_counter()
        try:
            anis, out = call(ctx, qi)
            torch.cuda.synchronize() if ctx.device == "cuda" else None
            ok, err = True, ""
        except Exception as e:          # a failed call counts, and goes on
            anis, out, ok, err = None, None, False, f"{type(e).__name__}: {e}"
        t2 = time.perf_counter()
        spans = ctx.spans.take() if ctx.spans else {}
        units.append(harness.Unit(
            wall=t2 - t1, ok=ok, work=1.0,
            stats=harness.stats_delta(stats.snapshot(), before),
            spans=spans, counts={}, error=err))
        caps.append(dict(query=qi, anis=anis, out=out,
                         sketch=ctx.capture["sketch"],
                         screened=ctx.capture["screened"]))
        ctx.capture["sketch"] = ctx.capture["screened"] = None
        if t2 - t0 >= seconds:
            break
    return units, time.perf_counter() - t0, caps


# --- correctness -----------------------------------------------------------

def _tsv_rows(path: str) -> dict:
    rows = {}
    with open(path) as f:
        next(f, None)
        for line in f:
            line = line.rstrip("\n")
            p = line.split("\t")
            rows[(p[0], p[1])] = line
    return rows


def checked_refs(ctx, qi: int) -> list:
    """The references a checked call is held to: every species of the
    query's genus and `other_refs` others drawn from the seed."""
    cfg = ctx.config
    refs = genomes.search_db_design(cfg)
    q = ctx.queries[qi]
    genus = [i for i, r in enumerate(refs) if r["genus"] == q["ref"]["genus"]]
    rest = [i for i, r in enumerate(refs) if r["genus"] != q["ref"]["genus"]]
    rng = np.random.default_rng([ctx.seed, 11, qi])
    return genus + sorted(rng.choice(rest, size=ctx.traffic["other_refs"],
                                     replace=False).tolist())


def reference_answers(ctx, qi: int, device, ftype=np.float64,
                      ref_sketches=None) -> dict:
    """The reference's answers for query `qi`: its sketch, the screen's
    verdict against each checked reference, results of those it passes
    (those the program keeps: ANI above 0.5) and TSV rows.  Reference
    sketches are made once and kept in `ref_sketches`."""
    cfg = ctx.config
    pre = cfg["preset"]
    refs = genomes.search_db_design(cfg)
    q = ctx.queries[qi]
    ref_sketches = {} if ref_sketches is None else ref_sketches
    bases = {}
    parts = genomes.query_contigs(cfg, q, bases)
    qsk = refsk.sketch_contigs(
        ctx.query_files[qi], [f"{q['name']}_c{j}" for j in range(len(parts))],
        parts, pre["k"], pre["c"], pre["marker_c"], device)
    cp = refp.command_params(min_aligned_frac=-1.0,
                             learned_ani=pre["learned_ani"])
    screen, results, rows = {}, {}, {}
    for j in checked_refs(ctx, qi):
        r = refs[j]
        if j not in ref_sketches:
            rp = genomes.reference_contigs(cfg, r, bases)
            ref_sketches[j] = refsk.sketch_contigs(
                r["name"], [f"{r['name']}_c{c}" for c in range(len(rp))],
                rp, pre["k"], pre["c"], pre["marker_c"], device)
        rsk = ref_sketches[j]
        ok = refp.search_screen(qsk, rsk, pre["screen"])
        screen[j] = ok
        res = refp.score(rsk, qsk, cp, ftype) if ok else None
        results[j] = res if res is not None and res.ani > 0.5 else None
        rows[j] = (refp.tsv_row(res) if results[j] is not None
                   and refp.written(res) else None)
    return dict(sketch=qsk, screen=screen, results=results, rows=rows)


def program_answers(ctx, cap, checked) -> dict:
    refs = genomes.search_db_design(ctx.config)
    qfile = ctx.query_files[cap["query"]]
    by_ref = {r.ref_file: r for r in cap["anis"]}
    tsv = _tsv_rows(cap["out"])
    passed = set(cap["screened"] or [])
    return dict(
        sketch=cap["sketch"],
        screen={j: j in passed for j in checked},
        results={j: by_ref.get(refs[j]["name"]) for j in checked},
        rows={j: tsv.get((refs[j]["name"], qfile)) for j in checked})


def compare(prog: dict, ref: dict) -> dict:
    seeds = int(prog["sketch"] is None
                or not refsk.same_sketch(prog["sketch"], ref["sketch"]))
    screen = sum(1 for j, v in ref["screen"].items()
                 if prog["screen"].get(j) != v)
    pairs = 0
    for j, r in ref["results"].items():
        p = prog["results"].get(j)
        if (p is None) != (r is None) or (
                r is not None and not refp.same_result(p, r)):
            pairs += 1
    rows = sum(1 for j, v in ref["rows"].items()
               if prog["rows"].get(j) != v)
    return dict(seeds_off=seeds, screen_off=screen, pairs_off=pairs,
                rows_off=rows, screened=len(ref["screen"]),
                scored=sum(r is not None for r in ref["results"].values()))


def checked_calls(ctx, units, caps) -> list:
    """`calls_checked` completed calls drawn from the seed, each of
    another genus where the window holds that many genera."""
    ok = [i for i, u in enumerate(units) if u.ok]
    rng = np.random.default_rng([ctx.seed, 13])
    order = rng.permutation(ok).tolist()
    first, seen = [], set()
    for i in order:
        ge = ctx.queries[caps[i]["query"]]["ref"]["genus"]
        if ge not in seen:
            first.append(i)
            seen.add(ge)
    rest = [i for i in order if i not in first]
    return sorted((first + rest)[:ctx.traffic["calls_checked"]])


def stray(ctx, cap) -> int:
    """A call's screen passes and TSV rows of references outside its
    query's genus."""
    refs = genomes.search_db_design(ctx.config)
    ge = ctx.queries[cap["query"]]["ref"]["genus"]
    by_name = {r["name"]: r["genus"] for r in refs}
    passes = sum(1 for j in cap["screened"] or [] if refs[j]["genus"] != ge)
    rows = sum(1 for ref_file, _q in _tsv_rows(cap["out"])
               if by_name.get(ref_file) != ge)
    return passes + rows


def check(ctx, units, caps, device) -> dict:
    total = dict(seeds_off=0, screen_off=0, pairs_off=0, rows_off=0,
                 stray_off=0, screened=0, scored=0)
    ref_sketches = {}
    calls = checked_calls(ctx, units, caps)
    for i in calls:
        cap = caps[i]
        qi = cap["query"]
        ref = reference_answers(ctx, qi, device, ref_sketches=ref_sketches)
        prog = program_answers(ctx, cap, list(ref["screen"]))
        for k, v in compare(prog, ref).items():
            total[k] += v
    total["stray_off"] = sum(stray(ctx, caps[i])
                             for i, u in enumerate(units) if u.ok)
    total["calls_checked"] = len(calls)
    total["genera_checked"] = len({ctx.queries[caps[i]["query"]]["ref"][
        "genus"] for i in calls})
    return total


def control(ctx, device, ftype, n_calls=None) -> dict:
    """The control's readings: the reference in `ftype` in the program's
    place, against the reference, on the window's first queries."""
    total = dict(seeds_off=0, screen_off=0, pairs_off=0, rows_off=0,
                 stray_off=0, screened=0, scored=0)
    ref_sketches = {}
    n = n_calls or ctx.traffic["calls_checked"]
    design_queries(ctx, ctx.next_query + n)
    write_queries(ctx, range(ctx.next_query, ctx.next_query + n))
    for qi in range(ctx.next_query, ctx.next_query + n):
        ref = reference_answers(ctx, qi, device, ref_sketches=ref_sketches)
        low = reference_answers(ctx, qi, device, ftype, ref_sketches)
        for k, v in compare(low, ref).items():
            total[k] += v
    return total
