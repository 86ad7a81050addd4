"""`triangle_jobs`: whole `skani triangle --sparse` jobs, back to back.

Each job is `engine.triangle(cp, sp)` with no executor, its parameters
parsed from the command line the traffic file gives, as one CLI
invocation builds them: it sketches its FASTA files, screens every pair
by markers, builds its engine and DeviceDb, scores the screened pairs and
writes its TSV.  Nothing passes from one job to the next but what the
program keeps by itself.  Jobs alternate between the cell's job sets,
written to the run's temporary directory at set-up.

What a job produces is captured as it is produced (the sketches
engine.triangle makes, the screen's verdict of every row, the results it
hands to the writer, the TSV) and held, after the window, to the
reference on a sample of genomes drawn anew for each job from the seed
and the job's index.  Every job's screen passes and TSV rows are also
held to what the design fixes for the pairs outside the sample: genomes
of two species (unrelated random bases) never pass and are never
written.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from benchmark import genomes, harness
from benchmark.reference import pipeline as refp
from benchmark.reference import sketch as refsk


class Capture:
    """What the program produced in the job under way."""

    def __init__(self):
        self.sketches = None
        self.screen = {}
        self.written = {}

    def take(self):
        out = (self.sketches, self.screen, self.written)
        self.sketches, self.screen, self.written = None, {}, {}
        return out


def prepare(ctx) -> None:
    """The inputs: the job sets' FASTA files."""
    cfg, tr = ctx.config, ctx.traffic
    ctx.design = genomes.derep_design(cfg, tr, ctx.seed)
    ctx.files = []
    for s, design in enumerate(ctx.design):
        d = os.path.join(ctx.workdir, f"set{s}")
        os.makedirs(d, exist_ok=True)
        bases = {}
        with ThreadPoolExecutor(max_workers=min(8, harness.cores())) as ex:
            def one(dd):
                parts = genomes.make_genomes(cfg, [dd], bases)[0]
                return genomes.write_fasta(
                    genomes.fasta_path(d, dd["name"]), dd["name"], parts)
            for dd in design:
                key = (dd["base_seed"], dd["length"])
                if key not in bases:
                    bases[key] = genomes.species_base(
                        cfg["genome"], dd["base_seed"], dd["length"])
            ctx.files.append(list(ex.map(one, design)))
    ctx.species = {ctx.files[s][g]: (s, dd["species"])
                   for s, design in enumerate(ctx.design)
                   for g, dd in enumerate(design)}


def job_sample(ctx, s: int, job: int) -> list:
    """The genomes of set `s` that the reference checks in window job
    `job`: `sample_per_species` of each species, drawn from the seed and
    the job's index."""
    rng = np.random.default_rng([ctx.seed, 7, job])
    pick = []
    for sp in range(ctx.traffic["species_per_job"]):
        idx = [i for i, dd in enumerate(ctx.design[s])
               if dd["species"] == sp]
        pick += rng.choice(idx, size=ctx.traffic["sample_per_species"],
                           replace=False).tolist()
    return sorted(pick)


def setup(ctx) -> None:
    """The inputs, the capture hooks, then `warm_jobs` whole jobs."""
    from skani_tpu_torch import engine, screen, writers
    t0 = time.perf_counter()
    prepare(ctx)
    ctx.timings["inputs_s"] = time.perf_counter() - t0
    cap = ctx.capture = Capture()

    def keep_sketches(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            cap.sketches = out
            return out
        return wrapped

    def keep_screen(fn):
        def wrapped(identity, index, query, *a, **kw):
            out = fn(identity, index, query, *a, **kw)
            cap.screen[id(query)] = out
            return out
        return wrapped

    def keep_written(fn):
        def wrapped(anis, *a, **kw):
            for i, row in anis.items():
                for j, r in row.items():
                    cap.written[(i, j)] = r
            return fn(anis, *a, **kw)
        return wrapped

    ctx.hooks.wrap(engine, "fastx_to_sketches", keep_sketches)
    ctx.hooks.wrap(screen, "screen_refs", keep_screen)
    ctx.hooks.wrap(writers, "write_sparse_matrix", keep_written)
    ctx.jobs_run = 0
    for k in range(ctx.traffic["warm_jobs"]):
        t0 = time.perf_counter()
        run_job(ctx, k % len(ctx.files))
        ctx.timings[f"warm{k}_s"] = time.perf_counter() - t0
        cap.take()


def install_spans(ctx) -> None:
    """The traced run's spans around each layer's entry point."""
    from skani_tpu_torch import engine, screen, writers
    from skani_tpu_torch.kernels import device_db, device_pipeline
    sp = ctx.spans
    for owner, attr, name in (
            (engine, "fastx_to_sketches", "sketch"),
            (screen, "screen_refs", "screen"),
            (device_db.DeviceDb, "__init__", "db_build"),
            (device_pipeline.DevicePairEngine, "run_pairs", "run_pairs"),
            (writers, "write_sparse_matrix", "write")):
        ctx.hooks.wrap(owner, attr, lambda fn, n=name: sp.span(n, fn))


def run_job(ctx, s: int) -> str:
    """One whole job on job set `s`; returns its TSV's path."""
    from skani_tpu_torch import cli, engine
    out = os.path.join(ctx.workdir, f"job{ctx.jobs_run}.tsv")
    ctx.jobs_run += 1
    argv = (["triangle"] + ctx.files[s] + ctx.traffic["cli"]
            + ["-o", out, "-t", str(harness.cores())])
    args = cli.build_parser().parse_args(argv)
    sp, cp = cli.parse_args_to_params(args)
    cp.threads = max(int(args.threads), 1)
    engine.triangle(cp, sp)
    return out


def window(ctx, seconds: float):
    """Jobs back to back until `seconds` have passed at a job's end.
    Returns (units, window seconds, per-job captures)."""
    from skani_tpu_torch import stats
    import torch
    units, caps = [], []
    n_sets = len(ctx.files)
    t0 = time.perf_counter()
    k = 0
    while True:
        s = k % n_sets
        n = len(ctx.files[s])
        before = stats.snapshot()
        t1 = time.perf_counter()
        try:
            out = run_job(ctx, s)
            torch.cuda.synchronize() if ctx.device == "cuda" else None
            ok, err = True, ""
        except Exception as e:          # a failed job counts, and goes on
            out, ok, err = None, False, f"{type(e).__name__}: {e}"
        t2 = time.perf_counter()
        spans = ctx.spans.take() if ctx.spans else {}
        units.append(harness.Unit(
            wall=t2 - t1, ok=ok, work=n * (n - 1) / 2,
            stats=harness.stats_delta(stats.snapshot(), before),
            spans=spans, counts={}, error=err))
        caps.append(_keep(ctx, s, k, out, *ctx.capture.take()))
        units[-1].counts.update(caps[-1].pop("counts"))
        k += 1
        if t2 - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    return units, window_s, caps


def _keep(ctx, s: int, job: int, out, sks, scr, written) -> dict:
    """What the check needs of one job's capture (the sampled genomes'
    sketches, screen verdicts and results, the passes across species)
    and the job's counts; the rest is let go at once, so that memory
    stays flat over the window."""
    sample = job_sample(ctx, s, job)
    if sks is None:
        return dict(set=s, sample=sample, out=out, sketches={}, passes={},
                    results={}, stray_passes=0, counts={})
    names = [sk.file_name for sk in sks]
    want = {ctx.files[s][g] for g in sample}
    idx = {i for i, n in enumerate(names) if n in want}
    rows = [np.asarray(scr.get(id(sk), [])) for sk in sks]
    species = [ctx.species.get(n) for n in names]
    stray = sum(1 for i, r in enumerate(rows) for j in r.tolist()
                if j > i and species[j] != species[i])
    return dict(
        set=s, sample=sample, out=out, stray_passes=stray,
        sketches={names[i]: sks[i] for i in idx},
        passes={names[i]: {names[j] for j in rows[i].tolist()}
                for i in idx},
        results={(names[i], names[j]): r for (i, j), r in written.items()
                 if i in idx and j in idx},
        counts=dict(genomes=len(sks),
                    mbp=sum(sk.total_sequence_length for sk in sks) / 1e6,
                    pairs_screened=sum(int((r > i).sum())
                                       for i, r in enumerate(rows))))


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


class RefCache:
    """The reference's sketches and pair answers, each worked out once a
    run: (set, genome) -> sketch, (set, path, path) -> (verdict, result,
    row)."""

    def __init__(self):
        self.sketches, self.pairs, self.bases = {}, {}, {}


def reference_answers(ctx, s: int, sample, device, ftype=np.float64,
                      cache: RefCache = None) -> dict:
    """The reference's answers on `sample` of set `s`: sketches, the
    screen's verdict of every sampled pair, results of those it passes
    (those the program keeps: ANI above 0.1), and TSV rows."""
    cfg = ctx.config
    pre = cfg["preset"]
    design = ctx.design[s]
    paths = ctx.files[s]
    cache = cache or RefCache()
    sks = {}
    for g in sample:
        if (s, g) not in cache.sketches:
            dd = design[g]
            parts = genomes.make_genomes(cfg, [dd], cache.bases)[0]
            cache.sketches[(s, g)] = refsk.sketch_contigs(
                paths[g], [f"{dd['name']}_c{j}" for j in range(len(parts))],
                parts, pre["k"], pre["c"], pre["marker_c"], device)
        sks[g] = cache.sketches[(s, g)]
    order = sorted(sample, key=lambda g: paths[g])
    cp = refp.command_params(learned_ani=pre["learned_ani"])
    screen, results, rows = {}, {}, {}
    for a, gi in enumerate(order):
        for gj in order[a + 1:]:
            key = (paths[gi], paths[gj])
            if (s,) + key not in cache.pairs:
                ok = refp.triangle_screen(sks[gi], sks[gj], pre["screen"],
                                          cfg["rescue_small"])
                r = refp.score(sks[gi], sks[gj], cp, ftype) if ok else None
                r = r if r is not None and r.ani > 0.1 else None
                cache.pairs[(s,) + key] = (
                    ok, r, refp.tsv_row(r) if r is not None
                    and refp.written(r) else None)
            screen[key], results[key], rows[key] = cache.pairs[(s,) + key]
    return dict(sketches={paths[g]: sks[g] for g in sks}, screen=screen,
                results=results, rows=rows)


def program_answers(ctx, cap, tsv) -> dict:
    """The same answers from one job's kept capture and its TSV."""
    want = sorted(ctx.files[cap["set"]][g] for g in cap["sample"])
    screen, results, rows = {}, {}, {}
    for a, fi in enumerate(want):
        for fj in want[a + 1:]:
            key = (fi, fj)
            screen[key] = fj in cap["passes"].get(fi, ())
            results[key] = cap["results"].get(key)
            rows[key] = tsv.get(key)
    return dict(sketches={f: cap["sketches"].get(f) for f in want},
                screen=screen, results=results, rows=rows)


def compare(prog: dict, ref: dict) -> dict:
    """Counts of disagreements between two answer sets."""
    seeds = sum(1 for f, sk in ref["sketches"].items()
                if prog["sketches"].get(f) is None
                or not refsk.same_sketch(prog["sketches"][f], sk))
    screen = sum(1 for k, v in ref["screen"].items()
                 if prog["screen"].get(k) != v)
    pairs = 0
    for k, r in ref["results"].items():
        p = prog["results"].get(k)
        if (p is None) != (r is None) or (
                r is not None and not refp.same_result(p, r)):
            pairs += 1
    rows = sum(1 for k, v in ref["rows"].items()
               if prog["rows"].get(k) != v)
    return dict(seeds_off=seeds, screen_off=screen, pairs_off=pairs,
                rows_off=rows, screened=len(ref["screen"]),
                scored=sum(r is not None for r in ref["results"].values()))


def stray_rows(ctx, tsv: dict) -> int:
    """TSV rows of two genomes of different species."""
    return sum(1 for a, b in tsv
               if ctx.species.get(a) is None
               or ctx.species.get(a) != ctx.species.get(b))


def check(ctx, units, caps, device) -> dict:
    """Every completed job's answers on its own sample against the
    reference's, and its passes and rows across species (none)."""
    cache = RefCache()
    total = dict(seeds_off=0, screen_off=0, pairs_off=0, rows_off=0,
                 stray_off=0, screened=0, scored=0)
    for u, cap in zip(units, caps):
        if not u.ok:
            continue
        tsv = _tsv_rows(cap["out"])
        ref = reference_answers(ctx, cap["set"], cap["sample"], device,
                                cache=cache)
        for k, v in compare(program_answers(ctx, cap, tsv), ref).items():
            total[k] += v
        total["stray_off"] += cap["stray_passes"] + stray_rows(ctx, tsv)
    total["jobs_checked"] = sum(1 for u in units if u.ok)
    total["genomes_checked"] = len(cache.sketches)
    return total


def control(ctx, device, ftype, n_jobs: int = 16) -> dict:
    """The control's readings: the reference in `ftype` in the program's
    place, against the reference, on the samples of the window's first
    `n_jobs` jobs (as many as a run's window holds)."""
    total = dict(seeds_off=0, screen_off=0, pairs_off=0, rows_off=0,
                 stray_off=0, screened=0, scored=0)
    ref_cache, low_cache = RefCache(), RefCache()
    low_cache.sketches = ref_cache.sketches
    for job in range(n_jobs):
        s = job % len(ctx.files)
        sample = job_sample(ctx, s, job)
        ref = reference_answers(ctx, s, sample, device, cache=ref_cache)
        low = reference_answers(ctx, s, sample, device, ftype, low_cache)
        for k, v in compare(low, ref).items():
            total[k] += v
    return total
