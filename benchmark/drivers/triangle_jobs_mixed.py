"""`triangle_jobs_mixed`: whole `skani triangle --sparse` jobs over job
sets of many species of uneven sizes, most of them a single genome.

The job loop, the capture, the check and the control are
`triangle_jobs`' own (a private copy of that module, loaded through
harness.driver); this driver supplies only its design and its sample.

Traffic: `species_sizes` ("3x8, 12x4, 24x2, 72x1": three species of 8
genomes, twelve of 4, 24 of 2, 72 singletons), `job_genomes` (their
sum, stated), `job_sets`, `strain_rate`, `warm_jobs`, `cli`, and the
sample each job's check draws: `sample_per_species` genomes of each
species of the largest size, and `sample_singletons` singletons.
"""
from __future__ import annotations

import types

import numpy as np

from benchmark import genomes, harness

_base = harness.driver("triangle_jobs")


def species_sizes(traffic) -> list:
    """The genomes of each species of a job set, largest first."""
    sizes = []
    for part in traffic["species_sizes"].split(","):
        n, size = (int(x) for x in part.strip().split("x"))
        sizes += [size] * n
    sizes.sort(reverse=True)
    if sum(sizes) != traffic["job_genomes"]:
        raise ValueError(f"species_sizes hold {sum(sizes)} genomes, "
                         f"job_genomes says {traffic['job_genomes']}")
    return sizes


def mixed_design(config, traffic, seed: int) -> list:
    """`job_sets` sets of the species of species_sizes().  The species of
    one size take the grid of the configuration's length range over as
    many species, so that every size class (and so the set, weighted by
    genomes a species holds) has the same lengths for every seed; a
    set's genomes take the contig counts of genomes.contig_counts().  The
    seed chooses only the bases, the orders and the strains' rates (a
    species' permutation of the grid of `strain_rate` over its size)."""
    g = config["genome"]
    sizes = species_sizes(traffic)
    rng = np.random.default_rng([seed, 1])
    sets = []
    for s in range(traffic["job_sets"]):
        lengths = {}
        for size in sorted(set(sizes)):
            n = sizes.count(size)
            lengths[size] = list(rng.permutation(np.rint(genomes.grid(
                g["length_min"], g["length_max"], n)).astype(np.int64)))
        ctg = genomes.contig_counts(g, sum(sizes), rng)
        out = []
        for sp, size in enumerate(sizes):
            L = int(lengths[size].pop())
            base_seed = int(rng.integers(0, 2 ** 62))
            rate = rng.permutation(genomes.grid(*traffic["strain_rate"],
                                                size))
            for st in range(size):
                out.append(dict(
                    name=f"set{s}_sp{sp:02d}_st{st}", species=sp,
                    base_seed=base_seed, length=L, rate=float(rate[st]),
                    n_contigs=int(ctg[len(out)]),
                    seed=int(rng.integers(0, 2 ** 62))))
        perm = rng.permutation(len(out))
        sets.append([out[i] for i in perm])
    return sets


def job_sample(ctx, s: int, job: int) -> list:
    """The genomes of set `s` that the reference checks in window job
    `job`: `sample_per_species` of each species of the largest size and
    `sample_singletons` singletons, drawn from the seed and the job's
    index."""
    rng = np.random.default_rng([ctx.seed, 7, job])
    design = ctx.design[s]
    by_species = {}
    for i, dd in enumerate(design):
        by_species.setdefault(dd["species"], []).append(i)
    largest = max(len(v) for v in by_species.values())
    pick = []
    for sp in sorted(by_species):
        if len(by_species[sp]) == largest:
            pick += rng.choice(by_species[sp],
                               size=ctx.traffic["sample_per_species"],
                               replace=False).tolist()
    singles = [v[0] for _sp, v in sorted(by_species.items())
               if len(v) == 1]
    pick += rng.choice(singles, size=ctx.traffic["sample_singletons"],
                       replace=False).tolist()
    return sorted(pick)


# the private copy of triangle_jobs draws this driver's design (through
# its own view of benchmark.genomes) and sample
_base.genomes = types.SimpleNamespace(**{**vars(genomes),
                                         "derep_design": mixed_design})
_base.job_sample = job_sample

prepare = _base.prepare
setup = _base.setup
install_spans = _base.install_spans
run_job = _base.run_job
window = _base.window
check = _base.check
control = _base.control
