"""Synthetic genomes for the benchmark, made from a seed.

`base_genome`, `mutate` and `split_contigs` are frozen copies of
skani_tpu_torch/synth.py's, so that no change to the program moves the
yardstick.  The designs below fix every size from the configuration and
the traffic file; a run's seed only orders them and draws the bases, so
that every seed gives the same work.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def base_genome(rng, length: int, n_repeats: int = 0,
                repeat_len: int = 1500, copies=(2, 30)) -> np.ndarray:
    """Random ACGT sequence with repeated segments of `repeat_len` bases:
    `n_repeats` segments each copied to between copies[0] and copies[1]
    random places, or — when `copies` is a list longer than two — one
    segment per entry, copied that many times."""
    s = BASES[rng.integers(0, 4, size=length)]
    counts = (list(copies) if len(copies) > 2 else
              [int(rng.integers(copies[0], copies[1] + 1))
               for _ in range(n_repeats)])
    for n_copies in counts:
        src = int(rng.integers(0, length - repeat_len))
        seg = s[src:src + repeat_len].copy()
        for _ in range(n_copies):
            dst = int(rng.integers(0, length - repeat_len))
            s[dst:dst + repeat_len] = seg
    return s


def mutate(rng, s: np.ndarray, rate: float) -> np.ndarray:
    """A copy of `s` with round(len * rate) random positions redrawn."""
    out = s.copy()
    n = int(len(s) * rate)
    if n:
        pos = rng.choice(len(s), size=n, replace=False)
        out[pos] = BASES[rng.integers(0, 4, size=n)]
    return out


def split_contigs(rng, s: np.ndarray, n: int,
                  min_len: int = 1000) -> List[np.ndarray]:
    """`s` cut into n contigs of at least `min_len` bases."""
    if n <= 1:
        return [s]
    cuts = np.sort(rng.choice(np.arange(min_len, len(s) - min_len),
                              size=n - 1, replace=False))
    parts = np.split(s, cuts)
    return [p for p in parts if len(p) >= min_len] or [s]


def write_fasta(path: str, name: str, parts: Sequence[np.ndarray]) -> str:
    """One record a contig, `>{name}_c{j}`, the sequence on one line."""
    with open(path, "wb") as f:
        for j, s in enumerate(parts):
            f.write(b">%s_c%d\n" % (name.encode(), j))
            f.write(np.asarray(s, np.uint8).tobytes() + b"\n")
    return path


def grid(lo: float, hi: float, n: int) -> np.ndarray:
    """n values spread evenly over [lo, hi] (the midpoints of n equal
    bins): a fixed stand-in for n uniform draws."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def contig_counts(genome: Dict, n: int, rng) -> np.ndarray:
    """Contig counts of n genomes: a share `draft_share` of drafts with
    counts spread over `draft_contigs`, the rest over `complete_contigs`,
    in an order drawn from `rng`."""
    n_draft = int(round(n * genome["draft_share"]))
    d = np.rint(grid(*genome["draft_contigs"], n_draft))
    c = np.rint(grid(*genome["complete_contigs"], n - n_draft))
    return rng.permutation(np.concatenate([d, c]).astype(np.int64))


def species_base(genome: Dict, seed: int, length: int) -> np.ndarray:
    """A species (or genus) base of `length` bases with the configuration's
    repeats: one 1.5 kb segment per entry of `repeat_copies`."""
    rng = np.random.default_rng(seed)
    return base_genome(rng, length, repeat_len=genome["repeat_len"],
                       copies=list(genome["repeat_copies"]))


def derive(seed: int, base: np.ndarray, rate: float, n_contigs: int,
           min_len: int) -> List[np.ndarray]:
    """A genome `rate` from `base`, cut into `n_contigs` contigs."""
    rng = np.random.default_rng(seed)
    return split_contigs(rng, mutate(rng, base, rate), int(n_contigs),
                         min_len)


# --- triangle jobs ---------------------------------------------------------

def derep_design(config: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """The job sets of a `triangle_jobs` cell: `job_sets` sets of
    `species_per_job` x `strains_per_species` genomes.  Species base
    lengths are the grid over the configuration's length range, paired
    shortest with longest so that every set holds the same bases; strains
    take the grid of `strain_rate` and the contig counts of
    contig_counts(), in orders drawn from `seed`."""
    g = config["genome"]
    n_sets, n_sp = traffic["job_sets"], traffic["species_per_job"]
    n_st = traffic["strains_per_species"]
    rng = np.random.default_rng([seed, 1])
    lengths = np.rint(grid(g["length_min"], g["length_max"],
                           n_sets * n_sp)).astype(np.int64)
    # set s takes lengths s, -1-s, ... (shortest with longest): equal sums
    order = np.concatenate([[i, len(lengths) - 1 - i]
                            for i in range(len(lengths) // 2)])
    if len(lengths) % 2:
        order = np.append(order, len(lengths) // 2)
    lengths = lengths[order]
    rates = grid(*traffic["strain_rate"], n_st)
    sets = []
    for s in range(n_sets):
        genomes = []
        for sp in range(n_sp):
            L = int(lengths[s * n_sp + sp])
            base_seed = int(rng.integers(0, 2 ** 62))
            rate = rng.permutation(rates)
            ctg = contig_counts(g, n_st, rng)
            for st in range(n_st):
                genomes.append(dict(
                    name=f"set{s}_sp{sp}_st{st:02d}", species=sp,
                    base_seed=base_seed, length=L, rate=float(rate[st]),
                    n_contigs=int(ctg[st]),
                    seed=int(rng.integers(0, 2 ** 62))))
        perm = rng.permutation(len(genomes))
        sets.append([genomes[i] for i in perm])
    return sets


def make_genomes(config: Dict, design: Sequence[Dict], bases=None
                 ) -> List[List[np.ndarray]]:
    """The contigs of each genome of `design` (bases memoised by seed in
    `bases`)."""
    g = config["genome"]
    bases = {} if bases is None else bases
    out = []
    for d in design:
        key = (d["base_seed"], d["length"])
        if key not in bases:
            bases[key] = species_base(g, d["base_seed"], d["length"])
        out.append(derive(d["seed"], bases[key], d["rate"], d["n_contigs"],
                          g["min_contig"]))
    return out


# --- search database and queries -------------------------------------------

def search_db_design(config: Dict) -> List[Dict]:
    """The references of a `search_c125`-like database: `genera` genus
    bases over the length grid, each with `species_per_genus` species
    `species_rate` from it (so species of a genus are about twice that
    apart), contig counts as contig_counts(); all from the
    configuration's own `db_seed`, never a run's."""
    g, dbc = config["genome"], config["database"]
    rng = np.random.default_rng([dbc["db_seed"], 2])
    n_gen, n_sp = dbc["genera"], dbc["species_per_genus"]
    lengths = rng.permutation(np.rint(grid(
        g["length_min"], g["length_max"], n_gen)).astype(np.int64))
    rates = grid(*dbc["species_rate"], n_sp)
    refs = []
    for ge in range(n_gen):
        base_seed = int(rng.integers(0, 2 ** 62))
        rate = rng.permutation(rates)
        ctg = contig_counts(g, n_sp, rng)
        for sp in range(n_sp):
            refs.append(dict(name=f"g{ge:02d}_s{sp:02d}", genus=ge,
                             species=sp, base_seed=base_seed,
                             length=int(lengths[ge]), rate=float(rate[sp]),
                             n_contigs=int(ctg[sp]),
                             seed=int(rng.integers(0, 2 ** 62))))
    return refs


def species_genome(config: Dict, ref: Dict, genus_bases=None) -> np.ndarray:
    """One reference species' whole sequence (before its contig cut)."""
    g = config["genome"]
    genus_bases = {} if genus_bases is None else genus_bases
    key = (ref["base_seed"], ref["length"])
    if key not in genus_bases:
        genus_bases[key] = species_base(g, ref["base_seed"], ref["length"])
    rng = np.random.default_rng(ref["seed"])
    return mutate(rng, genus_bases[key], ref["rate"])


def reference_contigs(config: Dict, ref: Dict, genus_bases=None
                      ) -> List[np.ndarray]:
    """One reference's contigs, as the database holds them."""
    rng = np.random.default_rng([ref["seed"], 1])
    return split_contigs(rng, species_genome(config, ref, genus_bases),
                         ref["n_contigs"], config["genome"]["min_contig"])


def query_design(config: Dict, traffic: Dict, seed: int, n: int,
                 first: int = 0) -> List[Dict]:
    """Queries `first` .. `first` + n - 1 of a run: query q is a new strain
    of a species of genus perm[q % genera] (every genus as often, so every
    seed sends the same lengths), at a rate from the `strain_rate` grid,
    a draft every other query in the genus's turn."""
    refs = search_db_design(config)
    dbc = config["database"]
    n_gen, n_sp = dbc["genera"], dbc["species_per_genus"]
    rng = np.random.default_rng([seed, 3])
    perm = rng.permutation(n_gen)
    rates = grid(*traffic["strain_rate"], 16)
    g = config["genome"]
    drafts = np.rint(grid(*g["draft_contigs"], 8)).astype(int)
    completes = np.rint(grid(*g["complete_contigs"], 8)).astype(int)
    out = []
    for q in range(first + n):
        ge = int(perm[q % n_gen])
        turn = q // n_gen
        sp = int(rng.integers(0, n_sp))
        rate = float(rates[int(rng.integers(0, len(rates)))])
        n_ctg = int((drafts if turn % 2 == 0 else completes)[
            int(rng.integers(0, 8))])
        qseed = int(rng.integers(0, 2 ** 62))
        if q >= first:
            out.append(dict(name=f"q{q:04d}", ref=refs[ge * n_sp + sp],
                            rate=rate, n_contigs=n_ctg, seed=qseed))
    return out


def query_contigs(config: Dict, q: Dict, genus_bases=None
                  ) -> List[np.ndarray]:
    """A query's contigs: a strain `rate` from its reference species."""
    sp = species_genome(config, q["ref"], genus_bases)
    return derive(q["seed"], sp, q["rate"], q["n_contigs"],
                  config["genome"]["min_contig"])


def fasta_path(dirname: str, name: str) -> str:
    return os.path.join(dirname, f"{name}.fa")
