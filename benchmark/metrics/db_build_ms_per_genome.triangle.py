"""db_build_ms_per_genome.triangle: The program's db_build_s over the
genomes its engines held, ms a genome."""


def read(run):
    g = run.total("genomes", "counts")
    return 1e3 * run.total("db_build_s") / g if g else None
