"""sketch_ms_per_mbp.triangle: The program's sketch_s over the jobs'
megabases, ms a Mbp."""


def read(run):
    mbp = run.total("mbp", "counts")
    return 1e3 * run.total("sketch_s") / mbp if mbp else None
