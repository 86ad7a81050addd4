"""screen_ms_per_job.triangle: The program's screen_s a completed job, ms."""


def read(run):
    n = len(run.ok_units())
    return 1e3 * run.total("screen_s") / n if n else None
