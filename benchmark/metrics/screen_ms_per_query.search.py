"""screen_ms_per_query.search: The program's screen_s a completed call, ms."""


def read(run):
    n = len(run.ok_units())
    return 1e3 * run.total("screen_s") / n if n else None
