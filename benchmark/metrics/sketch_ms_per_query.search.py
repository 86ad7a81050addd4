"""sketch_ms_per_query.search: The benchmark's `sketch` spans (the query
read and sketched) a completed call, ms."""


def read(run):
    n = len(run.ok_units())
    if not n or not run.trace:
        return None
    return 1e3 * run.total("sketch", "spans") / n
