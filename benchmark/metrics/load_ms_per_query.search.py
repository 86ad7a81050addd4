"""load_ms_per_query.search: The benchmark's `load` spans a completed call
(markers.bin read, database opened, references read), ms."""


def read(run):
    n = len(run.ok_units())
    if not n or not run.trace:
        return None
    return 1e3 * run.total("load", "spans") / n
