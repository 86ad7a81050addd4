"""update_rows_ms_per_query.search: The benchmark's `update_rows` spans
(DeviceDb.update_rows: host packing and enqueue) a completed call, ms."""


def read(run):
    n = len(run.ok_units())
    if not n or not run.trace:
        return None
    return 1e3 * run.total("update_rows", "spans") / n
