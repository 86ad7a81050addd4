"""search_query_p90_ms: The 90th percentile (nearest rank) of every call's
wall time in the window, ms; a failed call counts as slower than any
(where one lands on it, the window's length stands in)."""
import math


def read(run):
    walls = sorted(u.wall if u.ok else math.inf for u in run.units)
    if not walls:
        return None
    v = walls[math.ceil(0.9 * len(walls)) - 1]
    return 1e3 * (run.window_s if math.isinf(v) else v)
