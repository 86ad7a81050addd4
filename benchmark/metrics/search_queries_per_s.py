"""search_queries_per_s: Completed calls over the window: start to the end
of the last call."""


def read(run):
    return len(run.ok_units()) / run.window_s
