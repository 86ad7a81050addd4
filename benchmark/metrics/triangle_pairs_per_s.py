"""triangle_pairs_per_s: Pairs (N(N-1)/2 a job, screened-out pairs
included) of the completed jobs over the window: start to the end of the
last job."""


def read(run):
    return sum(u.work for u in run.ok_units()) / run.window_s
