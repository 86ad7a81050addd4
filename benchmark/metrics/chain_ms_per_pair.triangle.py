"""chain_ms_per_pair.triangle: The program's executor_s less its
db_build_s, over the pairs the screen passed (counted from the screen's
own verdicts), ms a pair."""


def read(run):
    p = run.total("pairs_screened", "counts")
    if not p:
        return None
    return 1e3 * (run.total("executor_s") - run.total("db_build_s")) / p
