"""overflow_share.triangle: The program's pairs_overflow (pairs sent to the
exact per-pair fallback) over the pairs the screen passed, %."""


def read(run):
    p = run.total("pairs_screened", "counts")
    return 100.0 * run.total("pairs_overflow") / p if p else None
