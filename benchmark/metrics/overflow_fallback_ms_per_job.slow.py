"""overflow_fallback_ms_per_job.slow: The program's overflow_fallback_s
(the exact per-pair path of the rows that overflowed a device batch, on
the finalize thread) a completed job, ms.  0.0 where no pair overflowed;
None with no completed job, or where pairs overflowed in a program
without the span."""


def read(run):
    units = run.ok_units()
    if not units:
        return None
    if not any("overflow_fallback_s" in u.stats for u in units):
        return 0.0 if run.total("pairs_overflow") == 0 else None
    return 1e3 * run.total("overflow_fallback_s") / len(units)
