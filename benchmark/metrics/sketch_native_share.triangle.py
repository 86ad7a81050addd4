"""sketch_native_share.triangle: The files that the program's native
sketch pass sketched (its counter sketch_native) over all it sketched
(sketch_native + sketch_fallback), %.  A program without the counters
reads nothing."""


def read(run):
    native = run.total("sketch_native")
    n = native + run.total("sketch_fallback")
    return 100.0 * native / n if n else None
