"""db_pack_native_share.triangle: The genomes whose DeviceDb rows the
program's native pass packed (its counter db_pack_native) over all it
packed (db_pack_native + db_pack_fallback), %.  A program without the
counters reads nothing."""


def read(run):
    native = run.total("db_pack_native")
    n = native + run.total("db_pack_fallback")
    return 100.0 * native / n if n else None
