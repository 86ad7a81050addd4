"""device_idle_share.search: One less the device's busy share of the traced
window (the union of its operations), %."""


def read(run):
    if not run.profile:
        return None
    p = run.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
