"""dp_roofline: The chaining DP kernels' share of their roofline over the
traced window: the sum of every launch's least time over the sum of
their device time, %."""


def read(run):
    dp = (run.profile or {}).get("dp")
    if not dp or not dp["device_s"] or not dp["least_s"]:
        return None
    return 100.0 * dp["least_s"] / dp["device_s"]
