"""Share of the traced window in which no device operation ran:
100 x (1 - union of the device's activity intervals / window), from
torch.profiler."""


def read(run):
    p = run["profile"]
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
