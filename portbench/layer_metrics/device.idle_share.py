"""The share of the traced window, %, in which no activity ran on the
device: 1 - the union of kernel, copy and set intervals / the window."""


def read(ctx):
    t = ctx["trace"]
    if t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
