"""Device ms a block of the kernels named tracker_scan* (csrc/tracker.cu)
in the traced window.  A latency chain, so a time and not a roofline."""


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["kernels"].items()
            if "tracker_scan" in name)
    blocks = ctx["window"]["blocks"]
    return 1e3 * t / blocks if t > 0 and blocks else None
