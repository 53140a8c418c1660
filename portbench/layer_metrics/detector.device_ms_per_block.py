"""Device ms a block under the harness's range around the detector
(models/detector.py, ops/nms.py), in the traced window."""


def read(ctx):
    dev = ctx["trace"]["ranges"]["portbench.detector"]
    blocks = ctx["window"]["blocks"]
    if not blocks or dev["device_s"] <= 0:
        return None
    return 1e3 * dev["device_s"] / blocks
