"""Device ms a real crop under the harness's range around the bank's
crop+embed dispatch (the crop and the configuration's embedders), in the
traced window: padded crop slots count as waste."""


def read(ctx):
    dev = ctx["trace"]["ranges"]["portbench.embed"]
    crops = ctx["window"]["crops"]
    if not crops or dev["device_s"] <= 0:
        return None
    return 1e3 * dev["device_s"] / crops
