"""The equalize kernels' share of their memory roofline, %: the least
bytes a block of the scene stage needs (portbench/counts.py) over the
card's HBM rate, against the time a block of the kernels named hist256*
and cum_lookup* (csrc/equalize.cu) in the traced window."""


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["kernels"].items()
            if "hist256" in name or "cum_lookup" in name)
    blocks = ctx["window"]["blocks"]
    peak = next((v for k, v in ctx["peaks"].items()
                 if k in ctx["device_kind"]), None)
    if t <= 0 or not blocks or peak is None:
        return None
    bound = ctx["scene_bytes_per_block"] / peak["hbm_bytes_per_s"]
    return 100.0 * bound / (t / blocks)
