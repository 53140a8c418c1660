"""The alignment kernel's share of its memory roofline, %: the least
bytes of the traced window's real crops over the card's HBM rate,
against the time of the kernels named align_warp* (csrc/align.cu) in the
window.  A crop's least bytes are its (3, 112, 112) float32 output
written once and its five (x, y) float32 landmarks read once; the frame
pixels it samples, a few KB that depend on the face's size, are left
out.  Nothing where no such kernel ran."""

CROP_BYTES = 3 * 112 * 112 * 4 + 5 * 2 * 4     # 150,568


def read(ctx):
    t = sum(s for name, s in ctx["trace"]["kernels"].items()
            if "align_warp" in name)
    crops = ctx["window"]["crops"]
    peak = next((v for k, v in ctx["peaks"].items()
                 if k in ctx["device_kind"]), None)
    if t <= 0 or not crops or peak is None:
        return None
    return 100.0 * crops * CROP_BYTES / peak["hbm_bytes_per_s"] / t
