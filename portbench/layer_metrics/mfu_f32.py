"""The whole step's share of the card's float32 peak (outside the tensor
cores; the path runs float32 with TF32 off), %: the model FLOPs of the
traced window's work (the detector's forward on each of its frames, the
configuration's embedders on each real crop: its family's
``flops_per_crop``; portbench/counts.py) over the window and the peak
(portbench/peaks.json)."""


def read(ctx):
    w, t = ctx["window"], ctx["trace"]
    peak = next((v for k, v in ctx["peaks"].items()
                 if k in ctx["device_kind"]), None)
    if peak is None or t["window_s"] <= 0 or not w["blocks"]:
        return None
    flops = (w["blocks"] * ctx["block_frames"]
             * ctx["detector_flops_per_frame"]
             + w["crops"] * ctx["embed_flops_per_crop"])
    return 100.0 * flops / t["window_s"] / peak["f32_flops_per_s"]
