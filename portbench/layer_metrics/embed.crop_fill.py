"""The share of crop+embed batch slots that hold a real crop, %: the
window's ``embed_crops`` over ``embed_slots`` (run_report.json; the
program counts both where it pads each batch to a multiple of 64 on a
card).  The rest is work on padding.  Nothing where the program has no
such counters or embedded nothing."""


def read(ctx):
    r = ctx["report"]
    if not r.get("embed_slots"):
        return None
    return 100.0 * r["embed_crops"] / r["embed_slots"]
