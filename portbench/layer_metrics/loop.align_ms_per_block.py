"""The host's part of the five-point alignment, ms a block: the window's
``flush_align_seconds`` (run_report.json; the program's span under
``flush_embed``: the landmarks' stacking and padding, their copy to the
device and the align_warp launch) over its blocks.  Nothing where the
program has no such span (a bank that aligns nothing)."""


def read(ctx):
    r = ctx["report"]
    if not r.get("blocks") or "flush_align_seconds" not in r:
        return None
    return 1e3 * r["flush_align_seconds"] / r["blocks"]
