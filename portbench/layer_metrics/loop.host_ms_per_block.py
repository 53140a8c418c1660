"""The extract loop's own host work, ms a block: block-step dispatch,
consume and crop+embed dispatch seconds over the window's blocks, from
the window's run_report.json (no profiler runs in the window).  The
upload, where the host waits for the device, is
``loop.upload_ms_per_block``.  It hides device time only where it
overlaps it."""

PHASES = ("dispatch", "consume", "flush_dispatch")


def read(ctx):
    r = ctx["report"]
    if not r.get("blocks"):
        return None
    return 1e3 * sum(r[f"{p}_seconds"] for p in PHASES) / r["blocks"]
