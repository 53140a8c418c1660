"""The host's upload of a block, ms a block: the window's
``upload_seconds`` (run_report.json) over its blocks.  The copy is from
pageable memory, so it starts only once the device has run the work
queued before it: this is where the host waits for the device, and it
holds the copy itself (about 170 MB a block at 576x768)."""


def read(ctx):
    r = ctx["report"]
    return 1e3 * r["upload_seconds"] / r["blocks"] if r.get("blocks") else None
