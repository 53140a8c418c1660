"""The host's wait for the device's grouped results, ms a block: the
window's ``fetch_seconds`` (run_report.json) over its blocks.  Near 0
while the upload is a pageable copy: that copy waits for the device
first (``loop.upload_ms_per_block``), so a group's results are in by the
time they are collected.  An upload that stops waiting moves the wait
here."""


def read(ctx):
    r = ctx["report"]
    return 1e3 * r["fetch_seconds"] / r["blocks"] if r.get("blocks") else None
