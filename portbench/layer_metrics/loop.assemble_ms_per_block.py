"""The host's trajectory assembly, ms a block: the window's
``consume_assemble_seconds`` (run_report.json; the program's span around
``ShardConsumer.feed_block``: the tracker's emissions into trajectories,
their records, the pending faces) over its blocks.  Nothing where the
program has no such span."""


def read(ctx):
    r = ctx["report"]
    if not r.get("blocks") or "consume_assemble_seconds" not in r:
        return None
    return 1e3 * r["consume_assemble_seconds"] / r["blocks"]
