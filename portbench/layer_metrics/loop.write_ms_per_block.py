"""The host's writing of feature records, ms a block: the window's
``consume_write_seconds`` (run_report.json; the program's span around
``ShardConsumer.complete_flush``: fetched embeddings to lists, the
records' JSON, the file writes) over its blocks.  Nothing where the
program has no such span."""


def read(ctx):
    r = ctx["report"]
    if not r.get("blocks") or "consume_write_seconds" not in r:
        return None
    return 1e3 * r["consume_write_seconds"] / r["blocks"]
