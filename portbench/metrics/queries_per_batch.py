"""Queries a device batch held over the traced window: the window's
queries over the calls of the program's ``query.device_batch`` span, so
how full the server's micro-batcher made its batches."""


def read(run):
    calls, _ = run["totals"].get("query.device_batch", (0, 0.0))
    if not calls or not run["traced_queries"]:
        return None
    return run["traced_queries"] / calls
