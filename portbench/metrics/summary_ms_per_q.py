"""Milliseconds per query in the program's ``query.summary`` span over
the traced window (its stage total): the summaries of a page's rows."""

from portbench.reduce import per_query_ms


def read(run):
    return per_query_ms(run, "query.summary")
