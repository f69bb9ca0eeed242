"""Milliseconds per query in the program's ``devindex.issue`` span over the
traced window (its stage total)."""

from portbench.reduce import per_query_ms


def read(run):
    return per_query_ms(run, "devindex.issue")
