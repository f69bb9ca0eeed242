"""Milliseconds per query in the program's ``serve.render`` span over the
traced window (its stage total): the result page rendered to JSON."""

from portbench.reduce import per_query_ms


def read(run):
    return per_query_ms(run, "serve.render")
