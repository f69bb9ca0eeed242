"""Milliseconds per query in the program's ``serve.batch_wait`` span over
the traced window (its stage total): each request's wait in the HTTP
server's micro-batcher, from its arrival to its batch's start."""

from portbench.reduce import per_query_ms


def read(run):
    return per_query_ms(run, "serve.batch_wait")
