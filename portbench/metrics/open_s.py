"""Seconds to open the cached collection, host clock."""


def read(run):
    return run["open_s"]
