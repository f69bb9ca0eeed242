"""Queries a second completed in the window (host clock): each
submitter's queries whose pages came back inside the window, over the
time from the window's start to its own last completion there, summed
over the submitters."""


def read(run):
    return run["rate"]
