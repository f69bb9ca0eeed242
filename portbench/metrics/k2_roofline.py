"""K2 (``csrc/fd_scores.cu``) against its roofline over the traced
window: the sum of each launch's bound (the frozen work model of
``portbench/workmodel.py`` over the launch's inputs, against the card's
published peaks) over the sum of its device time (profiler)."""

from portbench.reduce import roofline_pct


def read(run):
    return roofline_pct(run, "k2")
