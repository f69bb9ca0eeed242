"""Reductions the metric readers share: a stage total per query, and a
kernel's share of its roofline over a traced window."""

from __future__ import annotations

from . import workmodel

#: a kernel's launches as the profiler names them (the port's kernel
#: function names)
KERNEL_NAMES = {"k1": "min_scores_", "k2": "fd_scores_"}


def per_query_ms(run, span):
    """Milliseconds per query in the program's ``span`` (its stage total,
    ``utils/trace.totals``: name -> [calls, seconds]) over the traced
    window."""
    calls, secs = run["totals"].get(span, (0, 0.0))
    if not calls or not run["traced_queries"]:
        return None
    return secs * 1e3 / run["traced_queries"]


def roofline_pct(run, which: str):
    """100 x the sum of the held launches' bounds over the sum of their
    device times: the i-th launch of a kernel is the i-th of its device
    intervals in start order (every held launch, a systematic sample of
    the window's). None without a trace, a listed card or a launch."""
    p, cap, pk = run["profile"], run["capture"], run["peaks"]
    if not p or cap is None or pk is None:
        return None
    frag = KERNEL_NAMES[which]
    iv = sorted(x for name, ivs in p["kernels"].items() if frag in name
                for x in ivs)
    held = [(i, args) for i, args, _ in cap.kept[which] if i < len(iv)]
    if not held:
        return None
    work = workmodel.k1_work if which == "k1" else workmodel.k2_work
    bound = sum(workmodel.bound_s(*work(*args), pk) for _, args in held)
    dev_s = sum(iv[i][1] - iv[i][0] for i, _ in held) / 1e6
    return 100.0 * bound / dev_s
