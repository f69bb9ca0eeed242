"""The traced window: ``torch.profiler`` over the device (and the host's
operators, to name what the host did while the device idled), reduced
to the device's busy seconds, the time of each kernel, the operations
that took most device time, and the longest idle gaps.

Busy time is the union of the intervals in which any device operation
(kernel, copy, set) ran, so overlapping streams count once; idle is the
rest of the traced window.
"""

from __future__ import annotations

import time


#: the host-clock mark that ties the program's spans to the profiler's
#: clock
MARK = "portbench.mark"


def start(cuda: bool):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    with record_function(MARK):
        prof.portbench_mark = time.perf_counter()
    return prof


def _events(prof):
    """(name, on the device, start, end) of every event, in microseconds:
    the profiler's raw events where this torch exposes them (a window
    holds hundreds of thousands, and building the operator tree takes
    minutes), else its parsed ones."""
    try:
        out = []
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns() / 1e3
            user = getattr(e, "is_user_annotation", lambda: False)()
            out.append((e.name(), str(e.device_type()).endswith("CUDA")
                        and not user, a, a + e.duration_ns() / 1e3))
        return out
    except (AttributeError, TypeError, RuntimeError):
        return [(e.name, str(e.device_type).endswith("CUDA"),
                 e.time_range.start, e.time_range.end)
                for e in prof.events()]


def _union(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def stop(prof, window_s: float, spans: list) -> dict:
    """Stop the profiler and reduce its events (microseconds in the
    profiler's clock). ``kernels`` maps each device operation's name to
    its intervals in start order; ``spans`` are the program's (name,
    start, end) on the host clock, which name the idle gaps."""
    from portbench.reduce import KERNEL_NAMES
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    dev, mark = [], None
    for name, cuda, a, b in _events(prof):
        if name == MARK:
            mark = a
        elif cuda:
            dev.append((a, b, name))
    host = []
    if mark is not None:
        # the program's spans in the profiler's clock
        off = mark - prof.portbench_mark * 1e6
        host = [(s0 * 1e6 + off, s1 * 1e6 + off, name)
                for name, s0, s1 in spans]
    busy = _union([(a, b) for a, b, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    kernels: dict = {}
    for a, b, name in sorted(dev):
        kernels.setdefault(name, []).append((a, b))
    by_op = sorted(((name, sum(b - a for a, b in iv) / 1e6)
                    for name, iv in kernels.items()), key=lambda x: -x[1])
    gaps = []
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        gaps.append((a1 - b0, b0, a1))
    gaps.sort(reverse=True)
    host.sort()
    idle = []
    for g, a, b in gaps[:10]:
        # what the host was doing: the program's span that overlaps the
        # gap most, or else none
        best, name = 0.0, "host outside the program's spans"
        for ha, hb, hn in host:
            if ha >= b:
                break
            ov = min(hb, b) - max(ha, a)
            if ov > best:
                best, name = ov, hn
        idle.append([name, g / 1e6])
    counts = {k: sum(len(iv) for n, iv in kernels.items() if frag in n)
              for k, frag in KERNEL_NAMES.items()}
    return {"busy_s": busy_us / 1e6, "window_s": window_s,
            "kernels": kernels, "counts": counts,
            "breakdown": {"device_ops": [[n, s] for n, s in by_op[:10]],
                          "idle_gaps": idle},
            "reduce_s": time.perf_counter() - t0}
