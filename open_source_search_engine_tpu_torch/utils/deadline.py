"""Per-query deadlines (reference ``utils/deadline.py:42-133``).

A :class:`Deadline` is one monotonic instant the work must finish by. It
crosses threads explicitly (:class:`bind`; contextvars do not follow a
worker thread), and the checkpoints before device work call
:func:`check_abandon`, which counts ``deadline.abandoned`` so that a
wave nobody waits for any more is never issued. :func:`note_met` counts
``deadline.met`` where a budgeted query finishes in time.

Across processes a deadline travels as the remaining budget in the
``X-OSSE-Deadline`` header (:meth:`Deadline.header_value`), from which
the node rebuilds a local one (:meth:`Deadline.from_header`): wall clocks
do not agree between hosts, budgets do.
"""

from __future__ import annotations

import contextvars
import time

from . import trace as trace_mod
from .stats import g_stats


#: the wire header carrying the remaining budget (decimal seconds)
DEADLINE_HEADER = "X-OSSE-Deadline"


class DeadlineExceeded(RuntimeError):
    """Work was abandoned because its deadline passed."""


class Deadline:
    """One monotonic instant work must finish by."""

    __slots__ = ("at",)

    def __init__(self, at_monotonic: float):
        self.at = float(at_monotonic)

    @classmethod
    def after(cls, budget_s: float) -> "Deadline":
        return cls(time.monotonic() + float(budget_s))

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.at - time.monotonic() <= 0.0

    def clamp(self, timeout_s: float) -> float:
        """A sub-call timeout bounded by what is left of the budget
        (floored at 0)."""
        return max(0.0, min(float(timeout_s), self.remaining()))

    def header_value(self) -> str:
        return f"{max(self.remaining(), 0.0):.4f}"

    @classmethod
    def from_header(cls, value: str | None) -> "Deadline | None":
        if not value:
            return None
        try:
            return cls.after(float(value))
        except (TypeError, ValueError):
            return None

    def __repr__(self) -> str:  # noqa: D105
        return f"Deadline(remaining={self.remaining():.3f}s)"


_ctx: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar(
    "osse_deadline", default=None)


def current() -> Deadline | None:
    """The deadline bound in this context (None = unbudgeted work)."""
    return _ctx.get()


class bind:
    """Carry a Deadline across a scope: capture ``current()`` where the
    deadline is known and ``bind()`` it where the work runs."""

    def __init__(self, dl: Deadline | None):
        self._dl = dl
        self._tok = None

    def __enter__(self) -> Deadline | None:
        self._tok = _ctx.set(self._dl)
        return self._dl

    def __exit__(self, *exc) -> bool:
        _ctx.reset(self._tok)
        return False


def check_abandon(where: str, dl: Deadline | None = None) -> bool:
    """True when the given (or current) deadline has passed, and the
    caller abandons. Counts ``deadline.abandoned`` and a per-site
    counter, and tags the enclosing stage."""
    if dl is None:
        dl = _ctx.get()
    if dl is None or not dl.expired():
        return False
    g_stats.count("deadline.abandoned")
    g_stats.count(f"deadline.abandoned.{where}")
    trace_mod.tag(deadline="abandoned", deadline_where=where)
    return True


def note_met(dl: Deadline | None = None) -> None:
    """Count a budgeted query that finished inside its budget."""
    if dl is None:
        dl = _ctx.get()
    if dl is not None and not dl.expired():
        g_stats.count("deadline.met")
