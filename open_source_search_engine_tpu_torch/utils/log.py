"""Typed logging (reference: ``Log.cpp/h``): one logger per subsystem
under the ``osse_torch`` root, on top of :mod:`logging`, each type
switchable at run time. Every line written inside a trace carries the
trace id, so the lines of a coordinator and of its nodes for one query
grep together."""

from __future__ import annotations

import logging
import sys

_ROOT = "osse_torch"
_configured = False


class _TraceIdFilter(logging.Filter):
    """Stamp each record with the active trace id (``utils.trace``'s
    contextvar) as `` [<id>]``; outside a trace the stamp is empty and the
    line keeps its plain format."""

    def filter(self, record: logging.LogRecord) -> bool:
        from . import trace  # late: trace imports this module
        tid = trace.current_trace_id()
        record.traceid = f" [{tid}]" if tid else ""
        return True


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname).1s%(traceid)s %(message)s"))
    handler.addFilter(_TraceIdFilter())
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    _configured = True


def get_logger(log_type: str = "admin") -> logging.Logger:
    """The logger for a subsystem log type (e.g. ``"query"``)."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{log_type}")


def set_log_type_enabled(log_type: str, enabled: bool) -> None:
    """Switch one log type at run time (the reference's Log admin page)."""
    _configure()
    logging.getLogger(f"{_ROOT}.{log_type}").setLevel(
        logging.DEBUG if enabled else logging.WARNING)
