"""Admission signals (reference ``utils/priority.py``).

Only :class:`QueueFull` is carried: the resident loop's bounded queue
raises it. The priority tiers and tenant context of the reference wait
for the port's admission plane.
"""

from __future__ import annotations


class QueueFull(RuntimeError):
    """A bounded dispatch queue refused an enqueue — the overload signal
    (distinct from a timeout: no work was started at all)."""
