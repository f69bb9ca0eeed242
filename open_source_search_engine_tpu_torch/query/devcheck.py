"""Device-plane guardrails — explicit checks on the kernel routes.

Port of ``open_source_search_engine_tpu/query/devcheck.py``. The
reference wraps its routes in ``jax.experimental.checkify``; here each
invariant is an explicit torch check on the tensors the route already
holds, run where the reference runs its sweep:

* **score finiteness** — no NaN/inf leaves a scoring wave;
* **top-k monotonicity** — emitted scores are non-increasing (the
  selection contract that paging and the escalation's k-th-score check
  depend on);
* **index bounds** — every live (score > 0) top-k row indexes a real
  doc (``idx < n_docs``);
* **cube payload sanity** — nonzero payloads decode to a hashgroup
  ``< HASHGROUP_END`` (a corrupt tile shows up here first: random bytes
  have hashgroup 11–15 with probability 5/16 per position).

The call sites: top-k invariants on every wave row that
``DeviceIndex.collect_batch`` emits, cube sanity on the resident cube
before an FD wave, and cube sanity at K1's entry
(``min_scores_kernel.min_scores_fused``). The reference skips the last
one under tracing, where its F1 and F2 programs call K1; the port's
routes run eagerly, so it checks every cube K1 scores.

Everything is opt-in: ``OSSE_CHECKIFY=1`` in the environment or the
``checkify`` parm (the server calls :func:`set_enabled`). Off, the hot
path pays one lookup. A trip raises :class:`DeviceCheckError` naming the
route and counts ``devcheck.trip`` (and ``devcheck.trip.<route>``) in
``g_stats``.

The fault injector (:func:`inject`) corrupts wave outputs or cube
payloads before the checks, host-side or on a copy, so tests prove the
harness fires without corrupting device state.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..index.posdb import HASHGROUP_END
from ..utils.log import get_logger
from ..utils.stats import g_stats

log = get_logger("devcheck")

#: monotonicity slack: float32 reassociation across kernel variants
_TIE_EPS = 1e-5

#: payload bits 18–21: the hashgroup (the sign bit, the synonym flag, is
#: outside the mask, so the int32 view compares as the uint32 would)
_HG_MASK = 0xF << 18
_HG_BAD = HASHGROUP_END << 18

#: cube elements swept per step (bounds the sweep's temporaries)
_SWEEP = 1 << 26

#: parm override (None = the OSSE_CHECKIFY env var decides)
_flag: bool | None = None

#: active fault kind (None | "nan" | "oob_docid" | "corrupt_tile")
_fault: str | None = None

FAULTS = ("nan", "oob_docid", "corrupt_tile")


class DeviceCheckError(RuntimeError):
    """A device-plane guardrail tripped."""


def set_enabled(on: bool | None) -> None:
    """Parm hook: True forces on, None defers to ``OSSE_CHECKIFY``."""
    global _flag
    _flag = on


def enabled() -> bool:
    if _flag is not None:
        return _flag
    return os.environ.get("OSSE_CHECKIFY", "") == "1"


# --------------------------------------------------------------- checks

def _trip(route: str, msg: str) -> None:
    g_stats.count("devcheck.trip")
    if route:
        g_stats.count(f"devcheck.trip.{route}")
    log.error("devcheck TRIP [%s]: %s", route or "-", msg)
    raise DeviceCheckError(f"[{route or 'device'}] {msg}")


def check_topk(scores, idx, n_docs: int, route: str = "") -> None:
    """Assert the emitted top-k invariants (finite, sorted, in bounds)
    on one wave row: numpy arrays or tensors. No-op unless
    :func:`enabled`. Raises :class:`DeviceCheckError`."""
    if not enabled():
        return
    s = torch.as_tensor(np.asarray(scores) if not torch.is_tensor(scores)
                        else scores).to(torch.float32)
    i = torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx)
                        else idx).to(torch.int64)
    bad = ~torch.isfinite(s)
    if bool(bad.any()):
        _trip(route, "non-finite top-k score left the device "
              f"(nan_count={int(bad.sum())})")
    if s.numel() > 1:
        drop = s[:-1] < s[1:] - _TIE_EPS
        if bool(drop.any()):
            _trip(route, "top-k scores not monotonic non-increasing "
                  f"(first violation rank={int(drop.int().argmax())})")
    live = s > 0.0
    oob = live & ((i < 0) | (i >= n_docs))
    if bool(oob.any()):
        _trip(route, "out-of-range docid index in live top-k row "
              f"(idx={int(i[live].max())} >= n_docs={n_docs})")


def check_cube(cube, route: str = "") -> None:
    """Assert cube payload sanity (the hashgroup bits of every nonzero
    payload decode in range) over a tensor of any shape. No-op unless
    :func:`enabled`."""
    if not enabled():
        return
    flat = cube.reshape(-1)
    n = 0
    for a in range(0, flat.numel(), _SWEEP):
        n += int(((flat[a:a + _SWEEP] & _HG_MASK) >= _HG_BAD).sum())
    if n:
        _trip(route, f"corrupt position-cube tile: {n} nonzero payloads "
              "decode to hashgroup >= HASHGROUP_END")


# --------------------------------------------------------- fault injector

@contextlib.contextmanager
def inject(kind: str):
    """Corrupt the next checked wave: ``"nan"`` poisons a score,
    ``"oob_docid"`` points a live row past n_docs, ``"corrupt_tile"``
    gives a cube payload an out-of-range hashgroup. Proves the checks
    fire (tests and the chip smoke)."""
    global _fault
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    prev = _fault
    _fault = kind
    try:
        yield
    finally:
        _fault = prev


def apply_fault(idx: np.ndarray, scores: np.ndarray, n_docs: int):
    """Apply the armed output fault (if any) to one parsed wave row.
    Returns possibly replaced (idx, scores) copies."""
    if _fault == "nan":
        scores = np.asarray(scores).copy()
        scores[0] = np.nan
        g_stats.count("devcheck.injected")
    elif _fault == "oob_docid":
        idx = np.asarray(idx).copy()
        scores = np.asarray(scores).copy()
        idx[0] = n_docs + 7
        scores[0] = max(float(scores[0]), 1.0)  # a LIVE row
        g_stats.count("devcheck.injected")
    return idx, scores


def apply_cube_fault(cube: torch.Tensor) -> torch.Tensor:
    """Apply the armed cube fault (if any) to a copy of ``cube``: one
    payload with hashgroup 0xF (>= HASHGROUP_END) and a nonzero
    wordpos."""
    if _fault != "corrupt_tile":
        return cube
    cube = cube.clone()
    cube.view(-1)[0] = (0xF << 18) | 1
    g_stats.count("devcheck.injected")
    return cube
