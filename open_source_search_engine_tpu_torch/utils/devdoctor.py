"""devdoctor — the port's device preflight.

After ``tools/devdoctor.py`` (the JAX package's doctor; the port keeps
its own copy and imports nothing of it). The failure class it makes loud:
a run on a GPU host whose CUDA came up broken, silently resolved onto
the CPU and measured there, filed next to card-measured numbers.

* :func:`probe` records the torch and CUDA versions, whether CUDA is
  available, the device name, count and capability, ``mem_get_info``, and
  whether both kernels (``csrc/min_scores.cu``, ``csrc/fd_scores.cu``)
  build and load.
* The verdict: ``ok`` (a card, both kernels loaded), ``no-accelerator``
  (no card and none expected: benign on a CPU box), ``fallback`` (a card
  was expected — ``CUDA_VISIBLE_DEVICES`` names one, or the caller says
  so — but torch resolved the CPU) and ``init-failed`` (CUDA or a kernel
  build raised).

CLI: ``python -m open_source_search_engine_tpu_torch.utils.devdoctor
[--expect-card]`` prints the probe JSON and exits 0 (ok), 1 (fallback,
init-failed) or 2 (no accelerator).
"""

from __future__ import annotations

import json
import os
import sys

EXIT_OK = 0
EXIT_INIT_FAILED = 1
EXIT_NO_ACCEL = 2


def card_expected() -> bool:
    """Does the environment name a card? ``CUDA_VISIBLE_DEVICES`` set to
    anything but empty or ``-1``."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    return vis is not None and vis.strip() not in ("", "-1")


def _kernels() -> dict:
    """Build (in parallel) and load both kernels: {name: {"built",
    "loaded", "error"}}."""
    from concurrent.futures import ThreadPoolExecutor

    from ..query import cuda_build
    from ..query import fd_scores_kernel as fdk
    from ..query import min_scores_kernel as msk
    mods = {"min_scores": (msk, "osse_min_scores"),
            "fd_scores": (fdk, "osse_fd_scores")}

    def one(item):
        name, (mod, symbol) = item
        ent = {"built": False, "loaded": False, "error": None}
        try:
            mod.build()
            ent["built"] = True
            cuda_build.load(name, symbol, mod._ARGTYPES)
            ent["loaded"] = True
        except Exception as e:  # noqa: BLE001 — recorded, judged below
            ent["error"] = repr(e)[:300]
        return name, ent

    with ThreadPoolExecutor(len(mods)) as ex:
        return dict(ex.map(one, mods.items()))


def probe(expect_card: bool | None = None) -> dict:
    """The diagnosis record (see the module docstring)."""
    expected = card_expected() if expect_card is None else expect_card
    rec: dict = {"card_expected": expected, "error": None,
                 "torch_version": None, "cuda_version": None,
                 "cuda_available": False, "device_name": None,
                 "device_count": 0, "capability": None,
                 "mem_get_info": None, "kernels": None}
    try:
        import torch
        rec["torch_version"] = torch.__version__
        rec["cuda_version"] = torch.version.cuda
        rec["cuda_available"] = bool(torch.cuda.is_available())
        if rec["cuda_available"]:
            rec["device_count"] = torch.cuda.device_count()
            rec["device_name"] = torch.cuda.get_device_name(0)
            rec["capability"] = list(torch.cuda.get_device_capability(0))
            free, total = torch.cuda.mem_get_info(0)
            rec["mem_get_info"] = {"free": int(free), "total": int(total)}
    except Exception as e:  # noqa: BLE001 — a broken CUDA init
        rec["error"] = repr(e)[:300]
        rec["status"] = "init-failed"
        return rec
    if not rec["cuda_available"]:
        rec["status"] = "fallback" if expected else "no-accelerator"
        return rec
    rec["kernels"] = _kernels()
    bad = [k for k, v in rec["kernels"].items() if not v["loaded"]]
    if bad:
        rec["error"] = f"kernels not loaded: {bad}"
        rec["status"] = "init-failed"
    else:
        rec["status"] = "ok"
    return rec


def diagnose(rec: dict) -> str:
    """One actionable line per verdict."""
    s = rec["status"]
    if s == "ok":
        return (f"ok: {rec['device_name']} x {rec['device_count']} "
                f"(capability {rec['capability']}), both kernels loaded")
    if s == "no-accelerator":
        return ("no card present and none expected: CPU numbers are host "
                "numbers")
    if s == "fallback":
        return ("a card was expected (CUDA_VISIBLE_DEVICES or the caller "
                "says so) but torch sees no CUDA: check the NVIDIA kernel "
                "module, the CUDA build of torch and that no other process "
                "holds the card; numbers measured now would be CPU numbers")
    return f"init failed: {rec['error']}"


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--expect-card", action="store_true",
                    help="a card is expected whatever the environment says")
    opts = ap.parse_args(argv)
    rec = probe(expect_card=True if opts.expect_card else None)
    print(json.dumps(rec, indent=2))
    print(f"# {diagnose(rec)}", file=sys.stderr)
    if rec["status"] in ("init-failed", "fallback"):
        return EXIT_INIT_FAILED
    if rec["status"] == "no-accelerator":
        return EXIT_NO_ACCEL
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
