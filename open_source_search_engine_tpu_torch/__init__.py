"""PyTorch/CUDA port of the search engine, beside the JAX package.

Same module names and layout as ``open_source_search_engine_tpu``, so
each module's counterpart is found by path. Imports ``torch`` and numpy
only. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that, it raises.

Ported so far: the flat query path (index → compile → pack → score →
ranked page) and the device-resident route (``query/devindex.py``: the
DeviceIndex build and plan, the F1 / F2 / FD waves), with both kernels
of the JAX package as hand-written CUDA (``csrc/min_scores.cu``,
``csrc/fd_scores.cu``); resident serving and the node's HTTP server; the
collection's record set (posdb, titledb, clusterdb, sectiondb, linkdb,
tagdb, fielddb, catdb) and the numeric operators ``gbmin:``/``gbmax:``/
``gbsortby:`` on every route.
"""

__version__ = "0.1.0"
