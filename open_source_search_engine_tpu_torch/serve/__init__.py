"""Serving planes: the HTTP server (``server.py``), its admission gate
(``admission.py``) and the tenant plane (``tenancy.py``: device
residency of each collection's index and resident loop)."""

from .server import SearchHTTPServer, serve

__all__ = ["SearchHTTPServer", "serve"]
