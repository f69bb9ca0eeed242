"""The port's benchmark: ``run.py`` runs one cell once (see
``BENCHMARK.json`` at the root of the repository)."""
