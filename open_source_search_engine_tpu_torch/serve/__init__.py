"""Serving planes: the tenant plane (device residency of each
collection's index and resident loop). The HTTP server waits."""
