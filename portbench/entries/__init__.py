"""The program's entries, one module each, named by a configuration's
``entry``: each has ``open(cfg, path, device, name)``, which opens the built
collection at ``path`` as a restarted node does and returns an object
with ``open_s``, ``devbuild_s``, ``search(queries)`` (the timed call),
``route_counts()`` and ``close()``."""
