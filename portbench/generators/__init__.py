"""Query generators, one module each, named by a traffic file's
``generator``: each has ``stream(seed, corpus, **args)``, the traffic's
unique queries for ``seed`` without end."""
