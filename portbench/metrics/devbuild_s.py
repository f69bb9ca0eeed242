"""Seconds to build the device base (and start the
resident loop), ending in ``torch.cuda.synchronize()``, host clock."""


def read(run):
    return run["devbuild_s"]
