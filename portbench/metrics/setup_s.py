"""Process start to ready (host clock): interpreter and CUDA context,
the kernels loaded from the build cache, the collection opened from the
data cache, the device base built, the resident loop started, one batch
a submitter of the cell's own traffic. A checkout's first run also
builds the collection; that build is timed apart and left out."""


def read(run):
    return run["setup_s"]
