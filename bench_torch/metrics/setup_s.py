"""Process start to the first timed block: imports, the CUDA context, the
kernel library, the archives, the attaches, the traffic pool, the graph
capture and the warm-up calls."""


def read(run):
    return run["setup_s"]
