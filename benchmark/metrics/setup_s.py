"""Seconds from the process's start to the first timed call: imports, the
catalog's making and fingerprinting, the kernel library (built on a
checkout's first run), the search maps and the warm-up calls."""


def read(run):
    return run.setup_s
