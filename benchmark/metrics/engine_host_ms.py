"""Per call, its host-clock time less the device's busy time inside it (the
union of its traced operations): the median over the traced calls."""

from benchlib.stats import percentile


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    return percentile([c.wall_ms - c.busy_ms for c in run.trace.calls], 50)
