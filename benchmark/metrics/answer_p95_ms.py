"""The 95th percentile, over every window answered in the window, of the
time from the start of the call that carried it to the call's return with
its results (host clock)."""

from benchlib.stats import percentile


def read(run):
    per_window = [ms for ms in run.call_ms for _ in range(run.batch)]
    return percentile(per_window, 95)
