"""The share of the traced window, from the first call's marker to the
closing spin on the device, in which no kernel, copy or memset ran."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
