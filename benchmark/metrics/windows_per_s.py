"""Windows answered in the window over its seconds (host clock): every
window of every call begun inside it, over the time to the last call's
return."""


def read(run):
    return run.windows / run.window_s
