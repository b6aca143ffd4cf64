"""Device ms a call of the fingerprint layer's operations (see
metrics/kernel_layers.json), over the traced calls. 0 where the traced
calls ran none."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.layer_ms("fingerprint")
