"""The share of the traced window in which the device ran nothing while a
``search.match`` span was open on the host: the idle time the program
causes, as against the harness's time between calls (``benchlib/
spans.py``; the spans on the profile's clock)."""


def read(run):
    spans = getattr(run, "spans", None)
    return None if spans is None else spans.idle_pct()
