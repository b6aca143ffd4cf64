"""Per call, the self time of the engine's ``search.prepare`` span (the
search's checks, resampling, padding the windows to one bucketed array):
the median over the calls of a run that recorded the program's spans
(``benchlib/spans.py``)."""


def read(run):
    spans = getattr(run, "spans", None)
    return None if spans is None else spans.median_ms("search.prepare")
