"""Per call, the self time of the engine's ``search.results`` span (the
winners picked from the one readback and a ``SearchResult`` built per
window): the median over the calls of a run that recorded the program's
spans (``benchlib/spans.py``)."""


def read(run):
    spans = getattr(run, "spans", None)
    return None if spans is None else spans.median_ms("search.results")
