"""Per call, the self time of the engine's ``search.upload`` span (the
copies of the windows into pinned memory and their enqueue to the
device): the median over the calls of a run that recorded the program's
spans (``benchlib/spans.py``)."""


def read(run):
    spans = getattr(run, "spans", None)
    return None if spans is None else spans.median_ms("search.upload")
