"""Per call, the host time spent building and enqueueing device work: the
summed self time of the engine's ``search.fingerprint``, ``search.votes``,
``search.prefilter`` and ``search.rank`` spans, the median over the calls
of a run that recorded the program's spans (``benchlib/spans.py``)."""

from benchlib.spans import LAUNCH


def read(run):
    spans = getattr(run, "spans", None)
    return None if spans is None else spans.median_ms(*LAUNCH)
