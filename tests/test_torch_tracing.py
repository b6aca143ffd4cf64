"""The port's span recorder (``tiresias_tpu_torch/utils/tracing.py``) and the
spans and gate counters at the engine's layer boundaries, on the CPU."""

import threading

import pytest

from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import TiresiasConfig
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.utils import tracing
from tiresias_tpu_torch.utils.audio import synth_tone
from tiresias_tpu_torch.utils.g711 import encode
from tiresias_tpu_torch.utils.tracing import Span, metrics, phase, span

SR = 8000

# search_pcm_batch's children of its search.match root, in call order, for
# one view whose prefilter gate refuses (the gate admitting adds a
# search.prefilter under the second search.votes)
CHILDREN = ["search.prepare", "search.upload", "search.fingerprint",
            "search.votes", "search.votes", "search.rank", "search.readback",
            "search.results"]


@pytest.fixture
def recording():
    """Recording on for one test; off again, whatever the test does."""
    tracing.start()
    try:
        yield
    finally:
        tracing.stop()


def test_spans_nest_with_parent_and_call_id(recording):
    with span("a"):
        with span("b"):
            with span("c"):
                pass
        with span("d"):
            pass
    with span("e"):
        pass
    got = {s.name: s for s in tracing.stop()}
    a, b, c, d, e = (got[n] for n in "abcde")
    assert a.parent is None and a.root == a.id
    assert b.parent == a.id and c.parent == b.id and d.parent == a.id
    assert {b.root, c.root, d.root} == {a.id}
    assert e.parent is None and e.root == e.id != a.id
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
    assert b.end_ns <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns


def test_threads_keep_separate_stacks(recording):
    inside = threading.Barrier(2, timeout=30)

    def work(tag):
        with span(f"root.{tag}"):
            inside.wait()  # both roots are open at once
            with span(f"child.{tag}"):
                inside.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    got = {s.name: s for s in tracing.stop()}
    for tag in "xy":
        root, child = got[f"root.{tag}"], got[f"child.{tag}"]
        assert root.parent is None
        assert child.parent == root.id and child.root == root.id


def test_self_time_is_the_duration_less_what_children_cover():
    spans = [
        Span("root", 0, 100, 1, None, 1),
        Span("a", 10, 30, 2, 1, 1),
        Span("b", 40, 70, 3, 1, 1),
        Span("b.x", 45, 50, 4, 3, 1),
        Span("b.y", 48, 60, 5, 3, 1),  # overlaps b.x: counted once
        Span("c", 90, 120, 6, 1, 1),  # past its parent's end: clipped
    ]
    assert tracing.self_ns(spans) == {1: 100 - 20 - 30 - 10, 2: 20,
                                      3: 30 - 15, 4: 5, 5: 12, 6: 30}


def test_recording_off_keeps_nothing_but_the_named_timings():
    assert span("x") is span("y")  # one shared object that does nothing
    n = len(metrics.snapshot()["timings"].get("search.match", []))
    with span("outer"), phase("search.match"):
        pass
    tracing.start()
    assert tracing.stop() == []
    assert len(metrics.snapshot()["timings"]["search.match"]) == n + 1


def test_recording_keeps_the_newest_spans_and_stops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.start()
    try:
        for i in range(5):
            with span(f"s{i}"):
                pass
    finally:
        kept = tracing.stop()
    assert [s.name for s in kept] == ["s2", "s3", "s4"]
    with span("after"):
        pass
    tracing.start()
    assert tracing.stop() == []


def test_a_raising_span_is_kept_and_unwinds(recording):
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError("boom")
    with span("next"):
        pass
    got = {s.name: s for s in tracing.stop()}
    assert got["inner"].parent == got["outer"].id
    assert got["next"].parent is None


def _engine(tmp_path, n=24):
    eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                   device="cpu")
    eng.create_context("c")
    for i in range(n):
        eng.add_audio_pcm("c", f"t{i}", synth_tone(300 + 40 * i, 1.0, SR), SR)
    return eng


def _calls(spans):
    """``{root id: [child names in start order]}`` of each search.match."""
    roots = {s.id: s for s in spans if s.parent is None}
    kids: dict = {r: [] for r in roots}
    for s in sorted(spans, key=lambda s: s.start_ns):
        if s.parent in kids:
            kids[s.parent].append(s.name)
    assert {r.name for r in roots.values()} == {"search.match"}
    return kids


@pytest.mark.parametrize("law", [None, "ulaw"])
def test_search_pcm_batch_is_one_root_with_its_children_in_order(
        tmp_path, law):
    eng = _engine(tmp_path)
    tones = [synth_tone(300 + 40 * i, 1.0, SR) for i in (3, 7, 11)]
    windows = [encode(t, law) for t in tones] if law else tones
    tracing.start()
    try:
        for _ in range(2):
            assert len(eng.search_pcm_batch("c", windows, SR,
                                            wire_law=law)) == 3
    finally:
        spans = tracing.stop()
    eng.close()
    calls = _calls(spans)
    assert len(calls) == 2
    assert all(names == CHILDREN for names in calls.values())
    own = tracing.self_ns(spans)
    for s in spans:
        assert own[s.id] >= 0
        assert s.start_ns <= s.end_ns


def test_gate_counters_count_admits_and_refusals(tmp_path, monkeypatch):
    """A 24-row view at the default budgets is below the size gate: each
    search counts one refusal. With budgets of 4 (so 24 rows > 2k) the gate
    admits, and the prefilter runs inside the view's votes."""
    eng = _engine(tmp_path)
    q = synth_tone(300 + 40 * 5, 1.0, SR)

    def counts():
        c = metrics.snapshot()["counters"]
        return (c.get("search.prefilter_admitted", 0),
                c.get("search.prefilter_refused", 0))

    a0, r0 = counts()
    for _ in range(3):
        eng.search_pcm("c", q, SR)
    a1, r1 = counts()
    assert (a1 - a0, r1 - r0) == (0, 3)

    monkeypatch.setattr(tml, "LATTICE_PREFILTER_K", 4)
    monkeypatch.setattr(tk, "PREFILTER_K", 4)
    tracing.start()
    try:
        eng.search_pcm("c", q, SR)
    finally:
        spans = tracing.stop()
    eng.close()
    a2, r2 = counts()
    assert (a2 - a1, r2 - r1) == (1, 0)
    by_id = {s.id: s for s in spans}
    pf = [s for s in spans if s.name == "search.prefilter"]
    assert len(pf) == 1 and by_id[pf[0].parent].name == "search.votes"
