"""The reading of the program's spans on the device trace's clock
(``benchlib/spans.py``) and the metrics that read it, on synthetic spans
and device records."""

import types

import pytest

from benchlib import spans as sp, trace as tr
from benchlib.cell import load_module
from tiresias_tpu_torch.utils.tracing import Span

OFF = 7_000_000_000  # the profile's clock less the host's, ns
STEP = 60_000  # a call every 60 us on the host
SPIN_NAME = "at::cuda::(anonymous namespace)::spin_kernel(long)"
METRICS = ("engine_prepare_ms", "engine_upload_ms", "engine_launch_ms",
           "engine_results_ms", "search_idle_pct")

# one call, host ns from its slot's start: each child span (start, end) and
# the device work it launches: (launch at, op name, device start, end)
CHILDREN = [
    ("search.prepare", 3_000, 10_000, []),
    ("search.upload", 10_000, 12_000,
     [(11_000, "Memcpy HtoD (Pinned -> Device)", 15_000, 16_000)]),
    ("search.fingerprint", 12_000, 14_000,
     [(13_000, "mfcc_rows_fft_kernel", 16_000, 20_000)]),
    ("search.votes", 14_000, 16_000,
     [(15_000, "match_votes_aligned_bits_kernel", 20_000, 40_000)]),
    ("search.rank", 16_000, 17_000, [(16_500, "reduce_kernel", 40_000,
                                      41_000)]),
    ("search.readback", 17_000, 42_000,
     [(17_500, "Memcpy DtoH (Device -> Pageable)", 41_000, 41_500)]),
    ("search.results", 42_000, 49_000, []),
]
ROOT_SPAN = (3_000, 50_000)
MARK = (500, 5_000, 15_000)  # launched; device start, end


def _window(calls=3, drift=0, stray=None, slow_copy=None):
    """``(spans, Records, Trace, brackets)`` of ``calls`` calls on the host
    clock and the profile's; the host clock's readings around each call's
    calibration call are 2.6 and 2.9 us into its slot, the call itself 2.7
    to 2.8 us on the profile's clock. ``drift``: ns by which call i's
    device times run late, times i - 1.
    ``stray``: a call that launches one more op from its results span;
    ``slow_copy``: a call whose readback copy ends 1 us after its readback
    span."""
    spans, ops, host, cal, brackets = [], [], {}, [], []
    ids = iter(range(1, 10_000))
    corr = iter(range(1, 10_000))

    def op(name, launch, s, e, late=0):
        c = next(corr)
        ops.append((name, s + OFF + late, e + OFF + late, c))
        host[c] = launch + OFF

    t = 1_000_000
    for i in range(tr.LEAD_IN):  # lead-in: short spins, then a long one
        op(SPIN_NAME, t + 10 * i, t + 10 * i + 100, t + 10 * i + 1_000)
    op(SPIN_NAME, t + 1_000, t + 2_000, t + 600_000)
    t = 2_000_000
    for i in range(calls):
        base = t + i * STEP
        late = (i - 1) * drift
        c = next(corr)
        ops.append((SPIN_NAME, base + MARK[1] + OFF + late,
                    base + MARK[2] + OFF + late, c))
        host[c] = base + MARK[0] + OFF
        brackets.append((base + 2_600, base + 2_900))
        cal.append((base + 2_700 + OFF, base + 2_800 + OFF))
        root = next(ids)
        for j, (name, a, b, work) in enumerate(CHILDREN):
            spans.append(Span(name, base + a, base + b, next(ids), root,
                              root))
            for launch, opname, s, e in work:
                if i == slow_copy and name == "search.readback":
                    e = 43_000
                op(opname, base + launch, base + s, base + e, late)
            if i == stray and name == "search.results":
                op("reduce_kernel", base + 45_000, base + 45_500,
                   base + 46_000, late)
        spans.append(Span("search.match", base + ROOT_SPAN[0],
                          base + ROOT_SPAN[1], root, None, root))
    close = t + calls * STEP + 10_000
    op(SPIN_NAME, close - 1_000, close, close + 500_000, (calls - 2) * drift)
    ops.sort(key=lambda o: o[1])
    base_ns = ops[0][1]
    rec = sp.Records(ops, host, base_ns, cal)
    trace = tr.read([(n, (s - base_ns) / 1e3, (e - base_ns) / 1e3)
                     for n, s, e, _ in ops], [0.05] * calls,
                    tr.load_layer_map())
    return spans, rec, trace, brackets


def test_the_calibration_calls_tie_the_clocks():
    r = sp.read(*_window())
    # each bracket is 300 ns long around a 100 ns call: the offset is
    # exact, within 100 ns either way
    assert r.clock.offset_ns == OFF
    assert r.clock.residual_us == pytest.approx(0.1)
    assert r.clock.calls == 3


def test_calibrations_that_do_not_pair_give_no_reading():
    spans, rec, trace, brackets = _window()
    assert sp.read(spans, rec, trace, brackets[1:]) is None
    assert sp.read(spans, rec, trace, []) is None


def test_self_times_per_call():
    r = sp.read(*_window())
    assert len(r.calls) == 3
    assert r.median_ms("search.prepare") == pytest.approx(0.007)
    assert r.median_ms("search.upload") == pytest.approx(0.002)
    assert r.median_ms(*sp.LAUNCH) == pytest.approx(0.005)
    assert r.median_ms("search.results") == pytest.approx(0.007)
    assert r.median_ms(sp.ROOT) == pytest.approx(0.001)


def test_idle_by_span_names_the_innermost_open_span():
    r = sp.read(*_window())
    got = dict(r.idle_by_span(top=20))
    # the window runs from the first marker's device start (5 us into the
    # first call's slot) to the closing spin (10 us after the last slot);
    # the device is busy from the upload's copy to the readback copy, 15
    # to 41.5 us into each slot. The first call's idle starts at the
    # window's start, 2 us into its prepare span; the others' at the last
    # call's readback copy.
    want_us = {"search.prepare": 5 + 7 + 7, "search.upload": 3 * 2,
               "search.fingerprint": 3 * 2, "search.votes": 3 * 1,
               "search.readback": 3 * 0.5, "search.results": 3 * 7,
               "search.match": 3 * 1, sp.OUTSIDE: 2 * 13 + 20}
    assert got == pytest.approx({k: v * 1e-6 for k, v in want_us.items()})
    assert r.window_s == pytest.approx(185e-6)
    assert sum(got.values()) == pytest.approx(185e-6 - 3 * 26.5e-6)
    inside = sum(v for k, v in want_us.items() if k != sp.OUTSIDE)
    assert r.idle_pct() == pytest.approx(100 * inside / 185)
    assert [k for k, _ in r.idle_by_span(top=2)] == [sp.OUTSIDE,
                                                     "search.results"]


def test_every_call_passes_both_clock_checks():
    r = sp.read(*_window())
    assert (r.checked, r.launch_ok, r.readback_ok, r.unplaced) == (3, 3, 3, 0)


def test_an_op_launched_outside_a_launch_span_fails_its_call():
    r = sp.read(*_window(stray=1))
    assert (r.checked, r.launch_ok, r.readback_ok) == (3, 2, 2)
    assert r.misplaced == {"search.results": 1}


def test_an_op_ending_after_the_readback_fails_its_call():
    r = sp.read(*_window(slow_copy=2))
    assert (r.checked, r.launch_ok, r.readback_ok) == (3, 3, 2)


def test_each_calls_device_drift_is_taken_out():
    still = sp.read(*_window())
    r = sp.read(*_window(drift=2_000))
    # calls 0, 1 and 2 run 2 us early, on time and 2 us late on the
    # device: the median call sets the level
    assert r.drift_us == pytest.approx(4.0) and still.drift_us == 0.0
    assert dict(r.idle_by_span(top=20)) == pytest.approx(
        dict(still.idle_by_span(top=20)))
    assert (r.launch_ok, r.readback_ok) == (3, 3)


def test_the_metrics_read_the_spans():
    r = sp.read(*_window())
    run = types.SimpleNamespace(spans=r, trace=None)
    got = {m: load_module("metrics", m).read(run) for m in METRICS}
    assert got["engine_prepare_ms"] == pytest.approx(0.007)
    assert got["engine_upload_ms"] == pytest.approx(0.002)
    assert got["engine_launch_ms"] == pytest.approx(0.005)
    assert got["engine_results_ms"] == pytest.approx(0.007)
    assert got["search_idle_pct"] == pytest.approx(r.idle_pct())


@pytest.mark.parametrize("name", METRICS)
def test_each_span_metric_reads_none_without_spans(name):
    """An untraced run, or a program that records no spans."""
    mod = load_module("metrics", name)
    assert mod.read(types.SimpleNamespace(trace=None)) is None
    assert mod.read(types.SimpleNamespace(trace=None, spans=None)) is None


def test_no_spans_no_reading():
    _, rec, trace, brackets = _window()
    assert sp.read([], rec, trace, brackets) is None
