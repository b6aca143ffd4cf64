"""The benchmark's arithmetic: percentiles, the roofline count and the
trace's reading."""

import numpy as np
import pytest

from benchlib import roofline, stats, trace as tr


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(3).exponential(size=257)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_roofline_counts_values_queries_and_votes_once():
    got = roofline.match_bytes(tracks=10_000, track_frames=937,
                               query_frames=94, coefs=2, batch=128)
    want = 4 * 2 * 10_000 * 937 + 4 * 2 * 128 * 94 + 4 * 128 * 10_000
    assert got == want == 80_176_256
    assert roofline.match_bound_ms(10_000, 937, 94, 2, 128) == \
        pytest.approx(want / 3.35e12 * 1e3)


def test_roofline_depends_on_shapes_only():
    a = roofline.match_bound_ms(10_000, 937, 94, 2, 4)
    assert a == roofline.match_bound_ms(10_000, 937, 94, 2, 4)
    assert roofline.match_bound_ms(20_000, 937, 94, 2, 4) > a


def _records(calls, prefilter=False, lost_head=0, lost_tail=0):
    recs, t = [], 0.0
    for _ in range(tr.LEAD_IN):
        recs.append(("spin_kernel", t, t + 1.0))
        t += 2
    recs.append(("spin_kernel", t, t + 500.0))
    t += 600
    for _ in range(calls):
        recs.append(("spin_kernel", t, t + 10.0))
        t += 50
        ops = [("Memcpy HtoD (Pageable -> Device)", 5),
               ("void mfcc_rows_fft_kernel<256>", 20),
               ("vectorized_elementwise_kernel", 3)]
        if prefilter:
            ops += [("bound_scan_planes_kernel", 4), ("bound_scan_kernel", 6),
                    ("kb_select_kernel", 7),
                    ("match_votes_aligned_group_kernel", 8),
                    ("Memcpy DtoH (Device -> Pageable)", 1)]
        ops += [("match_votes_aligned_group_kernel", 30),
                ("reduce_kernel", 4), ("Memcpy DtoH (Device -> Pageable)", 2)]
        for name, d in ops:
            recs.append((name, t, t + d))
            t += d + 10
        t += 100
    recs.append(("spin_kernel", t, t + 500.0))
    return recs[lost_head: len(recs) - lost_tail]


def test_trace_splits_calls_and_layers():
    layer_map = tr.load_layer_map()
    r = tr.read(_records(3), [1.0, 1.0, 1.0], layer_map)
    assert (len(r.calls), r.lead_lost, r.markers_lost) == (3, 0, 0)
    # the upload goes with the kernel it feeds, the steps between K1 and
    # the votes with the votes
    assert r.layer_ms("fingerprint") == pytest.approx(0.025)
    assert r.layer_ms("match") == pytest.approx(0.033)
    assert r.layer_ms("engine") == pytest.approx(0.006)
    assert r.layer_ms("prefilter") == 0.0
    assert r.calls[0].busy_ms == pytest.approx(0.064)
    assert 0 < r.busy_s < r.window_s


def test_trace_prefilter_scope_takes_its_candidate_kernels():
    r = tr.read(_records(2, prefilter=True), [1.0, 1.0], tr.load_layer_map())
    assert r.layer_ms("prefilter") == pytest.approx(0.029)
    assert r.layer_ms("match") == pytest.approx(0.030)


def test_trace_counts_records_lost_at_the_head():
    r = tr.read(_records(3, lost_head=tr.LEAD_IN + 2), [1.0, 2.0, 3.0],
                tr.load_layer_map())
    # the lead-in's long spin and the first call's marker are gone: the
    # markers that arrived are the last calls'
    assert r.lead_lost == tr.LEAD_IN + 1
    assert r.markers_lost == 1
    assert [c.wall_ms for c in r.calls] == [2.0, 3.0]


def test_trace_without_its_closing_spin_ends_with_its_last_record():
    whole = tr.read(_records(3), [1.0, 1.0, 1.0], tr.load_layer_map())
    r = tr.read(_records(3, lost_tail=1), [1.0, 1.0, 1.0],
                tr.load_layer_map())
    assert (len(r.calls), r.lead_lost, r.markers_lost) == (3, 0, 0)
    assert r.layer_ms("match") == whole.layer_ms("match")
    assert r.busy_s == whole.busy_s and 0 < r.window_s < whole.window_s


def test_idle_gaps_tell_the_host_work_apart():
    r = tr.read(_records(3), [1.0, 1.0, 1.0], tr.load_layer_map())
    gaps = dict(r.idle_gaps())
    # each call: 50 us from its marker to its first op, 10 us before each
    # later op; 100 us after the last op until the next marker
    assert gaps["from a call's start to its first device op"] == \
        pytest.approx(3 * 50e-6)
    assert gaps["from a call's last device op to the next call's start"] == \
        pytest.approx(2 * 110e-6)
    assert gaps["in a call, before reduce_kernel"] == pytest.approx(3 * 10e-6)
