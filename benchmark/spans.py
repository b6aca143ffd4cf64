"""Run one cell's window with the program's spans recorded, and print one
line that reads them on the device trace's clock.

    python benchmark/spans.py --workload <cell> --seed <n> --seconds <s> \
        [--overhead 0|1]

From the root of a checkout, on the cell's NVIDIA cards, like ``run.py``.
With ``--overhead 0`` the run is ``run.py``'s traced run (``--trace 1``)
with the program's span recording on over its window: the line holds that
run's result line under ``result``, and under ``spans`` the readings of
``benchlib/spans.py``: the five span metrics of ``metrics/``, the clock's
offset and residual, the share of calls that pass the two clock checks,
``idle_by_span``, K5's work items a call by route and the prefilter gate's
counts. With ``--overhead 1`` the run is the untraced one, with recording
turned on and off every ``BLOCK`` calls of its window: the line holds each
half's call times.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)

import run as bench_run  # noqa: E402  (sets the environment run.py sets)

BLOCK = 16
METRICS = ("engine_prepare_ms", "engine_upload_ms", "engine_launch_ms",
           "engine_results_ms", "search_idle_pct")
GATE = ("search.prefilter_admitted", "search.prefilter_refused",
        "search.prefilter_fallbacks")


class Window:
    """Wraps the search call that ``run_cell`` drives: counts the warm-up
    calls, and from the end of the last one records spans (``overhead``:
    in alternate blocks of ``BLOCK`` calls, timing each call)."""

    def __init__(self, warmup_calls: int, overhead: bool, device):
        self.warmup, self.overhead, self.device = (warmup_calls, overhead,
                                                   device)
        self.n = 0
        self.call_s = {True: [], False: []}
        self.blocks = []  # (block, recording, call s)
        self.brackets = []  # host ns around each calibration call
        self.routes0 = self.counters0 = None

    def __call__(self, search):
        import torch

        from tiresias_tpu_torch.ops.match_kernels import route_counts
        from tiresias_tpu_torch.utils import tracing

        self.stream = torch.cuda.current_stream(self.device)

        def wrapped(windows):
            k = self.n - self.warmup  # the window's call index
            self.n += 1
            if k < 0:
                out = search(windows)
                if k == -1:  # the last warm-up call: the window comes next
                    self.routes0 = route_counts(self.device).clone()
                    self.counters0 = dict(tracing.metrics.counters)
                    if not self.overhead:
                        tracing.start()
                return out
            if not self.overhead:
                # a host call the profile records, between two readings of
                # the host's clock: it ties the two clocks together
                before = time.perf_counter_ns()
                self.stream.query()
                self.brackets.append((before, time.perf_counter_ns()))
                return search(windows)
            on = (k // BLOCK) % 2 == 1
            if k % BLOCK == 0 and on:
                tracing.start()
            elif k % BLOCK == 0:
                tracing.stop()
            t = time.perf_counter()
            out = search(windows)
            self.call_s[on].append(time.perf_counter() - t)
            self.blocks.append((k // BLOCK, on, self.call_s[on][-1]))
            return out

        return wrapped

    def counts(self, calls: int) -> dict:
        from tiresias_tpu_torch.ops.match_kernels import route_counts
        from tiresias_tpu_torch.utils.tracing import metrics
        from benchlib.spans import ROUTES

        routes = (route_counts(self.device) - self.routes0).tolist()
        return {
            "match_routes": [[name, n / calls]
                             for name, n in zip(ROUTES, routes)],
            "gate": {k: metrics.counters.get(k, 0) - self.counters0.get(k, 0)
                     for k in GATE},
        }


def block_means(blocks) -> list:
    """``[block, recording, mean call ms]`` of each block of the window."""
    by: dict = {}
    for b, on, s in blocks:
        by.setdefault((b, on), []).append(s)
    return [[b, on, 1e3 * sum(v) / len(v)] for (b, on), v in by.items()]


def root_gaps(spans) -> dict:
    """The median over calls of the root span's self time in each of its
    gaps, named by the child span that ends before it (``start`` for the
    first)."""
    from benchlib.stats import percentile

    kids: dict = {}
    for s in spans:
        if s.parent is not None and s.parent == s.root:
            kids.setdefault(s.root, []).append(s)
    by: dict = {}
    for r in spans:
        if r.parent is not None or r.id not in kids:
            continue
        cur, after = r.start_ns, "start"
        gaps: dict = {}
        for c in sorted(kids[r.id], key=lambda c: c.start_ns):
            gaps[after] = gaps.get(after, 0) + c.start_ns - cur
            cur, after = c.end_ns, c.name
        gaps[after] = gaps.get(after, 0) + r.end_ns - cur
        for k, v in gaps.items():
            by.setdefault(k, []).append(v / 1e3)
    return {k: percentile(v, 50) for k, v in by.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--overhead", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from benchlib import cell as cells, spans as sp, trace as tr
    from benchlib.runner import run_cell, say
    from tiresias_tpu_torch.utils import tracing

    cell = cells.load(args.workload, bench_run.ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"no result: {args.workload} needs {cell.chips} CUDA card(s)")
        return 2
    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    win = Window(int(cell.traffic["warmup_calls"]), bool(args.overhead), dev)
    got = {}
    reads = (tr.device_records, tr.read)

    def device_records(prof):
        got["records"] = sp.profile_records(prof)
        return reads[0](prof)

    def read(*a):
        got["trace"] = reads[1](*a)
        return got["trace"]

    tr.device_records, tr.read = device_records, read
    try:
        out = run_cell(cell, args.seed, args.seconds, not args.overhead,
                       device="cuda:0", t_start=T_START, fault=win)
    finally:
        tr.device_records, tr.read = reads
        spans = tracing.stop()
    calls = win.n - win.warmup
    line = {"result": out}
    if args.overhead:
        off, on = (sorted(win.call_s[x]) for x in (False, True))
        mean = {k: sum(v) / len(v) for k, v in (("off", off), ("on", on))}
        line["overhead"] = {
            "calls_off": len(off), "calls_on": len(on),
            "mean_ms_off": mean["off"] * 1e3, "mean_ms_on": mean["on"] * 1e3,
            "median_ms_off": off[len(off) // 2] * 1e3,
            "median_ms_on": on[len(on) // 2] * 1e3,
            "on_cost_pct": 100.0 * (mean["on"] / mean["off"] - 1.0),
            "block_means_ms": block_means(win.blocks),
        }
    else:
        reading = sp.read(spans, got["records"], got["trace"], win.brackets)
        if reading is None:
            say("no result: the window's spans or calibration calls are "
                "missing")
            return 1
        run = types.SimpleNamespace(spans=reading)
        c = reading.clock
        line["spans"] = {
            "metrics": {m: cells.load_module("metrics", m).read(run)
                        for m in METRICS},
            "clock": {"offset_ns": c.offset_ns, "residual_us": c.residual_us,
                      "calls": c.calls, "device_drift_us": reading.drift_us},
            "misplaced_ops": reading.misplaced,
            "root_self_us_p50_by_place": root_gaps(spans),
            "calls": len(reading.calls),
            "checked_calls": reading.checked,
            "launch_ok_pct": 100.0 * reading.launch_ok / reading.checked,
            "readback_ok_pct": 100.0 * reading.readback_ok / reading.checked,
            "unplaced_ops": reading.unplaced,
            "root_self_ms_p50": reading.median_ms(sp.ROOT),
            "self_ms_p50": {n: reading.median_ms(n) for n in sorted(
                {k for call in reading.calls for k in call})},
            "idle_by_span": reading.idle_by_span(),
            "spans_kept": len(spans),
        }
    line["spans_counts"] = win.counts(calls)
    say(f"[spans] {calls} window calls; gate {line['spans_counts']['gate']}; "
        f"route items a call {line['spans_counts']['match_routes']}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
