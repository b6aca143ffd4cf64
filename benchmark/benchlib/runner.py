"""One run of one cell: set-up, the measured window, the metrics and the
check.

Set-up makes the catalog on the device from the seed (speech-like tracks,
fingerprinted by the program's ``fingerprint_padded_batch`` and put in
through ``store.add_audio``), the traffic's pool of windows, the program's
per-view search data, and ``warmup_calls`` calls of the cell's own shape.
The window is a closed loop with one call in flight: one thread calls
``Tiresias.search_pcm_batch`` on the next ``batch`` windows of the pool as
soon as the last call returned, for ``seconds``; the window closes when the
last call begun inside it returns. Then the program's stored fingerprints
are read, its state is freed, and the reference judges (``judge.py``).
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import tempfile
import time
import types
from array import array

import numpy as np
import torch

from benchlib import judge, trace as tr
from benchlib.cell import Cell, load_module
from benchlib.corpus import checksum


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Answers:
    """The window's answers as numbers, so that no result object outlives
    its call: per window sent, the pool index, the status (``judge.FOUND``,
    ``judge.NOTFOUND``, ``judge.OTHER``), the track's row (-1 for none), the
    votes and the frame count."""

    CODES = {"FOUND": 1, "NOTFOUND": 0}

    def __init__(self, row_of: dict):
        self.row_of = row_of
        self.sent, self.status, self.row, self.votes, self.frames = (
            array("i") for _ in range(5))

    def add(self, idx, results) -> None:
        for i, r in zip(idx, results):
            self.sent.append(int(i))
            self.status.append(self.CODES.get(r.status, judge.OTHER))
            self.row.append(self.row_of.get(r.name, -1)
                            if r.status == "FOUND" else -1)
            self.votes.append(int(r.match_count))
            self.frames.append(int(r.frame_count))

    def __len__(self) -> int:
        return len(self.sent)

    def answer(self, k: int) -> tuple:
        return (self.status[k], self.row[k], self.votes[k], self.frames[k])


def _engine(config: dict, device):
    from tiresias_tpu_torch.api.engine import Tiresias
    from tiresias_tpu_torch.config import (DspConfig, MatchConfig,
                                           TiresiasConfig)

    m = config["match"]
    match = MatchConfig(
        tolerance=float(m["tolerance"]), coefs=int(m["coefs"]),
        freq_ignore_low=int(m["freq_ignore_low"]),
        freq_ignore_high=int(m["freq_ignore_high"]),
        trunc_coef1=bool(m["trunc_coef1"]), aligned=bool(m["aligned"]),
        min_margin=float(m["min_margin"]))
    # a read-only engine: it takes no lock and writes no checkpoint
    data_dir = os.path.join(tempfile.gettempdir(), "tiresias-benchmark")
    cfg = TiresiasConfig(dsp=DspConfig(**config["dsp"]), match=match,
                         data_dir=data_dir)
    return Tiresias(cfg, restore=False, exclusive=False, device=device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             fault=None) -> dict:
    """The result line's object. ``fault`` (tests only) wraps the search
    call the window drives."""
    from tiresias_tpu_torch.ops.mfcc import fingerprint_padded_batch
    from tiresias_tpu_torch.utils.tracing import metrics as counters

    t_start = time.perf_counter() if t_start is None else t_start
    cfg, mix = cell.config, cell.traffic
    cat = cfg["catalog"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    hop = int(cfg["dsp"]["hop_size"])
    sr = int(cat["samplerate"])
    ctx = cat["context"]
    batch = int(mix["batch"])

    eng = _engine(cfg, dev)
    eng.create_context(ctx)
    plan = cell.generator.plan(mix, cat, judge.track_samples(cfg), hop, seed)
    sums, entries = [], []
    t = time.perf_counter()
    for lo in range(0, int(cat["tracks"]), int(cat["batch"])):
        pcm = judge.catalog_batch(cfg, seed, lo, dev)
        sums.append(checksum(pcm))
        fps = fingerprint_padded_batch(pcm, sr, eng.config.dsp,
                                       device=dev).cpu().numpy()
        for j, fp in enumerate(fps):
            name = f"trk{lo + j:06d}"
            entries.append(eng.store.add_audio(name, ctx, fp, name))
        plan.take(lo, pcm)
        del pcm
    pool = plan.finish(dev)
    say(f"[setup] catalog {len(entries)} tracks and a pool of "
        f"{len(pool.order)} windows: {time.perf_counter() - t:.3f} s")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        # the peak from here is the system's, not the generator's
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    eng.warm_search_maps()
    say(f"[setup] search maps: {time.perf_counter() - t:.3f} s")

    def search(windows):
        return eng.search_pcm_batch(ctx, windows, sr, wire_law=mix["law"])

    if fault is not None:
        search = fault(search)
    cursor = [0]
    lanes = np.arange(batch)

    def next_idx():
        idx = pool.order[(cursor[0] + lanes) % len(pool.order)]
        cursor[0] += batch
        return idx

    t = time.perf_counter()
    for _ in range(int(mix["warmup_calls"])):
        search(pool.windows(next_idx()))
    if cuda:
        torch.cuda.synchronize(dev)
    say(f"[setup] {mix['warmup_calls']} warm-up calls: "
        f"{time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_start

    fallbacks0 = counters.counters.get("search.prefilter_fallbacks", 0)
    got = Answers({e.name: row for row, e in enumerate(entries)})
    starts, ends = array("d"), array("d")
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
    with prof:
        if trace:
            tr.lead_in()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            idx = next_idx()
            windows = pool.windows(idx)
            if trace:
                tr.mark_call()
            starts.append(time.perf_counter())
            res = search(windows)
            ends.append(time.perf_counter())
            got.add(idx, res)
        window_s = ends[-1] - t0
        if trace:
            tr.edge()
            torch.cuda.synchronize(dev)
    fallbacks = counters.counters.get("search.prefilter_fallbacks",
                                      0) - fallbacks0
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    call_ms = [(e - s) * 1e3 for s, e in zip(starts, ends)]
    quarters = np.histogram(np.asarray(ends) - t0, bins=4,
                            range=(0, window_s))[0] * batch / (window_s / 4)
    say(f"[window] {len(call_ms)} calls of {batch} windows in "
        f"{window_s:.3f} s; windows/s by quarter "
        f"{' '.join(f'{q:.1f}' for q in quarters)}; call ms p50 "
        f"{np.percentile(call_ms, 50):.3f} p95 {np.percentile(call_ms, 95):.3f}"
        f" max {max(call_ms):.3f}; prefilter fallbacks {fallbacks:g}")

    reading = None
    if trace:
        t = time.perf_counter()
        reading = tr.read(tr.device_records(prof), call_ms,
                          tr.load_layer_map())
        del prof
        say(f"[trace] {len(reading.calls)} calls traced, lead-in records "
            f"lost {reading.lead_lost}, call markers lost "
            f"{reading.markers_lost}; read in {time.perf_counter() - t:.3f} s")

    port_fps = np.stack([eng.store.get_fingerprint(e.uuid) for e in entries])
    del eng, entries
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_cat = judge.reference_catalog(cfg, seed, dev, sums)
    fp_err = judge.fp_err_db(port_fps, ref_cat)
    picks = judge.sample(len(got), int(cell.own["check"]["windows"]), seed)
    pool_idx = sorted({got.sent[k] for k in picks})
    want = dict(zip(pool_idx, judge.reference_answers(
        cfg, ref_cat, pool.codes[pool_idx])))
    limits = cell.own["check"]["limits"]
    mism, differ, wrong = judge.mismatches(
        [got.answer(k) for k in picks], [want[got.sent[k]] for k in picks],
        [pool.codes[got.sent[k]] for k in picks],
        judge.Rounding(cfg, ref_cat, limits["fp_err_db"]))
    correct, checks = judge.verdict(
        {"fp_err_db": fp_err, "answer_mismatch_pct": mism}, limits)
    say(f"[check] the reference over {len(pool_idx)} windows and "
        f"{ref_cat.shape[0]} tracks: {time.perf_counter() - t:.3f} s")
    say(f"[check] {len(differ)} sampled answers differ from the reference's, "
        f"{len(differ) - len(wrong)} of them within the fingerprints' "
        "rounding")
    for i in differ[:8]:
        k = picks[i]
        say(f"[check] window {got.sent[k]}: (status, row, votes, frames) "
            f"{got.answer(k)}, the reference's {want[got.sent[k]]}, "
            f"{'wrong' if i in wrong else 'within rounding'}")
    truth = [pool.track[got.sent[k]] for k in picks]
    answers = [want[got.sent[k]] for k in picks]
    say(f"[check] sampled answers: "
        f"{sum(a[0] == judge.FOUND for a in answers)}"
        f"/{len(picks)} FOUND by the reference; "
        f"{sum(a[1] == t for a, t in zip(answers, truth))} of "
        f"{sum(t >= 0 for t in truth)} excerpts name their own track; "
        f"{len({a[1] for a in answers})} distinct rows, "
        f"{len({a[2] for a in answers})} distinct vote counts, "
        f"{len({a[1:3] for a in answers})} distinct (row, votes)")

    run = types.SimpleNamespace(
        cell=cell, setup_s=setup_s, window_s=window_s, batch=batch,
        windows=len(got), call_ms=call_ms, trace=reading)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips, "memory_peak_bytes": peak,
    }
    out = {"correct": correct, "attempted": len(got), "failed": 0,
           "metrics": metrics, "device": device_info}
    if reading is not None:
        device_info["busy_s"] = reading.busy_s
        device_info["window_s"] = reading.window_s
        out["breakdown"] = {"device_ops": reading.device_ops(),
                            "idle_gaps": reading.idle_gaps()}
    out["checks"] = checks
    return out
