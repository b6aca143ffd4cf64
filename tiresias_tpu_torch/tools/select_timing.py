"""K-b's shapes, bounds and timing, and a comparison of K-b in this checkout
with K-b in another one.

``chip_smoke.py``'s ``phase_select`` takes its shapes (:data:`SELECT_SHAPES`),
its kinds of bounds (:func:`select_bounds`) and its times (:func:`select_ms`)
from here, so the smoke run and a comparison measure alike. As a program it
times ``select_candidates`` of this checkout and, with ``--other DIR``, of
another checkout of the port (an earlier commit unpacked with ``git
archive``) on the same seeded bounds, in turns (other, this, this, other),
each run in a process of its own with that checkout first on ``sys.path``
(its kernels), this checkout's bounds and timing (loaded from their files),
after a second of matrix products (the card at its working clocks). Needs a
CUDA card.

    python -m tiresias_tpu_torch.tools.select_timing --other build/parent

``--cooperative`` also times this checkout's cooperative route (one CTA an
SM) at every shape where it fits and the plan takes another route. Prints the card (``nvidia-smi`` name and power limit), one line per shape
and kind with each run's device ms per call, and a JSON summary of the
medians as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

# K-b's shapes on the prefilters' paths: ([B, A], k)
SELECT_SHAPES = (((1, 1_000_000), 256), ((1, 100_096), 1024),
                 ((64, 10_112), 256), ((64, 10_112), 1024),
                 ((64, 100_096), 256), ((64, 100_096), 1024))

SELECT_KINDS = ("bounds", "heavy ties", "overflow", "spread", "wide",
                "extremes", "int32 range", "all -1", "few rows above -1")

# the kinds a comparison times
TIMED_KINDS = ("bounds", "spread", "overflow")


def select_bounds(kind: str, b: int, a: int, rng) -> np.ndarray:
    """Bounds [b, a] int32 of one kind: "bounds" as a 94-frame query's
    (most rows 0-23, a tail to 94, a tenth of the rows -1 outside the
    context), "heavy ties" (-1 to 2: the k-th value tied thousands of
    times), "overflow" ("bounds" with 1% of the rows at 2,044 to 2**31 - 1,
    past the kernel's value bins: its refinement passes), "spread" (-1 to
    94 uniform, 96 values), "wide" (0 to 10**6: more values than bins),
    "extremes" ("bounds" with 2% INT_MAX and 2% INT_MIN, tied at the
    threshold), "int32 range" (any int32), "all -1", "few rows above -1"
    (one row in 200 a bound)."""
    if kind == "heavy ties":
        return rng.integers(-1, 3, (b, a)).astype(np.int32)
    if kind == "spread":
        return rng.integers(-1, 95, (b, a)).astype(np.int32)
    if kind == "wide":
        return rng.integers(0, 10**6, (b, a), endpoint=True).astype(np.int32)
    if kind == "int32 range":
        return rng.integers(-2**31, 2**31 - 1, (b, a),
                            endpoint=True).astype(np.int32)
    x = rng.integers(0, 24, (b, a))
    tail = rng.random((b, a)) < 0.01
    x[tail] = rng.integers(24, 95, int(tail.sum()))
    x[rng.random((b, a)) < 0.1] = -1
    if kind == "overflow":
        big = rng.random((b, a)) < 0.01
        x[big] = rng.choice([2044, 2045, 3000, 2**31 - 1], int(big.sum()))
    elif kind == "extremes":
        m = rng.random((b, a))
        x[m < 0.02] = 2**31 - 1
        x[m > 0.98] = -2**31
    elif kind == "all -1":
        x[:] = -1
    elif kind == "few rows above -1":
        x[:, np.arange(a) % 200 != 0] = -1
    return x.astype(np.int32)


def select_ms(fn, timing, reps: int = 50) -> dict:
    """Device ms per call of ``fn`` (one ``select_candidates`` call) by two
    clocks of the ``timing`` module (``tiresias_tpu_torch.utils.timing``):
    torch.profiler's ``kb_select`` kernel time (``profiler_ms``, whole or
    read from the records that arrived; None where the profile recorded no
    device time) and CUDA events around
    each call with the host ahead (``events_ms``: the kernel, and anything
    else the call puts on the stream). ``ms`` is the higher. ``host_ms``:
    the host's time to enqueue one call (``reps`` calls on the host clock
    while a spin kernel keeps the card busy)."""
    import time

    import torch

    prof = timing.device_ms(fn, reps, names=("kb_select",))["kb_select"]
    ev = timing.events_ms(fn, reps)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms: longer than the enqueueing
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return {"ms": max(x for x in (prof, ev) if x is not None),
            "profiler_ms": prof, "events_ms": ev, "host_ms": host}


WORKER = r'''
import importlib.util, json, sys, time
import numpy as np
import torch
from tiresias_tpu_torch.ops import match_lattice as ml


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


shapes, kinds, here, force = json.loads(sys.argv[1])
st = load("select_timing_here",
          f"{here}/tiresias_tpu_torch/tools/select_timing.py")
timing = load("timing_here", f"{here}/tiresias_tpu_torch/utils/timing.py")
# a second of matrix products first, so the card runs at its working clocks
w = torch.randn((8192, 8192), device="cuda")
t_end = time.perf_counter() + 1.0
while time.perf_counter() < t_end:
    w = torch.tanh(w @ w)
torch.cuda.synchronize()
out = {}
for (b, a), k in shapes:
    for kind in kinds:
        rng = np.random.default_rng(a + b + len(kind))
        x = torch.from_numpy(st.select_bounds(kind, b, a, rng)).cuda()
        got = ml.select_candidates(x, k)
        want = ml.select_candidates_reference(x, k)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (b, a, k)
        out[f"[{b}, {a}] k={k} {kind}"] = st.select_ms(
            lambda: ml.select_candidates(x, k), timing)
        if not (force and hasattr(ml, "_select_launch")):
            continue
        # the cooperative route, where it fits and the plan takes another
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if sms // b < ml.SELECT_GRID_MIN_CTAS:
            continue
        plan = ml._select_slice_plan(a, sms // b, True)
        if not plan.resident or ml._device_plan(0, b, a)[0] == plan:
            continue
        words = ml.build.kernel_library().tiresias_select_scratch(
            b, plan.ctas, 1)
        got = ml._select_launch(x, k, plan, words)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (b, a, k)
        out[f"[{b}, {a}] k={k} {kind} cooperative"] = st.select_ms(
            lambda: ml._select_launch(x, k, plan, words), timing)
print(json.dumps(out))
'''


def run(root: str, here: str, cooperative: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run(
        [sys.executable, "-c", WORKER,
         json.dumps([SELECT_SHAPES, TIMED_KINDS, here, cooperative])],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the port")
    ap.add_argument("--cooperative", action="store_true",
                    help="also time the cooperative route at every shape "
                         "where it fits and the plan takes another")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    order = ([args.other, here, here, args.other] if args.other
             else [here, here])
    runs = [(root, run(root, here, args.cooperative)) for root in order]
    summary = {}
    for key in runs[-2][1]:
        line = {}
        for name, root in (("this", here), ("other", args.other)):
            if root is None:
                continue
            got = [r[key] for rr, r in runs if rr == root and key in r]
            if not got:
                continue
            line[name] = {c: statistics.median(g[c] for g in got)
                          for c in ("ms", "profiler_ms", "events_ms",
                                    "host_ms")
                          if None not in [g[c] for g in got]}
        summary[key] = line
        print(f"{key}: " + ", ".join(
            f"{os.path.basename(root.rstrip('/')) or root} {r[key]['ms']:.4f}"
            f" (profiler {r[key]['profiler_ms']}, events "
            f"{r[key]['events_ms']:.4f}, host {r[key]['host_ms']:.4f})"
            for root, r in runs if key in r), flush=True)
    print(json.dumps({"card": card, "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
