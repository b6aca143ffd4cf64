"""K5's candidate form (the aligned prefilter's rescore) by how many queries
share each candidate row, in this checkout and in another one.

The store is synthetic, at the shape of ``chip_smoke.py``'s ``[prefilter]``
aligned cell: 100,096 rows x 1,024 frames x 2 coefficients, 938 live frames
a row, both coefficients drawn from N(0, 0.25) so that about 23% of
a row's frames lie in a query frame's band at tol 0.1 (the catalog's own
bands); 64 queries, each a 94-frame excerpt of a row in a 128-frame bucket
plus noise, made on the card from a seed. The candidate lists, 1,024 rows a
query:

- ``spread``: each query's own random rows (65,536 slots over 100,096 rows,
  about 0.65 queries a chosen row, as the cell's bound selection gives);
- ``s=1``, ``s=2``, ``s=4``, ``s=8``: groups of s queries on one list, the
  lists disjoint (every chosen row is held by exactly s queries);
- ``b1``: one query's random rows (batch 1).

Each list is timed on the auto route (and the forced routes ``dense`` and
``bits`` where a checkout has them) with torch.profiler's device clock,
after the auto route is checked int32-equal to the forced dense route. As a
program it runs this checkout and, with ``--other DIR``, another checkout
of the port (an earlier commit unpacked with ``git archive``) in turns
(other, this, this, other), each run in a process of its own with that
checkout first on ``sys.path`` (its kernels) and this checkout's timing
module. Needs a CUDA card.

    python -m tiresias_tpu_torch.tools.cand_timing --other build/parent

Prints the card (``nvidia-smi`` name and power limit), one line per list
and route with each run's device ms per call, and a JSON summary of the
medians as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

LISTS = ("spread", "s=1", "s=2", "s=4", "s=8", "b1")
ROUTES = ("auto", "dense", "bits")

WORKER = r'''
import importlib.util, json, sys, time
import torch
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_index as mi
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops.mfcc import PAD_VALUE


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lists, routes, here = json.loads(sys.argv[1])
timing = load("timing_here", f"{here}/tiresias_tpu_torch/utils/timing.py")
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(18)
rows, t, live, b, k, f, act_f = 100_096, 1024, 938, 64, 1024, 128, 94
db = torch.randn((rows, t, 2), generator=g, device=dev) * 0.25
db[:, live:] = PAD_VALUE
src = torch.randint(0, rows, (b,), generator=g, device=dev)
q = db[src, 100 : 100 + f].clone()
q += torch.randn(q.shape, generator=g, device=dev) * 0.02
n_frames = torch.full((b,), act_f, dtype=torch.int32).numpy()
qq, act, use2 = tm.prepare_query(q, n_frames, -1, -1, trunc_coef1=False)
index = mi.build_match_index(db)
perm = torch.randperm(rows, generator=g, device=dev)


def cand_of(name):
    if name == "spread":
        return torch.stack([torch.randperm(rows, generator=g, device=dev)[:k]
                            for _ in range(b)])
    if name == "b1":
        return torch.randperm(rows, generator=g, device=dev)[None, :k]
    s = int(name[2:])
    groups = perm[: (b // s) * k].reshape(b // s, k)
    return groups.repeat_interleave(s, dim=0)


# a second of matrix products first, so the card runs at its working clocks
w = torch.randn((8192, 8192), device=dev)
t_end = time.perf_counter() + 1.0
while time.perf_counter() < t_end:
    w = torch.tanh(w @ w)
torch.cuda.synchronize()
out = {}
for name in lists:
    cand = cand_of(name).to(torch.int32).contiguous()
    nb = cand.shape[0]
    args = (db, qq[:nb], act[:nb], use2[:nb], 0.1, cand, 2)
    want = tk.match_votes_cand(*args, index=index, route="dense",
                               aligned=True)
    got = tk.match_votes_cand(*args, index=index, aligned=True)
    assert torch.equal(got, want), name
    for r in routes:
        try:
            tk.match_votes_cand(*args, index=index, route=r, aligned=True)
        except ValueError:  # a route this checkout does not have
            continue
        out[f"{name} {r}"] = timing.device_ms(
            lambda: tk.match_votes_cand(*args, index=index, route=r,
                                        aligned=True), 10)
print(json.dumps(out))
'''


def run(root: str, here: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root))
    proc = subprocess.run(
        [sys.executable, "-c", WORKER, json.dumps([LISTS, ROUTES, here])],
        cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout of the port")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    order = ([args.other, here, here, args.other] if args.other
             else [here, here])
    runs = [(root, run(root, here)) for root in order]
    summary = {}
    for key in dict.fromkeys(k for _, r in runs for k in r):
        summary[key] = {
            name: statistics.median(r[key] for rr, r in runs
                                    if rr == root and key in r)
            for name, root in (("this", here), ("other", args.other))
            if root is not None and any(rr == root and key in r
                                        for rr, r in runs)}
        print(f"{key}: " + ", ".join(
            f"{os.path.basename(root.rstrip('/')) or root} {r[key]:.4f}"
            for root, r in runs if key in r), flush=True)
    print(json.dumps({"card": card, "ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
