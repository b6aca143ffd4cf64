"""The check's control: the plain reference put in the program's place,
computed one precision below the configuration's float32 (its two matrix
products on TF32-rounded operands, the fingerprint values it stores and
compares in bfloat16), and judged by the benchmark's own comparison against
the float32 reference. The control has to come out not
correct; its readings are the upper ends that the limits in
``workloads/<cell>.json`` were set under.

    python benchmark/control.py --workload <cell> --seeds 1,2,3

Runs at the cell's own size (on the card, where there is one): the
catalog, the pool and a seeded sample of the check's size, as a run makes
them. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [BENCH_DIR, ROOT]


# the control: the reference's products in TF32 and its values in bfloat16;
# "tf32" alone is read beside it (it moves the fingerprints, rarely an
# answer)
CONTROLS = ("tf32+bf16", "tf32")


def readings(cell, seed: int, device) -> dict:
    """The control's numbers, and its verdict under the cell's limits, for
    each of ``CONTROLS``."""
    import numpy as np

    from benchlib import judge
    from benchlib.corpus import checksum

    cfg, mix = cell.config, cell.traffic
    cat = cfg["catalog"]
    hop = int(cfg["dsp"]["hop_size"])
    plan = cell.generator.plan(mix, cat, judge.track_samples(cfg), hop, seed)
    sums = []
    for lo in range(0, int(cat["tracks"]), int(cat["batch"])):
        pcm = judge.catalog_batch(cfg, seed, lo, device)
        sums.append(checksum(pcm))
        plan.take(lo, pcm)
    pool = plan.finish(device)
    picks = judge.sample(len(pool.order), int(cell.own["check"]["windows"]),
                         seed)
    idx = np.sort(pool.order[picks])
    cats, answers = {}, {}
    for precision in ("float32",) + CONTROLS:
        cats[precision] = judge.reference_catalog(cfg, seed, device, sums,
                                                  precision)
        answers[precision] = judge.reference_answers(
            cfg, cats[precision], pool.codes[idx], precision)
    out = {"seed": seed}
    limits = cell.own["check"]["limits"]
    rounding = judge.Rounding(cfg, cats["float32"], limits["fp_err_db"])
    for precision in CONTROLS:
        values = {
            "fp_err_db": judge.fp_err_db(cats[precision].cpu().numpy(),
                                         cats["float32"]),
            "answer_mismatch_pct": judge.mismatches(
                answers[precision], answers["float32"],
                list(pool.codes[idx]), rounding)[0],
        }
        correct, checks = judge.verdict(values, limits)
        out[precision] = {"correct": correct, "checks": checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchlib import cell as cells

    cell = cells.load(args.workload, ROOT)
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
