"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA cards. The
cell, its configuration, its traffic and its metrics are found by name
(``BENCHMARK.json``; ``benchmark/configs``, ``traffic``, ``workloads``,
``metrics``). With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a torch.profiler
trace of the window. The last lines on standard error, and the last key of
the line (``checks``), give each number the check compared beside its
limit. Exits non-zero, printing no line, without the cards the cell needs,
or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# the program's kernel library and any compiler cache stay in the checkout,
# at fixed paths, so only a checkout's first run builds
BUILD = os.path.join(ROOT, "build")
os.environ["TIRESIAS_KERNEL_DIR"] = os.path.join(BUILD, "kernels")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(BUILD, "torch_kernels")
os.environ["USE_FLAX"] = "0"
# load from one process with few threads: no CPU thread pools beside the
# one thread that drives the card
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [BENCH_DIR, ROOT]

FORBIDDEN = ("jax", "jaxlib", "flax", "tiresias_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from benchlib import cell as cells
    from benchlib.runner import run_cell, say

    cell = cells.load(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"no result: {args.workload} needs {cell.chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.cuda.set_device(0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", t_start=T_START)
    found = forbidden_modules()
    if found:
        say(f"no result: the run loaded {', '.join(found)}")
        return 3
    for name, c in out["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
