"""The benchmark's own tests: CPU, tiny sizes. Run from the repository's
root: ``python -m pytest benchmark/tests -q``."""

import copy
import dataclasses
import os
import sys

import pytest
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

# one CPU thread, as a run has: the generator's draws on the CPU come out
# the same each time only on one
torch.set_num_threads(1)

# a seed past 32 signed bits: the benchmark takes any such seed
BIG_SEED = 2**31 + 12_345


def tiny(name: str, tracks: int = 40, batch: int | None = None):
    """The cell ``name`` cut to a size a CPU test run holds: 40 tracks of 4
    s, a pool of 24 windows, 12 windows checked."""
    from benchlib import cell as cells

    c = cells.load(name, ROOT)
    cfg, mix, own = (copy.deepcopy(c.config), copy.deepcopy(c.traffic),
                     copy.deepcopy(c.own))
    cfg["catalog"].update(tracks=tracks, track_seconds=4.0, batch=16)
    mix.update(pool=24, warmup_calls=2,
               batch=batch or min(int(mix["batch"]), 8))
    own["check"]["windows"] = 12
    return dataclasses.replace(c, config=cfg, traffic=mix, own=own)


@pytest.fixture
def cuda_card():
    """Skips a test that needs an NVIDIA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda:0")
