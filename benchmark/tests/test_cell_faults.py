"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, once for each fault the cells can have."""

import dataclasses

import pytest

from benchlib.runner import run_cell
from conftest import BIG_SEED, tiny


def altered(search):
    """An answer altered where it is produced: one vote more."""
    def call(windows):
        return [dataclasses.replace(r, match_count=r.match_count + 1)
                for r in search(windows)]
    return call


def half_left_out(search):
    """Half of the batch left out: the first half searched, its answers
    handed to the rest."""
    def call(windows):
        half = search(windows[: max(1, len(windows) // 2)])
        return (half * 2)[: len(windows)]
    return call


def state_unchanged(search):
    """A step that returns its state unchanged: every call answers with the
    answers of the call before it."""
    last = []

    def call(windows):
        res = search(windows)
        out = last[0] if last else res
        last[:] = [res]
        return out
    return call


# the cell's call at two batch sizes: below 8 the program's full scan runs
# as the grouped candidate form
@pytest.mark.parametrize("batch", [4, 8])
def test_a_sound_run_is_correct(batch):
    out = run_cell(tiny("aligned-10k-b128", batch=batch), BIG_SEED, 0.5,
                   False, device="cpu")
    assert out["correct"] is True
    assert out["checks"]["answer_mismatch_pct"]["value"] == 0.0


@pytest.mark.parametrize("fault", [altered, half_left_out, state_unchanged])
@pytest.mark.parametrize("batch", [4, 8])
def test_a_broken_timed_path_is_not_correct(batch, fault):
    out = run_cell(tiny("aligned-10k-b128", batch=batch), BIG_SEED, 0.5,
                   False, device="cpu", fault=fault)
    assert out["correct"] is False
    assert out["checks"]["answer_mismatch_pct"]["value"] > \
        out["checks"]["answer_mismatch_pct"]["limit"]
