"""On the card: a tiny cell runs through the kernels, correct, and its
traced run reads every per-layer metric (skips without a card)."""

from benchlib.runner import run_cell
from conftest import BIG_SEED, tiny


def test_a_tiny_traced_run_on_the_card(cuda_card):
    c = tiny("aligned-10k-b128", tracks=64)
    out = run_cell(c, BIG_SEED, 1.0, True, device=str(cuda_card))
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in c.per_layer}
    assert out["metrics"]["match_device_ms"]["value"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"]
