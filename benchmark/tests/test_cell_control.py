"""The control, the reference in TF32 in the program's place, comes out
not correct under a cell's limits (tiny size, CPU)."""

from conftest import BIG_SEED, tiny


def test_the_tf32_control_fails():
    import control

    r = control.readings(tiny("aligned-10k-b128"), BIG_SEED, "cpu")
    for precision in control.CONTROLS:
        assert r[precision]["correct"] is False
        fp = r[precision]["checks"]["fp_err_db"]
        assert fp["value"] > fp["limit"]
    mism = r["tf32+bf16"]["checks"]["answer_mismatch_pct"]
    assert mism["value"] > mism["limit"]
