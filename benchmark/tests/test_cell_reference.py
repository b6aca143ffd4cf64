"""The plain reference against known answers: the repository's frozen
aubio-parity MFCC goldens, the G.711 code points, votes worked by hand; and
against the program's own plain twins at a small size."""

import os

import numpy as np
import pytest
import torch

from benchlib.g711 import encode_ulaw
from conftest import BIG_SEED, ROOT, tiny
from reference import dsp, search
from reference.g711 import ulaw_table, ulaw_to_float

GOLDENS = os.path.join(ROOT, "tests", "goldens", "mfcc_goldens.npz")


def _tone(freq, seconds, sr, amp=0.5):
    t = np.arange(int(round(seconds * sr)), dtype=np.float64) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _noise(seconds, sr, amp=0.3, seed=0):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(int(round(seconds * sr)))).astype(
        np.float32)


def _chirp(f0, f1, seconds, sr, amp=0.5):
    t = np.arange(int(round(seconds * sr)), dtype=np.float64) / sr
    k = (f1 - f0) / seconds
    return (amp * np.sin(2 * np.pi * (f0 * t + 0.5 * k * t * t))).astype(
        np.float32)


# the goldens' corpus (tests/golden_corpus.py), written out again here
CASES = {
    "tone_440": (lambda: _tone(440.0, 1.7, 8000), 8000),
    "chirp": (lambda: _chirp(200.0, 3600.0, 2.0, 8000), 8000),
    "noise": (lambda: _noise(1.3, 8000, seed=7), 8000),
    "speechlike": (lambda: _tone(300.0, 1.0, 8000)
                   + 0.3 * _tone(2200.0, 1.0, 8000)
                   + _noise(1.0, 8000, amp=0.05, seed=3), 8000),
    "short_partial_hop": (lambda: _tone(600.0, 0.0801, 8000), 8000),
    "noise_44k": (lambda: _noise(0.5, 44100, seed=11), 44100),
}


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mel_log_dct_stages_equal_the_frozen_goldens(goldens, name):
    sr = CASES[name][1]
    mags = goldens[f"{name}/mags"]
    mels = mags @ dsp.mel_bank(40, 512, sr).astype(np.float64)
    np.testing.assert_allclose(mels, goldens[f"{name}/mels"], rtol=1e-6,
                               atol=1e-9)
    coefs = goldens[f"{name}/logmel"] @ dsp.dct_rows(40, 2).astype(np.float64)
    np.testing.assert_allclose(coefs, goldens[f"{name}/coefs"], rtol=1e-6,
                               atol=1e-7)


# broadband cases: a pure tone's far filters sit at the FFT's noise floor,
# where float32 (aubio's own, and this reference) is noise too
@pytest.mark.parametrize("name", ["noise", "noise_44k", "speechlike"])
def test_fingerprints_equal_the_frozen_goldens(goldens, name):
    make, sr = CASES[name]
    got = dsp.fingerprints(torch.from_numpy(make())[None], sr, 256, 512, 40,
                           2)[0].double().numpy()
    want = goldens[f"{name}/fp"]
    assert got.shape == want.shape
    # float32 against the float64 oracle: 1e-4 dB, the error scaled by |c|
    # where the coefficient is below 1 (10 log10|c| magnifies it there)
    err = np.abs(got - want) * np.minimum(1.0, 10.0 ** (want / 10.0))
    assert err.max() < 1e-4


def test_ulaw_code_points():
    t = ulaw_table()
    assert (t[0xFF], t[0x7F], t[0x00], t[0x80]) == (0, 0, -32124, 32124)
    assert (t[0xFE], t[0x7E]) == (8, -8)
    codes = torch.arange(256, dtype=torch.uint8)
    # every code's value compresses back to a code of the same value
    again = encode_ulaw(torch.from_numpy(t.copy()))
    assert (ulaw_table()[again.numpy()] == t).all()
    assert torch.equal(ulaw_to_float(codes) * 32768.0,
                       torch.from_numpy(t.astype(np.float32)))


def _db(rows):
    db = torch.tensor(rows, dtype=torch.float32)[..., None].repeat(1, 1, 2)
    return db, torch.ones(db.shape[:2], dtype=torch.bool)


def test_votes_worked_by_hand():
    q = torch.tensor([1.0, 2.0, 3.0])[:, None].repeat(1, 2)
    db, mask = _db([[0, 1, 2, 3, 9, 9],   # 1 2 3 at shift 1: 3 aligned
                    [3, 9, 2, 9, 1, 9],   # every frame somewhere, no shift
                    [9, 9, 9, 9, 9, 1.05]])
    bag = search.votes(q, db, mask, 0.1, 2, aligned=False)
    aligned = search.votes(q, db, mask, 0.1, 2, aligned=True)
    assert bag.tolist() == [3, 3, 1]
    assert aligned.tolist() == [3, 1, 1]
    mask[0, 1] = False  # a padded frame never votes
    assert search.votes(q, db, mask, 0.1, 2, aligned=True).tolist() == \
        [2, 1, 1]
    # the tolerance is inclusive, compared in float32
    assert search.votes(q, db, mask, 0.05, 2, aligned=True)[2] == 1
    assert search.votes(q, db, mask, 0.04, 2, aligned=True)[2] == 0


def test_top1_takes_the_lowest_row_among_equals():
    assert search.top1(torch.tensor([1, 4, 2, 4])) == (1, 4)
    assert search.top1(torch.tensor([0, 0])) == (-1, 0)


def test_the_programs_twins_agree_at_a_small_size():
    """The reference against the program's plain twins (the CPU routes of
    its kernels) on the same clips: fingerprints within float32 rounding,
    votes equal."""
    from benchlib.corpus import speechlike
    from tiresias_tpu_torch.config import DspConfig
    from tiresias_tpu_torch.ops.match import match_votes, prepare_query
    from tiresias_tpu_torch.ops.mfcc import fingerprint_padded_batch

    pcm = speechlike(6, 256 * 90, 8000, 77, "cpu")
    got = fingerprint_padded_batch(pcm, 8000, DspConfig(), device="cpu")
    want = dsp.fingerprints(pcm.float() / 32768.0, 8000, 256, 512, 40, 2)
    scale = torch.pow(10.0, want.double() / 10.0).clamp(max=1.0)
    assert float(((got - want).abs().double() * scale).max()) < 1e-4
    db, mask = want[1:], torch.ones(want[1:].shape[:2], dtype=torch.bool)
    query = want[0, 20:60]
    for aligned in (False, True):
        for tol in (0.1, 1.0):
            q, active, use2 = prepare_query(query[None], trunc_coef1=False)
            twin = match_votes(db, mask, q, active, use2, tol, coefs=2,
                               aligned=aligned)[0]
            ref = search.votes(query, db, mask, tol, 2, aligned)
            assert torch.equal(twin, ref)


def test_slack_bounds_the_votes():
    q = torch.tensor([1.0, 2.0])[:, None].repeat(1, 2)
    db, mask = _db([[1.1 + 2e-6, 2.1 - 2e-6, 9.0]])
    eq, ed = torch.full_like(q, 1e-5), torch.full_like(db, 1e-5)
    for aligned in (False, True):
        assert search.votes(q, db, mask, 0.1, 2, aligned).tolist() == [1]
        # frame 0's gap passes the tolerance by less than the slack
        assert search.votes(q, db, mask, 0.1, 2, aligned,
                            slack=(1.0, eq, ed)).tolist() == [2]
        # frame 1's falls short of it by less than the slack
        assert search.votes(q, db, mask, 0.1, 2, aligned,
                            slack=(-1.0, eq, ed)).tolist() == [0]


def test_rounding_allows_the_reference_answer_and_no_other():
    from benchlib import judge
    from benchlib.corpus import checksum

    c = tiny("aligned-10k-b128", tracks=16)
    cfg = c.config
    plan = c.generator.plan(c.traffic, cfg["catalog"],
                            judge.track_samples(cfg), 256, BIG_SEED)
    pcm = judge.catalog_batch(cfg, BIG_SEED, 0, "cpu")
    plan.take(0, pcm)
    pool = plan.finish("cpu")
    ref_cat = judge.reference_catalog(cfg, BIG_SEED, "cpu", [checksum(pcm)])
    codes = pool.codes[np.flatnonzero(pool.track >= 0)[:3]]
    rounding = judge.Rounding(cfg, ref_cat, 1e-4)
    loose = judge.Rounding(cfg, ref_cat, 1e6)
    for code, (status, row, votes, frames) in zip(
            codes, judge.reference_answers(cfg, ref_cat, codes)):
        assert status == judge.FOUND
        assert rounding.allows(code, (status, row, votes, frames))
        assert votes > 3
        assert not rounding.allows(code, (status, row, votes - 3, frames))
        assert not rounding.allows(code, (status, row, votes, frames + 1))
        assert not rounding.allows(code, (judge.NOTFOUND, -1, 0, frames))
        # fingerprints free to move that far may vote for anything
        assert loose.allows(code, (status, row, votes - 3, frames))
