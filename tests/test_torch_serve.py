"""The port's streaming scorer (``tiresias_tpu_torch.serve.streaming``) on the
CPU: 128 concurrent channels, batched scoring.

The BASELINE #3/#5 scenario without a PBX: synthetic 8 kHz streams pushed in
20 ms frames (Asterisk's frame size), scored in batched device passes, with
the reference's duration/hangup semantics
(application_handler.c:60,165-176).
"""

import time

import numpy as np
import pytest
import torch

from tiresias_tpu_torch.api import STATUS_FOUND, STATUS_HANGUP, Tiresias
from tiresias_tpu_torch.config import ContextConfig, MatchConfig, TiresiasConfig
from tiresias_tpu_torch.serve import StreamingRecognizer
from tiresias_tpu_torch.utils.audio import synth_tone, write_wav

torch.set_num_threads(2)

SR = 8000
FRAME = SR // 50  # 20 ms


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    directory = tmp_path_factory.mktemp("serve_corpus")
    for i in range(8):
        write_wav(
            str(directory / f"tone{i}.wav"), synth_tone(300 + 200 * i, 1.0, SR), SR
        )
    cfg = TiresiasConfig(
        match=MatchConfig(coefs=2, tolerance=0.01, trunc_coef1=False),  # D8 mode
        contexts=(ContextConfig(name="media", directory=str(directory)),),
        data_dir=str(tmp_path_factory.mktemp("serve_data")),
    )
    eng = Tiresias(cfg, restore=False, device="cpu")
    assert eng.sync().created == 8
    return eng


class TestSingleChannel:
    def test_duration_gated_result(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("chan-1", context="media", duration_ms=1000)
        pcm = synth_tone(300, 1.2, SR)
        # push 0.5 s: not enough yet
        rec.push("chan-1", pcm[: SR // 2])
        assert rec.process_ready() == {}
        # push the rest: one result, channel closed
        rec.push("chan-1", pcm[SR // 2 :])
        results = rec.process_ready()
        assert set(results) == {"chan-1"}
        res = results["chan-1"]
        assert res.status == STATUS_FOUND and res.name == "tone0.wav"
        assert rec.n_channels == 0

    def test_hangup_before_duration(self, engine):
        # mid-record hangup → HANGUP, no search (application_handler.c:165-176)
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("chan-2", context="media", duration_ms=3000)
        rec.push("chan-2", synth_tone(500, 0.5, SR))
        res = rec.hangup("chan-2")
        assert res.status == STATUS_HANGUP
        assert res.frame_count == 0 and res.match_count == 0
        assert rec.process_ready() == {}

    def test_hangup_after_full_window_scores(self, engine):
        """A hangup racing the scorer tick must not discard a COMPLETE
        window: the reference searches once duration is reached, so a
        client that sends its last frame and immediately hangs up gets a
        real result, not HANGUP."""
        seen = {}
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open(
            "chan-h", context="media", duration_ms=1000,
            on_result=lambda cid, r: seen.setdefault(cid, r),
        )
        rec.push("chan-h", synth_tone(500, 1.0, SR))  # exactly one window
        res = rec.hangup("chan-h")  # no process_ready tick in between
        assert res.status == STATUS_FOUND and res.name == "tone1.wav"
        assert res.frame_count > 0
        assert seen["chan-h"].status == STATUS_FOUND
        assert rec.n_channels == 0 and rec.process_ready() == {}

    def test_zero_duration_uses_default(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("chan-3", context="media", duration_ms=0)
        assert rec._channels["chan-3"].duration_ms == 3000

    def test_callback_invoked(self, engine):
        seen = {}
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open(
            "chan-4", context="media", duration_ms=500,
            on_result=lambda cid, r: seen.setdefault(cid, r),
        )
        rec.push("chan-4", synth_tone(700, 0.6, SR))
        rec.process_ready()
        assert "chan-4" in seen and seen["chan-4"].name == "tone2.wav"


class TestManyChannels:
    def test_128_streams_recognized(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        n = 128
        tones = [300 + 200 * (i % 8) for i in range(n)]
        streams = [synth_tone(f, 1.1, SR) for f in tones]
        for i in range(n):
            rec.open(f"ch{i}", context="media", duration_ms=1000)
        # interleaved 20 ms frames, like a PBX would deliver
        offset = 0
        results = {}
        t0 = time.perf_counter()
        while offset < SR * 1.1:
            for i in range(n):
                rec.push(f"ch{i}", streams[i][offset : offset + FRAME])
            offset += FRAME
            results.update(rec.process_ready())
        elapsed = time.perf_counter() - t0
        assert len(results) == n
        for i in range(n):
            res = results[f"ch{i}"]
            assert res.status == STATUS_FOUND
            assert res.name == f"tone{i % 8}.wav", f"ch{i}: {res.name}"
        # loose real-time sanity: 128 x 1 s of audio in one batched pass
        # must beat 1x real time per channel even on CPU
        assert elapsed < 60.0, f"took {elapsed:.1f}s"

    def test_continuous_mode_slides(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("cont", context="media", duration_ms=250, continuous=True)
        rec.push("cont", synth_tone(300, 1.0, SR))
        first = rec.process_ready()
        assert first["cont"].status == STATUS_FOUND
        # channel stays open and a second window scores from the remainder
        assert rec.n_channels == 1
        second = rec.process_ready()
        assert second["cont"].status == STATUS_FOUND
        rec.close("cont")
        assert rec.n_channels == 0

    def test_continuous_overlapping_windows(self, engine):
        # duration 500 ms, hop 250 ms: after 1 s of audio the scorer emits
        # windows at 500/750/1000 ms — three results, not two tumbling ones
        rec = StreamingRecognizer(engine, samplerate=SR)
        seen = []
        rec.open(
            "ov", context="media", duration_ms=500, continuous=True,
            hop_ms=250, on_result=lambda cid, r: seen.append(r),
        )
        rec.push("ov", synth_tone(300, 1.0, SR))
        for _ in range(4):
            rec.process_ready()
        assert len(seen) == 3
        assert all(r.status == STATUS_FOUND and r.name == "tone0.wav"
                   for r in seen)
        rec.close("ov")

    def test_mixed_parameters_grouped(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("a", context="media", duration_ms=500)
        rec.open("b", context="media", duration_ms=500, tolerance=5.0, coefs=1)
        pcm = synth_tone(300, 0.6, SR)
        rec.push("a", pcm)
        rec.push("b", pcm)
        results = rec.process_ready()
        assert set(results) == {"a", "b"}
        assert results["a"].found


class TestInt16Streams:
    """Raw-telephony dtype handling: int16 frames stay int16 all the way
    into the engine (half the H2D bytes — the TCP wire format is int16),
    with bit-identical results to an eager float32 conversion because
    the device applies the same exact 1/32768 scaling
    (ops/mfcc.py to_float_pcm)."""

    @staticmethod
    def _as_i16(pcm):
        return np.clip(pcm * 32768.0, -32768, 32767).astype(np.int16)

    def test_int16_window_reaches_engine_unconverted(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        seen_dtypes = []
        orig = engine.search_pcm_batch

        def spy(context, pcms, *a, **kw):
            seen_dtypes.extend(p.dtype for p in pcms)
            return orig(context, pcms, *a, **kw)

        engine.search_pcm_batch = spy
        try:
            rec.open("i16", context="media", duration_ms=500)
            rec.push("i16", self._as_i16(synth_tone(300, 0.6, SR)))
            results = rec.process_ready()
        finally:
            engine.search_pcm_batch = orig
        assert results["i16"].status == STATUS_FOUND
        assert results["i16"].name == "tone0.wav"
        assert seen_dtypes and all(d == np.int16 for d in seen_dtypes)

    def test_int16_matches_float32_push_exactly(self, engine):
        pcm = synth_tone(700, 0.6, SR)  # tone2
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("f32", context="media", duration_ms=500)
        rec.open("i16", context="media", duration_ms=500)
        i16 = self._as_i16(pcm)
        rec.push("f32", i16.astype(np.float32) / 32768.0)
        rec.push("i16", i16)
        results = rec.process_ready()
        a, b = results["f32"], results["i16"]
        assert a.status == b.status == STATUS_FOUND
        assert (a.name, a.match_count, a.frame_count) == (
            b.name, b.match_count, b.frame_count)

    def test_mixed_dtype_channel_promotes_with_scaling(self, engine):
        # one channel fed int16 then float32 frames: the window must
        # promote the int16 part with the 1/32768 factor, not a raw cast
        pcm = synth_tone(300, 0.6, SR)
        half = len(pcm) // 2
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("mix", context="media", duration_ms=500)
        rec.push("mix", self._as_i16(pcm[:half]))
        rec.push("mix", pcm[half:].astype(np.float32))
        results = rec.process_ready()
        assert results["mix"].status == STATUS_FOUND
        assert results["mix"].name == "tone0.wav"

    def test_int16_hangup_flush(self, engine):
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("hf", context="media", duration_ms=500)
        rec.push("hf", self._as_i16(synth_tone(300, 0.6, SR)))
        res = rec.hangup("hf")
        assert res is not None and res.status == STATUS_FOUND
        assert res.name == "tone0.wav"

    def test_reused_push_buffer_is_not_aliased(self, engine):
        # a caller reusing ONE writable frame buffer across pushes must not
        # alias buffered chunks to the buffer's final contents
        pcm = self._as_i16(synth_tone(300, 0.6, SR))
        rec = StreamingRecognizer(engine, samplerate=SR)
        rec.open("reuse", context="media", duration_ms=500)
        frame = SR // 50
        buf = np.empty(frame, np.int16)
        for off in range(0, SR // 2 + frame, frame):
            chunk = pcm[off : off + frame]
            buf[: len(chunk)] = chunk
            rec.push("reuse", buf[: len(chunk)])
        buf[:] = 0  # aliased chunks would all become silence
        results = rec.process_ready()
        assert results["reuse"].status == STATUS_FOUND
        assert results["reuse"].name == "tone0.wav"


# ---- against the JAX package's scorer, and across threads -------------- #


def _speechlike(rng, seconds):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    vib = 1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 7) * t)
    sig = sum(
        rng.uniform(0.2, 1.0) / h
        * (1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
        * np.sin(2 * np.pi * f0 * h * vib * t)
        for h in range(1, 9)
    )
    sig = sig + 0.02 * rng.standard_normal(n)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _i16(pcm):
    return np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both packages' engines on one checkpoint the JAX engine wrote (so
    the stored fingerprints are bitwise equal), plus the tracks."""
    from tiresias_tpu.api import Tiresias as JaxTiresias
    from tiresias_tpu.config import TiresiasConfig as JaxConfig

    from tiresias_tpu.utils.g711 import encode

    rng = np.random.default_rng(31)
    data = str(tmp_path_factory.mktemp("pair"))
    # 16-bit tracks, as a WAV directory would hold them: stored audio and
    # live queries pass through the same quantization (its noise fills the
    # empty mel bands)
    tracks = [_i16(_speechlike(rng, s)).astype(np.float32) / 32768.0
              for s in (3.0, 4.0, 6.0, 3.5, 7.0)]
    jeng = JaxTiresias(JaxConfig(data_dir=data), restore=False)
    jeng.create_context("m")
    for i, pcm in enumerate(tracks):
        jeng.add_audio_pcm("m", f"t{i}", pcm, SR)
    # two tracks recorded off a G.711 trunk, stored from their codes
    for i, law in ((4, "ulaw"), (0, "alaw")):
        jeng.add_audio_pcm("m", f"t{i}-{law}", encode(tracks[i], law), SR,
                           wire_law=law)
    jeng.close()
    jeng = JaxTiresias(JaxConfig(data_dir=data), exclusive=False)
    teng = Tiresias(TiresiasConfig(data_dir=data), exclusive=False,
                    device="cpu")
    return jeng, teng, tracks


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function: equal
    query and stored fingerprints in both engines, so TIR* must be equal
    exactly (the port's own fingerprints are held to JAX's elsewhere)."""
    from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
    from tiresias_tpu_torch.api import engine as tengine

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


def _tir(result):
    return dict(result.to_channel_vars(), window=result.window)


def test_same_pushes_through_both_scorers_give_equal_windows(
        pair, jax_query_fp):
    """A seeded set of channels — one-shot and continuous, int16, float32
    and G.711, dialplan, strict and aligned parameters, a hangup before
    and after the duration — pushed in 20 ms frames through both packages'
    StreamingRecognizer: equal TIR* for every window of every channel."""
    from tiresias_tpu.serve import StreamingRecognizer as JaxRecognizer
    from tiresias_tpu.utils.g711 import encode

    jeng, teng, tracks = pair
    rng = np.random.default_rng(32)
    opens = {
        "dial": dict(duration_ms=1000, tolerance=1.0),
        "dial-f32": dict(duration_ms=1000, tolerance=1.0),
        "strict": dict(duration_ms=1500, coefs=2, trunc_coef1=False,
                       tolerance=0.1),
        "aligned": dict(duration_ms=1500, coefs=2, trunc_coef1=False,
                        aligned=True, tolerance=0.1, min_margin=0.1),
        "ulaw": dict(duration_ms=1000, coefs=2, trunc_coef1=False,
                     aligned=True, tolerance=0.1, law="ulaw"),
        "alaw": dict(duration_ms=1000, coefs=2, trunc_coef1=False,
                     tolerance=0.1, law="alaw"),
        "cont": dict(duration_ms=500, tolerance=1.0, continuous=True),
        "slide": dict(duration_ms=500, tolerance=1.0, continuous=True,
                      hop_ms=250),
        "ctx": dict(duration_ms=1000, tolerance=1.0, context="other",
                    filter_context=True),
        "early": dict(duration_ms=3000, tolerance=1.0),
        "noise": dict(duration_ms=1000, coefs=2, trunc_coef1=False,
                      aligned=True, tolerance=0.1),
    }
    feeds = {}
    for i, cid in enumerate(opens):
        pcm = tracks[0 if cid == "dial-f32" else i % len(tracks)][
            4096 : 4096 + 2 * SR]  # hop-aligned: frames line up
        if cid == "noise":
            pcm = (0.2 * rng.standard_normal(2 * SR)).astype(np.float32)
        law = opens[cid].get("law")
        feeds[cid] = (encode(pcm, law) if law
                      else pcm if cid == "dial-f32" else _i16(pcm))
    seen = {"jax": {}, "torch": {}}
    recs = {"jax": JaxRecognizer(jeng, samplerate=SR),
            "torch": StreamingRecognizer(teng, samplerate=SR)}
    for side, rec in recs.items():
        for cid, kw in opens.items():
            rec.open(cid, **{"context": "m", **kw},
                     on_result=lambda c, r, side=side: seen[side].setdefault(
                         c, []).append(_tir(r)))
        for off in range(0, 2 * SR, FRAME):
            for cid in opens:
                if cid == "early" and off >= SR:
                    continue
                rec.push(cid, feeds[cid][off : off + FRAME])
            if off == SR:
                assert rec.hangup("early").status == STATUS_HANGUP
            if off % (10 * FRAME) == 0:
                rec.process_ready()
        rec.process_ready()
        rec.hangup("cont")
        rec.hangup("slide")
    assert seen["torch"] == seen["jax"]
    got = seen["torch"]
    assert set(got) == set(opens)
    assert got["dial"][0]["TIRSTATUS"] == STATUS_FOUND
    assert got["dial"] == got["dial-f32"]
    assert got["aligned"][0]["TIRFILENAME"] == "t3"
    assert got["ulaw"][0]["TIRFILENAME"] == "t4-ulaw"
    assert got["alaw"][0]["TIRFILENAME"] == "t0-alaw"
    assert int(got["noise"][0]["TIRMATCHCOUNT"]) < 8  # no track, few votes
    assert got["ctx"][0]["TIRSTATUS"] == "NOTFOUND"
    assert got["early"] == [dict(TIRSTATUS="HANGUP", TIRFRAMECOUNT="0",
                                 TIRMATCHCOUNT="0", window=0)]
    assert [w["window"] for w in got["cont"][:4]] == [0, 1, 2, 3]
    assert len(got["slide"]) >= 6
    assert [w["window"] for w in got["slide"]] == list(range(len(got["slide"])))


def test_group_of_five_equals_the_same_five_among_eight(pair):
    """The scorer sends a group as it is (no padding to a batch bucket):
    five channels scored alone answer what the same five answer when
    three more share their pass — and what the direct batch search says."""
    _, teng, tracks = pair
    rng = np.random.default_rng(33)
    windows = [_i16(tracks[i % 5][8192 + 256 * i : 8192 + SR + 256 * i])
               for i in range(7)]
    windows.append(_i16(0.2 * rng.standard_normal(SR)))
    sizes = []
    orig = teng.search_pcm_batch

    def spy(context, pcms, *a, **kw):
        sizes.append(len(pcms))
        return orig(context, pcms, *a, **kw)

    teng.search_pcm_batch = spy
    try:
        answers = []
        for n in (5, 8):
            rec = StreamingRecognizer(teng, samplerate=SR)
            for i in range(n):
                rec.open(f"c{i}", context="m", duration_ms=1000,
                         coefs=2, trunc_coef1=False, aligned=True,
                         tolerance=0.1)
                rec.push(f"c{i}", windows[i])
            answers.append(rec.process_ready())
    finally:
        teng.search_pcm_batch = orig
    assert sizes == [5, 8]  # the groups went as they were
    five, eight = answers
    assert set(five) == {f"c{i}" for i in range(5)} and len(eight) == 8
    for cid, res in five.items():
        assert res == eight[cid]
    direct = teng.search_pcm_batch(
        "m", windows, SR, coefs=2, trunc_coef1=False, aligned=True,
        tolerance=0.1)
    assert [eight[f"c{i}"].to_channel_vars() for i in range(8)] == [
        r.to_channel_vars() for r in direct]
    assert sum(r.found for r in direct) >= 5


def test_searches_on_four_threads_while_a_fifth_mutates(tmp_path):
    """Four threads call search_pcm_batch while a fifth adds and deletes
    one audio over and over. Every result must be one that the catalog
    without the audio, or with it, explains — never a half-built view, a
    stale tombstone or an exception."""
    import threading

    rng = np.random.default_rng(34)
    eng = Tiresias(
        TiresiasConfig(
            data_dir=str(tmp_path),
            match=MatchConfig(coefs=2, tolerance=0.1, trunc_coef1=False,
                              aligned=True),
        ),
        restore=False, device="cpu",
    )
    eng.create_context("m")
    base = [_i16(_speechlike(rng, 3.0)).astype(np.float32) / 32768.0
            for _ in range(5)]
    extra = base.pop()
    for i, pcm in enumerate(base):
        eng.add_audio_pcm("m", f"base{i}", pcm, SR)
    queries = [_i16(p[4096 : 4096 + SR]) for p in base + [extra]]
    without = [r.to_channel_vars() for r in
               eng.search_pcm_batch(None, queries, SR)]
    entry = eng.add_audio_pcm("m", "extra", extra, SR)
    with_extra = [r.to_channel_vars() for r in
                  eng.search_pcm_batch(None, queries, SR)]
    eng.delete_audio(entry.uuid)
    assert without[4].get("TIRFILENAME") != "extra"
    assert with_extra[4]["TIRFILENAME"] == "extra"
    assert all(w["TIRSTATUS"] == STATUS_FOUND for w in without[:4])
    assert without[:4] == with_extra[:4]

    stop = threading.Event()
    errors, seen = [], []

    def mutate():
        try:
            while not stop.is_set():
                e = eng.add_audio_pcm("m", "extra", extra, SR)
                eng.warm_search_maps()
                eng.delete_audio(e.uuid)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    def search():
        try:
            for _ in range(12):
                got = eng.search_pcm_batch(None, queries, SR)
                seen.append([r.to_channel_vars() for r in got])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    mutator = threading.Thread(target=mutate)
    searchers = [threading.Thread(target=search) for _ in range(4)]
    mutator.start()
    for t in searchers:
        t.start()
    for t in searchers:
        t.join(120)
    stop.set()
    mutator.join(60)
    assert not errors, errors
    assert len(seen) == 48
    def no_uuid(tir):
        # the uuid of "extra" changes with every re-add
        return {k: v for k, v in tir.items() if k != "TIRFILEUUID"}

    for got in seen:
        assert got[:4] == without[:4]
        assert no_uuid(got[4]) in (no_uuid(without[4]),
                                   no_uuid(with_extra[4]))
    eng.close()
