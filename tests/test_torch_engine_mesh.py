"""The port's engine on a (db, batch) mesh against the JAX engine on one.

The same JAX-written checkpoint is restored by a JAX engine on a mesh of
``tests/conftest.py``'s 8 virtual devices, by the port's engine on a mesh of
8 CPU cells, and by the port's unsharded engine. The port fingerprints its
queries with the JAX function (fixture ``jax_query_fp``), so all three vote
bitwise-equal fingerprints and their TIR* must be equal exactly: dialplan,
strict bag, aligned and margin searches, the context filter, ranked top-k,
a G.711 wire query and the streaming scorer, at mesh shapes (8, 1), (4, 2),
(2, 4) and (1, 8). Live appends and deletes update the sharded views row by
row; the prefilters run per shard where their gates (counted per shard)
admit a view, with the adaptive gate's state following the JAX meshed
engine's; a meshed ``sync()`` equals an unsharded one.
"""

import jax
import numpy as np
import pytest
import torch

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.config import TiresiasConfig
from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu.ops import match_pallas as jmp
from tiresias_tpu.ops.mfcc_jax import fingerprint_padded_batch as jax_fp
from tiresias_tpu.ops.mfcc_jax import fingerprint_signal as jax_fp_signal
from tiresias_tpu.parallel import make_mesh as jax_make_mesh
from tiresias_tpu.parallel import sharding as jsh
from tiresias_tpu.serve import StreamingRecognizer as JaxStreaming
from tiresias_tpu.store import fingerprint_store as jfs
from tiresias_tpu.utils import g711
from tiresias_tpu.utils.audio import (
    float_to_i16,
    synth_chirp,
    synth_tone,
    write_wav,
)
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.api import engine as tengine
from tiresias_tpu_torch.config import TiresiasConfig as TorchConfig
from tiresias_tpu_torch.config import ContextConfig as TorchContext
from tiresias_tpu_torch.ops import match_kernels as tk
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.parallel import distributed as tdist
from tiresias_tpu_torch.parallel import make_mesh
from tiresias_tpu_torch.serve import StreamingRecognizer
from tiresias_tpu_torch.store import fingerprint_store as tfs

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

torch.set_num_threads(2)

SR = 8000
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
CONFIGS = {
    "dialplan": dict(tolerance=1.0),
    "bag": dict(coefs=2, tolerance=0.01, trunc_coef1=False),
    "filtered": dict(tolerance=1.0, filter_context=True),
    "aligned": dict(coefs=2, tolerance=0.05, trunc_coef1=False,
                    aligned=True),
    "margin": dict(coefs=2, tolerance=0.05, trunc_coef1=False,
                   aligned=True, min_margin=0.2),
}


def _clip(i: int, seconds: float = 1.0) -> np.ndarray:
    return (synth_tone(250 + 140 * i, seconds, SR) if i % 2
            else synth_chirp(200 + 90 * i, 900 + 150 * i, seconds, SR))


def _mesh(n_db, n_batch):
    return make_mesh(n_db, n_batch, devices=["cpu"] * (n_db * n_batch))


@pytest.fixture
def jax_query_fp(monkeypatch):
    """The port fingerprints its queries with the JAX function (as in
    tests/test_torch_engine.py), so every engine votes the same floats."""

    def fp(padded, samplerate, dsp, law=None, n_valid=None, device="cpu"):
        out = jax_fp(padded, samplerate, dsp, law=law, n_valid=n_valid)
        return torch.from_numpy(np.array(out)).to(device)

    monkeypatch.setattr(tengine, "fingerprint_padded_batch", fp)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A JAX-written checkpoint: 10 clips in context "m", a decoy in "x"."""
    data = tmp_path_factory.mktemp("mesh_corpus")
    eng = JaxTiresias(TiresiasConfig(data_dir=str(data)), restore=False)
    eng.create_context("m")
    for i in range(10):
        eng.add_audio_pcm("m", f"clip{i}", _clip(i), SR)
    eng.create_context("x")
    eng.add_audio_pcm("x", "decoy", synth_tone(390, 1.0, SR), SR)
    eng.close()
    return str(data)


class Trio:
    """The corpus restored read-only by the JAX meshed engine, the port's
    meshed engine and the port's unsharded engine."""

    def __init__(self, data: str, shape):
        self.jax = JaxTiresias(TiresiasConfig(data_dir=data), exclusive=False,
                               mesh=jax_make_mesh(*shape))
        self.mesh = Tiresias(TorchConfig(data_dir=data), exclusive=False,
                             mesh=_mesh(*shape))
        self.flat = Tiresias(TorchConfig(data_dir=data), exclusive=False,
                             device="cpu")

    def engines(self):
        return self.jax, self.mesh, self.flat

    def add(self, name: str, pcm: np.ndarray, context: str = "m") -> None:
        """The same fingerprint (JAX's) into all three stores."""
        fp = jax_fp_signal(pcm, SR, self.jax.config.dsp)
        for eng in self.engines():
            eng.store.add_audio(name, context, fp, "h" + name,
                                uuid="u-" + name)

    def close(self) -> None:
        for eng in self.engines():
            eng.close()


def _vars(results):
    return [r.to_channel_vars() for r in results]


def _ranked(results):
    return [(r.name, r.match_count) for r in results]


def _same_everywhere(trio, context, queries, **kw):
    got = [eng.search_pcm_batch(context, queries, SR, **kw)
           for eng in trio.engines()]
    assert _vars(got[1]) == _vars(got[0]), kw
    assert _vars(got[1]) == _vars(got[2]), kw
    return got[1]


@pytest.mark.parametrize("mesh_shape", SHAPES)
def test_sharded_engine_matches_jax_and_single(corpus, jax_query_fp,
                                               mesh_shape):
    trio = Trio(corpus, mesh_shape)
    try:
        (view,) = trio.mesh.store.search_views()
        assert view.db is None and len(view.shards) == mesh_shape[0]
        assert view.rows == 128 * mesh_shape[0]
        queries = [_clip(i, 0.7) for i in (1, 3, 5)] + [_clip(4, 0.6)]
        for name, kw in CONFIGS.items():
            res = _same_everywhere(trio, "m", queries, **kw)
            if name in ("bag", "aligned"):
                assert [r.name for r in res[:3]] == ["clip1", "clip3",
                                                     "clip5"], name
        for kw in (CONFIGS["dialplan"], CONFIGS["aligned"]):
            lists = [eng.search_pcm_topk("m", queries[3], SR, k=3, **kw)
                     for eng in trio.engines()]
            assert _ranked(lists[1]) == _ranked(lists[0]) == _ranked(
                lists[2]), kw
    finally:
        trio.close()


def test_auto_and_bad_meshes(tmp_path, monkeypatch):
    cfg = TorchConfig(data_dir=str(tmp_path))
    eng = Tiresias(cfg, restore=False, mesh="auto", device="cpu")
    assert eng.mesh is None  # one CPU cell: "auto" is no mesh
    eng.close()
    # 8 CPU cells: the counterpart of JAX's 8 virtual CPU devices
    monkeypatch.setattr(tdist, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 8)
    eng = Tiresias(cfg, restore=False, mesh="auto", device="cpu")
    assert eng.mesh is not None and eng.mesh.devices.size == 8
    assert eng.mesh.shape == {"db": 8, "batch": 1}
    assert eng.device == torch.device("cpu")
    eng.create_context("m")
    eng.add_audio_pcm("m", "t", synth_tone(440, 1.0, SR), SR)
    r = eng.search_pcm("m", synth_tone(440, 1.0, SR), SR, tolerance=1.0)
    assert r.found and r.name == "t"
    eng.close()
    for bad, err in ((object(), TypeError), ("everywhere", ValueError)):
        with pytest.raises(err, match="mesh"):
            Tiresias(cfg, restore=False, mesh=bad, device="cpu")
    # each failed construction released the data-dir lock
    Tiresias(cfg, restore=False, exclusive=True, device="cpu").close()


def test_streaming_over_sharded_engine(corpus, jax_query_fp):
    """The streaming scorer drives a meshed engine; its results equal the
    JAX scorer's over the JAX meshed engine."""
    trio = Trio(corpus, (4, 2))
    try:
        out = []
        for eng, cls in ((trio.mesh, StreamingRecognizer),
                         (trio.jax, JaxStreaming)):
            rec = cls(eng, samplerate=SR)
            for i in (0, 3, 6):
                rec.open(f"ch{i}", context="m", duration_ms=700, coefs=2,
                         tolerance=0.01, trunc_coef1=False)
                rec.push(f"ch{i}", _clip(i, 0.8))
            out.append(rec.process_ready())
        assert set(out[0]) == {"ch0", "ch3", "ch6"}
        for i in (0, 3, 6):
            assert out[0][f"ch{i}"].name == f"clip{i}"
            assert (out[0][f"ch{i}"].to_channel_vars()
                    == out[1][f"ch{i}"].to_channel_vars())
    finally:
        trio.close()


def test_live_append_and_delete_keep_views_sharded(corpus, jax_query_fp):
    """Appends and a delete after the first search update the sharded views
    row by row (a full build is forbidden), only the touched shards get new
    views, and the searches after them equal JAX's meshed engine and the
    port's unsharded one."""
    trio = Trio(corpus, (4, 2))
    try:
        _same_everywhere(trio, "m", [_clip(3, 0.7)], tolerance=1.0)
        for eng in (trio.mesh, trio.flat):
            eng.warm_search_maps()
        (old,) = trio.mesh.store.search_views()
        for i in range(10, 14):
            trio.add(f"clip{i}", synth_tone(250 + 140 * i, 1.0, SR))
        gone = next(e for e in trio.mesh.get_audios("m")
                    if e.name == "clip2")
        for eng in trio.engines():
            assert eng.delete_audio(gone.uuid)

        def no_rebuild(*a, **k):
            raise AssertionError("the update rebuilt a view in full")

        trio.mesh.store._build_view = no_rebuild
        (view,) = trio.mesh.store.search_views()
        del trio.mesh.store._build_view
        assert view.n_audios == old.n_audios + 4 and view.db is None
        # rows 0-14 all lie in shard 0: the other shards keep their views
        assert [s.view is o.view for s, o in zip(view.shards, old.shards)
                ] == [False, True, True, True]
        assert view.shards[0].view.value_map is not None  # carried
        queries = [_clip(i, 0.7) for i in (2, 11, 13)]
        for name in ("dialplan", "bag", "aligned"):
            res = _same_everywhere(trio, "m", queries, **CONFIGS[name])
            assert res[0].name != "clip2"
    finally:
        trio.close()


def test_sharded_engine_kernel_dispatch(corpus, jax_query_fp, monkeypatch):
    """Strict bag and aligned searches on a meshed engine vote through the
    per-shard kernels (K4, then K5), once per search."""
    calls = []
    real = tengine.sharded_votes_kernels

    def spy(*args, **kwargs):
        calls.append(args[7])  # aligned
        return real(*args, **kwargs)

    monkeypatch.setattr(tengine, "sharded_votes_kernels", spy)
    trio = Trio(corpus, (4, 2))
    try:
        queries = [_clip(i, 0.7) for i in (1, 3, 5)]
        for name in ("bag", "aligned"):
            _same_everywhere(trio, "m", queries, **CONFIGS[name])
        # the unsharded engine of the trio never reaches the sharded path
        assert calls == [False, True]
    finally:
        trio.close()


def _misses(eng) -> list:
    """The adaptive gate's state without the view gens (which are
    per-process counters): (mode, consecutive misses), oldest first."""
    return [(mode, n) for (_, mode), n in eng._pf_misses.items()]


def test_sharded_engine_prefilter_dispatch(corpus, jax_query_fp,
                                           monkeypatch):
    """Aligned and bag searches above the (cut) per-shard budget go through
    the per-shard certified prefilter and equal the JAX meshed engine's,
    context-filtered too, with the same adaptive-gate state; past the bound
    maps' saturation the gate skips the prefilter."""
    monkeypatch.setenv("TIRESIAS_SHARDED_PALLAS", "interpret")
    monkeypatch.setattr(jmp, "PREFILTER_K", 1)
    monkeypatch.setattr(tk, "PREFILTER_K", 1)
    # the port's engine selects PREFILTER_K candidates per shard; the JAX
    # engine's sharded prefilter takes its own default (1024) unless told,
    # so it is told the same budget and both certify alike
    real = jsh.sharded_aligned_prefiltered
    monkeypatch.setattr(jsh, "sharded_aligned_prefiltered",
                        lambda *a, **kw: real(*a, **{**kw, "k": 1}))
    trio = Trio(corpus, (4, 2))
    ran = {"calls": 0, "certified": 0}
    orig = trio.mesh._aligned_prefiltered

    def spy(*a, **k):
        ran["calls"] += 1
        out = orig(*a, **k)
        ran["certified"] += out is not None
        return out

    monkeypatch.setattr(trio.mesh, "_aligned_prefiltered", spy)
    try:
        queries = [_clip(i, 0.7) for i in (1, 3)]
        for name in ("aligned", "bag"):
            _same_everywhere(trio, "m", queries, **CONFIGS[name])
            assert _misses(trio.mesh) == _misses(trio.jax), name
        assert ran["calls"] == 2
        before = dict(ran)
        _same_everywhere(trio, "x", queries[:1], filter_context=True,
                         **CONFIGS["aligned"])
        assert ran["calls"] == before["calls"] + 1
        assert _misses(trio.mesh) == _misses(trio.jax)
        before = dict(ran)
        sat = dict(coefs=2, tolerance=1.0, trunc_coef1=False, aligned=True)
        _same_everywhere(trio, "m", queries[:1], **sat)
        assert ran["calls"] == before["calls"]  # the tolerance gate
    finally:
        trio.close()


def test_sharded_engine_lattice_prefilter_dispatch(corpus, jax_query_fp,
                                                   monkeypatch):
    """Dialplan searches above the (cut) per-shard budget go through the
    per-shard certified lattice prefilter, certified or not, equal to the
    JAX meshed engine's staged path, with the same adaptive-gate state."""
    monkeypatch.setattr(jml, "LATTICE_PREFILTER_K", 1)
    monkeypatch.setattr(tml, "LATTICE_PREFILTER_K", 1)
    trio = Trio(corpus, (4, 2))
    monkeypatch.setattr(trio.jax, "_fused_search_batch", lambda *a, **k: None)
    ran = {"n": 0}
    orig = trio.mesh._lattice_prefiltered

    def spy(*a, **k):
        ran["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(trio.mesh, "_lattice_prefiltered", spy)
    try:
        queries = [_clip(i, 0.7) for i in (1, 3)]
        for tol in (1.0, 0.01):
            _same_everywhere(trio, "m", queries, tolerance=tol)
            assert _misses(trio.mesh) == _misses(trio.jax), tol
        assert ran["n"] == 2
    finally:
        trio.close()


def test_sharded_engine_wire_law(corpus, jax_query_fp):
    """G.711 trunk bytes against a meshed engine: expanded on the device,
    equal to the JAX meshed engine's and to the linear search."""
    trio = Trio(corpus, (4, 2))
    try:
        wire = g711.encode_ulaw(float_to_i16(synth_chirp(380, 1170, 1.0, SR)))
        lin = g711.decode(wire, "ulaw")
        for name in ("dialplan", "bag", "aligned"):
            got = [eng.search_pcm("m", wire, SR, wire_law="ulaw",
                                  **CONFIGS[name]) for eng in trio.engines()]
            assert got[1].to_channel_vars() == got[0].to_channel_vars()
            assert got[1].to_channel_vars() == got[2].to_channel_vars()
            flat = trio.flat.search_pcm("m", lin, SR, **CONFIGS[name])
            assert got[1].to_channel_vars() == flat.to_channel_vars()
    finally:
        trio.close()


def test_autosplit_across_a_shard_edge(tmp_path, jax_query_fp, monkeypatch):
    """An auto-split audio whose segment rows lie in two shards: the
    dialplan map min-combines across the edge and the strict modes merge
    the segment votes after the gather, equal to the JAX meshed engine."""
    for mod in (jfs, tfs):
        monkeypatch.setattr(mod, "MAX_TIER_FRAMES", 128)
    data = str(tmp_path / "d")
    eng = JaxTiresias(TiresiasConfig(data_dir=data), restore=False)
    eng.create_context("m")
    rng = np.random.default_rng(5)
    for i in range(126):  # filler rows 0-125 of the 128-frame tier
        fp = rng.normal(-20.0, 10.0, (int(rng.integers(20, 120)), 13))
        eng.store.add_audio(f"n{i}", "m", fp.astype(np.float32), f"h{i}")
    chirp = synth_chirp(300, 1500, 12.0, SR)  # 375 frames: rows 126-128
    eng.add_audio_pcm("m", "long", chirp, SR)
    eng.close()
    trio = Trio(data, (8, 1))
    try:
        (view,) = trio.mesh.store.search_views()
        (long_rows,) = view.segments
        per = trio.mesh.store.shard_rows(view)
        assert {r // per for r in long_rows} == {0, 1}, long_rows
        queries = [chirp[SR:4 * SR], chirp[9 * SR:12 * SR]]
        for name in ("dialplan", "bag", "aligned"):
            res = _same_everywhere(trio, "m", queries, **CONFIGS[name])
            assert res[0].name == "long", name
    finally:
        trio.close()


class TestShardedIngest:
    def _media(self, tmp_path):
        media = tmp_path / "media"
        media.mkdir()
        for i in range(6):  # not a multiple of 8: the batch pads
            write_wav(str(media / f"m{i}.wav"), synth_tone(200 + 40 * i, 0.7,
                                                           SR), SR)
        return str(media)

    def test_sync_over_mesh_matches_unsharded(self, tmp_path):
        media = self._media(tmp_path)
        mesh = _mesh(4, 2)

        def cfg(name):
            return TorchConfig(contexts=(TorchContext("m", media),),
                               data_dir=str(tmp_path / name))

        eng_m = Tiresias(cfg("dm"), restore=False, mesh=mesh)
        assert eng_m._ingest_mesh() is mesh
        assert eng_m.sync().created == 6
        eng_s = Tiresias(cfg("ds"), restore=False, device="cpu")
        assert eng_s.sync().created == 6
        by_m = {e.name: e for e in eng_m.get_audios("m")}
        by_s = {e.name: e for e in eng_s.get_audios("m")}
        assert by_m.keys() == by_s.keys()
        for name, e in by_s.items():
            np.testing.assert_array_equal(
                eng_m.store.get_fingerprint(by_m[name].uuid),
                eng_s.store.get_fingerprint(e.uuid))
        fps = {n: eng_m.store.get_fingerprint(e.uuid) for n, e in by_m.items()}
        query = synth_tone(280, 0.7, SR)
        want = eng_s.search_pcm("m", query, SR, **CONFIGS["bag"])
        eng_m.close()
        eng_s.close()
        eng_r = Tiresias(cfg("dm"), mesh=mesh)  # restore under the mesh
        (view,) = eng_r.store.search_views()
        assert len(view.shards) == 4
        for e in eng_r.get_audios("m"):
            np.testing.assert_array_equal(eng_r.store.get_fingerprint(e.uuid),
                                          fps[e.name])
        r = eng_r.search_pcm("m", query, SR, **CONFIGS["bag"])
        assert r.name == "m2.wav"
        assert r.to_channel_vars() == {
            **want.to_channel_vars(), "TIRFILEUUID": r.uuid}
        eng_r.close()

    def test_multiprocess_mesh_ingests_locally(self, tmp_path, monkeypatch):
        """A mesh with cells of another rank must not take the sharded
        ingest path: host-local inputs cannot be split across ranks."""
        eng = Tiresias(TorchConfig(data_dir=str(tmp_path)), restore=False,
                       mesh=_mesh(4, 2))
        try:
            monkeypatch.setattr(type(eng.mesh), "is_multiprocess", True)
            assert eng._ingest_mesh() is None
        finally:
            eng.close()


def test_refresh_from_checkpoint_keeps_the_mesh(corpus, tmp_path):
    """A read-only replica on a mesh follows the owner's checkpoint into a
    meshed store."""
    import shutil

    data = str(tmp_path / "d")
    shutil.copytree(corpus, data)
    owner = Tiresias(TorchConfig(data_dir=data), device="cpu")
    replica = Tiresias(TorchConfig(data_dir=data), exclusive=False,
                       mesh=_mesh(2, 4))
    try:
        owner.add_audio_pcm("m", "late", synth_tone(1900, 1.0, SR), SR)
        owner.save()
        assert replica.refresh_from_checkpoint()
        assert replica.store.mesh is replica.mesh
        r = replica.search_pcm("m", synth_tone(1900, 1.0, SR), SR,
                               **CONFIGS["bag"])
        assert r.name == "late"
    finally:
        replica.close()
        owner.close()


def test_two_tiers_on_a_mesh(tmp_path, jax_query_fp):
    """Short and long clips in two frame tiers, each view sharded: the
    multi-view top-1 ranks by (votes, insertion seq) across the gathered
    views, equal to the JAX meshed engine's and the unsharded one's, top-k
    listings too."""
    data = str(tmp_path / "d")
    eng = JaxTiresias(TiresiasConfig(data_dir=data), restore=False)
    eng.create_context("m")
    for i in range(8):
        eng.add_audio_pcm("m", f"clip{i}", _clip(i, 1.0 if i % 3 else 5.0),
                          SR)
    eng.close()
    trio = Trio(data, (2, 4))
    try:
        views = trio.mesh.store.search_views()
        assert [v.tier_frames for v in views] == [128, 256]
        queries = [_clip(i, 0.7) for i in (0, 1, 3, 5)]
        for name, kw in CONFIGS.items():
            _same_everywhere(trio, "m", queries, **kw)
        for kw in (CONFIGS["bag"], CONFIGS["aligned"]):
            lists = [eng.search_pcm_topk("m", queries[0], SR, k=4, **kw)
                     for eng in trio.engines()]
            assert _ranked(lists[1]) == _ranked(lists[0]) == _ranked(
                lists[2]), kw
    finally:
        trio.close()
