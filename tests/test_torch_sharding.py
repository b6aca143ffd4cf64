"""The port's (db, batch) mesh against the JAX package's, on the CPU.

The JAX side runs as ``tests/test_sharding.py`` runs it, on
``tests/conftest.py``'s 8 virtual CPU devices (its per-shard Pallas kernels
in interpret mode); the port's mesh is 8 CPU cells, whose kernels are their
plain twins. Inputs come from numpy seeds. Votes must be int32-equal to
JAX's and to the port's unsharded kernels at mesh shapes (8, 1), (4, 2),
(2, 4) and (1, 8); the sharded prefilters equal the full scan where every
shard certifies and show a failing shard in its certificate column; the
sharded fingerprints lie within the float32 bound of JAX's and equal the
port's unsharded ones. A meshed store runs the mutation script of
``tests/test_torch_views.py`` beside a JAX meshed store, its shards
gathered bitwise equal to JAX's meshed views after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tiresias_tpu.config import DspConfig as JaxDspConfig
from tiresias_tpu.ops import match_jax
from tiresias_tpu.ops import match_lattice as jml
from tiresias_tpu.ops.mfcc_jax import (
    fingerprint_padded_batch as jax_fp_batch,
)
from tiresias_tpu.ops.mfcc_jax import fingerprint_signal as jax_fp_signal
from tiresias_tpu.parallel import make_mesh as jax_make_mesh
from tiresias_tpu.parallel import shard_db as jax_shard_db
from tiresias_tpu.parallel import sharded_search as jax_sharded_search
from tiresias_tpu.parallel import sharding as jsh
from tiresias_tpu.store import fingerprint_store as jfs
from tiresias_tpu.utils import g711 as jax_g711
from tiresias_tpu_torch.config import DspConfig
from tiresias_tpu_torch.ops import match as tm
from tiresias_tpu_torch.ops import match_lattice as tml
from tiresias_tpu_torch.ops.mfcc import (
    PAD_VALUE,
    fingerprint_padded_batch,
    fingerprint_signal,
    pad_frames_bucket,
)
from tiresias_tpu_torch.parallel import (
    make_mesh,
    shard_db,
    sharded_fingerprint,
    sharded_fingerprint_long,
    sharded_search,
    sharded_votes_kernels,
)
from tiresias_tpu_torch.parallel import sharding as tsh
from tiresias_tpu_torch.store import fingerprint_store as tfs

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

torch.set_num_threads(2)

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]
# the float32 bound between two fingerprint chains (PARITY.md section 2,
# tests/test_torch_mfcc.py)
FP_ATOL = 0.02


def _mesh(n_db, n_batch):
    return make_mesh(n_db, n_batch, devices=["cpu"] * (n_db * n_batch))


def _random_db(rng, n_audios=37, t=96, c=2):
    db = rng.uniform(-30, 25, size=(n_audios, t, c)).astype(np.float32)
    n_frames = rng.integers(8, t, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
    return db, mask


def _random_query(rng, b=5, f=48, c=2):
    q = rng.uniform(-30, 25, size=(b, f, c)).astype(np.float32)
    n_frames = rng.integers(4, f, size=b).astype(np.int32)
    return q, n_frames


def _port_votes(db, mask, q, n_frames, tol, **kw):
    """The port's unsharded plain votes (the kernels' twin)."""
    _, _, votes = tm.search_batch(torch.from_numpy(db), torch.from_numpy(mask),
                                  torch.from_numpy(q), n_frames,
                                  tolerance=tol, **kw)
    return votes.numpy()


class TestMesh:
    def test_shape_devices_and_rank_major_cells(self):
        mesh = _mesh(4, 2)
        assert mesh.shape == {"db": 4, "batch": 2}
        assert mesh.devices.shape == (4, 2) and mesh.devices.size == 8
        assert [(i, j) for i, j, _ in mesh.local_cells()] == [
            (i, j) for i in range(4) for j in range(2)]
        assert mesh.shard_slots() == [(i, torch.device("cpu"))
                                      for i in range(4)]
        # defaults and the error of the JAX make_mesh
        assert make_mesh(devices=["cpu"] * 8).shape == {"db": 8, "batch": 1}
        assert make_mesh(n_batch=4, devices=["cpu"] * 8).shape["db"] == 2
        assert make_mesh(n_db=2, devices=["cpu"] * 8).shape["batch"] == 4
        with pytest.raises(ValueError, match="3x2 != 8"):
            make_mesh(3, 2, devices=["cpu"] * 8)

    def test_cells_of_two_ranks_split_db_rows(self, monkeypatch):
        """A (4, 2) mesh over 2 ranks x 4 devices gives db rows 0-1 to rank
        0 and rows 2-3 to rank 1 (rank-major, as jax.devices() orders)."""
        monkeypatch.setattr(tsh.tdist, "rank", lambda: 1)
        cells = [tsh.Cell(torch.device("cpu"), r) for r in (0, 1)
                 for _ in range(4)]
        mesh = make_mesh(4, 2, devices=cells, distributed=True)
        assert mesh.rank == 1 and mesh.is_multiprocess
        assert {i for i, _, _ in mesh.local_cells()} == {2, 3}
        assert mesh.rank_cells == {0: [0, 1, 2, 3], 1: [4, 5, 6, 7]}

    def test_tensor_is_split_where_it_lies(self, rng, monkeypatch):
        """A tensor handed to a sharded op is sliced on its own device, each
        slice one shard; only host arrays go through put_global."""
        db, _ = _random_db(rng, n_audios=12)
        mesh = _mesh(4, 2)
        monkeypatch.setattr(tsh.tdist, "put_global", None)  # never called
        x = torch.from_numpy(db)
        got = tsh._as_sharded(mesh, x)
        assert got.rows == 12
        for i in range(4):
            assert torch.equal(got.part(i, torch.device("cpu")),
                               x[3 * i:3 * i + 3])
        with pytest.raises(ValueError, match="split evenly"):
            tsh._as_sharded(mesh, x[:10])

    def test_gather_layout_db_first_for_columns(self):
        """Cell (i, j)'s block lands at query rows of batch slice j and the
        columns of shard i."""
        mesh = _mesh(2, 2)
        blocks = [torch.full((3, 5), 10 * i + j) for i, j, _ in
                  mesh.local_cells()]
        got = tsh.gather_cells(mesh, blocks)
        assert got.shape == (6, 10)
        for i in range(2):
            for j in range(2):
                assert (got[3 * j:3 * j + 3, 5 * i:5 * i + 5]
                        == 10 * i + j).all()
        flat = tsh.gather_cells(mesh, blocks, flat=True)
        assert flat[:, 0].tolist() == [0] * 3 + [1] * 3 + [10] * 3 + [11] * 3

    def test_shard_db_pads_with_pad_value(self, rng):
        db, mask = _random_db(rng, n_audios=10)
        mesh = _mesh(4, 2)
        db_s, mask_s, a = shard_db(mesh, db, mask)
        assert a == 10 and db_s.rows == 12

        def whole(x):  # one part per db index, in order
            return torch.cat([x.part(i, torch.device("cpu"))
                              for i in range(4)]).numpy()

        full = whole(db_s)
        np.testing.assert_array_equal(full[:10], db)
        assert (full[10:] == PAD_VALUE).all()
        assert not whole(mask_s)[10:].any()
        jdb, jmask, ja = jax_shard_db(jax_make_mesh(4, 2), db, mask)
        np.testing.assert_array_equal(full, np.asarray(jdb))


class TestShardedSearch:
    @pytest.mark.parametrize("aligned", [False, True])
    @pytest.mark.parametrize("mesh_shape", SHAPES)
    def test_matches_jax_and_single_device(self, rng, mesh_shape, aligned):
        db, mask = _random_db(rng)
        q, n_frames = _random_query(rng, b=8)
        kw = dict(coefs=2, tolerance=1.0, aligned=aligned)
        mesh = _mesh(*mesh_shape)
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        best_s, count_s, votes_s = sharded_search(
            mesh, db_s, mask_s, q, n_frames, n_audios=n_audios, **kw)
        jmesh = jax_make_mesh(*mesh_shape)
        jdb, jmask, _ = jax_shard_db(jmesh, db, mask)
        best_j, count_j, votes_j = jax_sharded_search(
            jmesh, jdb, jmask, q, n_frames, n_audios=n_audios, **kw)
        assert votes_s.dtype == torch.int32
        np.testing.assert_array_equal(votes_s.numpy(), np.asarray(votes_j))
        np.testing.assert_array_equal(best_s.numpy(), np.asarray(best_j))
        np.testing.assert_array_equal(count_s.numpy(), np.asarray(count_j))
        np.testing.assert_array_equal(
            votes_s.numpy(), _port_votes(db, mask, q, n_frames, 1.0,
                                         coefs=2, aligned=aligned))

    @pytest.mark.parametrize("aligned", [False, True])
    def test_uneven_batch_padded(self, rng, aligned):
        mesh = _mesh(2, 4)
        db, mask = _random_db(rng, n_audios=10)
        q, n_frames = _random_query(rng, b=3)  # 3 not divisible by 4
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        kw = dict(coefs=1, tolerance=0.5, aligned=aligned)
        best_s, _, votes_s = sharded_search(
            mesh, db_s, mask_s, q, n_frames, n_audios=n_audios, **kw)
        jmesh = jax_make_mesh(2, 4)
        jdb, jmask, _ = jax_shard_db(jmesh, db, mask)
        best_j, _, votes_j = jax_sharded_search(
            jmesh, jdb, jmask, q, n_frames, n_audios=n_audios, **kw)
        assert votes_s.shape == (3, 10)
        np.testing.assert_array_equal(votes_s.numpy(), np.asarray(votes_j))
        np.testing.assert_array_equal(best_s.numpy(), np.asarray(best_j))

    @pytest.mark.parametrize("aligned", [False, True])
    def test_band_filter_and_trunc_modes(self, rng, aligned):
        mesh, jmesh = _mesh(4, 2), jax_make_mesh(4, 2)
        db, mask = _random_db(rng, n_audios=9)
        q, n_frames = _random_query(rng, b=4)
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        jdb, jmask, _ = jax_shard_db(jmesh, db, mask)
        for trunc in (True, False):
            kw = dict(coefs=2, tolerance=0.8, freq_ignore_low=30,
                      freq_ignore_high=250, trunc_coef1=trunc,
                      aligned=aligned)
            _, _, votes_s = sharded_search(
                mesh, db_s, mask_s, q, n_frames, n_audios=n_audios, **kw)
            _, _, votes_j = jax_sharded_search(
                jmesh, jdb, jmask, q, n_frames, n_audios=n_audios, **kw)
            np.testing.assert_array_equal(votes_s.numpy(),
                                          np.asarray(votes_j))


class TestShardedKernelMatcher:
    """The counterpart of the JAX per-shard Pallas matcher: K4/K5 per db
    shard, held to ``sharded_votes_pallas`` in interpret mode."""

    @pytest.mark.parametrize("aligned", [False, True])
    def test_matches_sharded_pallas(self, rng, aligned):
        mesh = _mesh(4, 2)
        db, mask = _random_db(rng, n_audios=32, t=128)
        q, n_frames = _random_query(rng, b=4)
        qp, active, use2 = match_jax.prepare_query(q, n_frames)
        want = jsh.sharded_votes_pallas(
            jax_make_mesh(4, 2), db, qp, active, use2, 0.9, coefs=2,
            aligned=aligned, interpret=True)
        tq, tact, tuse2 = tm.prepare_query(torch.from_numpy(q), n_frames)
        got = sharded_votes_kernels(mesh, db, tq, tact, tuse2, 0.9, coefs=2,
                                    aligned=aligned)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("aligned", [False, True])
    def test_sharded_search_pads_rows_and_batch(self, rng, aligned):
        """30 rows pad to 32, 3 queries to 4: the padding rows hold
        PAD_VALUE, so the value-reading kernels never count them."""
        mesh = _mesh(4, 2)
        db, mask = _random_db(rng, n_audios=30, t=128)
        q, n_frames = _random_query(rng, b=3)
        db_s, mask_s, n_audios = shard_db(mesh, db, mask)
        kw = dict(coefs=2, tolerance=0.9, trunc_coef1=False, aligned=aligned)
        best_p, count_p, votes_p = sharded_search(
            mesh, db_s, mask_s, q, n_frames, n_audios=n_audios, **kw)
        best_x, count_x, votes_x = match_jax.search_batch(
            db, mask, q, n_frames, **kw)
        np.testing.assert_array_equal(votes_p.numpy(), np.asarray(votes_x))
        np.testing.assert_array_equal(best_p.numpy(), np.asarray(best_x))
        np.testing.assert_array_equal(count_p.numpy(), np.asarray(count_x))


def _clustered_db(n_audios=64, t=128, c=2, seed=1):
    # the JAX test's corpus: per-audio clusters so bounds are selective
    rng = np.random.default_rng(seed)
    mu = rng.uniform(-25, 20, size=(n_audios, 1, c)).astype(np.float32)
    db = (mu + rng.normal(0, 1.5, (n_audios, t, c))).astype(np.float32)
    n_frames = rng.integers(96, t + 1, size=n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
    return db, mask


def _both_aligned_prefiltered(db, mask, q, tol, k, ctx=None, ctx_id=None,
                              aligned=True):
    """(port votes, port certs, JAX votes, JAX certs) on a (4, 2) mesh."""
    specs, maps = jml.build_bound_maps(jnp.asarray(db), jnp.asarray(mask))
    qp, active, use2 = match_jax.prepare_query(q, None, trunc_coef1=False)
    jv, jc = jsh.sharded_aligned_prefiltered(
        jax_make_mesh(4, 2), db, maps, qp, active, use2, tol, specs, 2,
        interpret=True, k=k, aligned=aligned,
        ctx_ids=None if ctx is None else jnp.asarray(ctx), ctx_id=ctx_id)
    tspecs, tmaps = tml.build_bound_maps(torch.from_numpy(db),
                                         torch.from_numpy(mask), 2)
    assert tspecs == specs
    tq, tact, tuse2 = tm.prepare_query(torch.from_numpy(q), None,
                                       trunc_coef1=False)
    tv, tc = tsh.sharded_aligned_prefiltered(
        _mesh(4, 2), db, tmaps, tq, tact, tuse2, tol, tspecs, 2, k=k,
        aligned=aligned, ctx_ids=None if ctx is None else ctx, ctx_id=ctx_id)
    return tv.numpy(), tc.numpy(), np.asarray(jv), np.asarray(jc)


class TestShardedPrefilter:
    """Certified two-stage aligned (and strict bag) search per db shard:
    every shard certifies its own rows; disjoint vote columns compose."""

    @pytest.mark.parametrize("aligned", [True, False])
    def test_matches_full_scan_when_certified(self, aligned):
        db, mask = _clustered_db()
        q = np.stack([db[7, 10:42], db[33, 40:72]]).astype(np.float32)
        vp, certs, jv, jc = _both_aligned_prefiltered(db, mask, q, 0.05, 8,
                                                      aligned=aligned)
        assert certs.shape == (2, 4) and certs.all()
        np.testing.assert_array_equal(certs, jc)
        _, _, full = tm.search_batch(
            torch.from_numpy(db), torch.from_numpy(mask), torch.from_numpy(q),
            None, coefs=2, tolerance=0.05, trunc_coef1=False, aligned=aligned)
        full = full.numpy()
        for b, target in ((0, 7), (1, 33)):
            assert vp[b].argmax() == full[b].argmax() == target
            assert vp[b].max() == full[b].max() == jv[b].max() == 32
            assert (vp[b] <= full[b]).all()
            # the certified rows are the full scan's wherever they voted
            hit = vp[b] > 0
            np.testing.assert_array_equal(vp[b][hit], full[b][hit])

    def test_any_shard_failure_visible(self):
        """A shard full of duplicates fails ITS certificate column while
        clean shards still certify: the caller's AND must see it."""
        db, mask = _clustered_db()
        db[16:32] = db[16]
        mask[16:32] = mask[16]
        q = np.stack([db[16, 10:42], db[16, 10:42]]).astype(np.float32)
        _, certs, _, jc = _both_aligned_prefiltered(db, mask, q, 0.05, 4)
        np.testing.assert_array_equal(certs, jc)
        assert not certs[:, 1].any()
        assert not certs.all()
        assert certs.any(axis=1).all()

    def test_context_filter_across_shards(self):
        """The global winner lives in an out-of-filter context on another
        shard; the filtered search certifies the in-context winner."""
        db, mask = _clustered_db()
        db[40] = db[7] + np.random.default_rng(2).normal(
            0, 0.004, db[7].shape).astype(np.float32)
        mask[40] = mask[7]
        db = np.where(mask[:, :, None], db, PAD_VALUE).astype(np.float32)
        ctx = np.zeros(64, np.int32)
        ctx[32:] = 1  # shards 2-3 are context 1
        q = np.stack([db[7, 10:42], db[7, 10:42]]).astype(np.float32)
        vp, certs, jv, jc = _both_aligned_prefiltered(db, mask, q, 0.05, 8,
                                                      ctx=ctx, ctx_id=1)
        assert certs.all() and jc.all()
        assert (vp[0][:32] == 0).all()
        assert vp[0].argmax() == jv[0].argmax() == 40
        assert vp[0].max() == jv[0].max() > 0


class TestShardedLatticePrefilter:
    """Certified dialplan prefilter per db shard (PARITY.md D19)."""

    def _clustered(self, n_audios=64, t=128):
        rng = np.random.default_rng(6)
        mu = rng.uniform(-25, 20, size=(n_audios, 1)).astype(np.float32)
        db0 = (mu + rng.normal(0, 1.5, (n_audios, t))).astype(np.float32)
        n_frames = rng.integers(96, t + 1, size=n_audios)
        mask = np.arange(t)[None, :] < n_frames[:, None]
        return np.where(mask, db0, PAD_VALUE).astype(np.float32), mask

    def _both(self, db0, mask, q0, ctx=None, ctx_id=None):
        jvm = jml.build_value_map(jnp.asarray(db0), jnp.asarray(mask))
        jvmq = jml.quantize_value_map(jvm)
        active = np.ones(q0.shape, bool)
        jv, jc = jsh.sharded_lattice_prefiltered(
            jax_make_mesh(4, 2), jvm, jvmq, jnp.asarray(q0),
            jnp.asarray(active), 0.5, -np.inf, np.inf, k=8,
            ctx_ids=None if ctx is None else jnp.asarray(ctx), ctx_id=ctx_id)
        vm = tml.build_value_map(torch.from_numpy(db0), torch.from_numpy(mask))
        np.testing.assert_array_equal(vm.numpy(), np.asarray(jvm))
        tv, tc = tsh.sharded_lattice_prefiltered(
            _mesh(4, 2), vm, tml.quantize_value_map(vm), torch.from_numpy(q0),
            torch.from_numpy(active), 0.5, -np.inf, np.inf, k=8,
            ctx_ids=ctx, ctx_id=ctx_id)
        full = tml.lattice_votes(vm, torch.from_numpy(q0),
                                 torch.from_numpy(active), 0.5, -np.inf,
                                 np.inf).numpy()
        return tv.numpy(), tc.numpy(), np.asarray(jv), np.asarray(jc), full

    def test_matches_full_scan_when_certified(self):
        db0, mask = self._clustered()
        q0 = np.stack([db0[7, 10:42], db0[33, 40:72]]).astype(np.float32)
        vp, certs, jv, jc, full = self._both(db0, mask, q0)
        assert certs.shape == (2, 4) and certs.all()
        np.testing.assert_array_equal(certs, jc)
        np.testing.assert_array_equal(vp, jv)
        assert (vp <= full).all()
        for b in range(2):
            assert full[b].max() > 0
            assert vp[b].argmax() == full[b].argmax()
            assert vp[b].max() == full[b].max()

    def test_context_filter_across_shards(self):
        db0, mask = self._clustered()
        ctx = np.zeros(64, np.int32)
        ctx[32:] = 1
        q0 = np.stack([db0[40, 10:42], db0[40, 10:42]]).astype(np.float32)
        vp, certs, jv, jc, full = self._both(db0, mask, q0, ctx, 1)
        assert certs.all() and jc.all()
        np.testing.assert_array_equal(vp, jv)
        full = np.where(ctx == 1, full, 0)[0]
        assert (vp[0][:32] == 0).all()
        assert vp[0].argmax() == full.argmax() and vp[0].max() == full.max()


class TestSequenceParallel:
    def test_long_signal_matches_jax_and_single_device(self, rng):
        sr, n_cells = 8000, 8
        dsp, jdsp = DspConfig(), JaxDspConfig()
        s = (2 * 60 * sr) // (dsp.hop_size * n_cells) * (dsp.hop_size
                                                         * n_cells)
        pcm = (0.3 * rng.standard_normal(s)).astype(np.float32)
        got = sharded_fingerprint_long(_mesh(4, 2), pcm, sr, dsp).numpy()
        assert got.shape[0] == s // dsp.hop_size
        want = np.asarray(jsh.sharded_fingerprint_long(jax_make_mesh(4, 2),
                                                       pcm, sr, jdsp))
        np.testing.assert_allclose(got, want, atol=FP_ATOL, rtol=0)
        np.testing.assert_allclose(got, jax_fp_signal(pcm, sr, jdsp)[
            : got.shape[0]], atol=FP_ATOL, rtol=0)
        ref = fingerprint_signal(pcm, sr, dsp, device="cpu")
        np.testing.assert_array_equal(got, ref[: got.shape[0]])

    def test_rejects_undivisible_length(self):
        dsp = DspConfig()
        with pytest.raises(ValueError, match="multiple of hop"):
            sharded_fingerprint_long(
                _mesh(8, 1), np.zeros(dsp.hop_size * 8 + 1, np.float32), 8000,
                dsp)

    def test_long_signal_shorter_than_overlap_rejected(self):
        wide = DspConfig(buf_size=1024, hop_size=256)
        with pytest.raises(ValueError, match="overlap"):
            sharded_fingerprint_long(
                _mesh(8, 1), np.zeros(wide.hop_size * 8, np.float32), 8000,
                wide)


class TestShardedFingerprint:
    def _pcms(self, rng, kind):
        sr = 8000
        if kind == "float32":
            return [(0.5 * rng.standard_normal(sr // 2 + 77 * i)).astype(
                np.float32) for i in range(8)]
        return [np.clip(np.round(0.5 * rng.standard_normal(sr // 2 + 31 * i)
                                 * 32768.0), -32768, 32767).astype(np.int16)
                for i in range(8)]

    @pytest.mark.parametrize("kind", ["float32", "int16"])
    def test_matches_jax_and_single_device(self, rng, kind):
        dsp, jdsp = DspConfig(), JaxDspConfig()
        padded, _ = pad_frames_bucket(self._pcms(rng, kind), dsp.hop_size)
        assert padded.dtype == np.dtype(kind)
        got = sharded_fingerprint(_mesh(4, 2), padded, 8000, dsp).numpy()
        want = np.asarray(jsh.sharded_fingerprint(jax_make_mesh(4, 2),
                                                  padded, 8000, jdsp))
        np.testing.assert_allclose(got, want, atol=FP_ATOL, rtol=0)
        np.testing.assert_allclose(
            got, np.asarray(jax_fp_batch(padded, 8000, jdsp)), atol=FP_ATOL,
            rtol=0)
        np.testing.assert_array_equal(
            got, fingerprint_padded_batch(padded, 8000, dsp,
                                          device="cpu").numpy())

    def test_g711_wire_with_n_valid(self, rng):
        dsp, jdsp = DspConfig(), JaxDspConfig()
        pcms = [jax_g711.encode_ulaw(p) for p in self._pcms(rng, "int16")]
        padded, _ = pad_frames_bucket(pcms, dsp.hop_size, law="ulaw")
        n_valid = np.array([len(p) for p in pcms], np.int32)
        got = sharded_fingerprint(_mesh(2, 4), padded, 8000, dsp, law="ulaw",
                                  n_valid=n_valid).numpy()
        want = np.asarray(jsh.sharded_fingerprint(
            jax_make_mesh(2, 4), padded, 8000, jdsp, law="ulaw",
            n_valid=n_valid))
        np.testing.assert_allclose(got, want, atol=FP_ATOL, rtol=0)
        np.testing.assert_array_equal(got, fingerprint_padded_batch(
            padded, 8000, dsp, law="ulaw", n_valid=n_valid,
            device="cpu").numpy())

    def test_rejects_bad_batches(self):
        mesh = _mesh(4, 2)
        with pytest.raises(ValueError, match="not divisible"):
            sharded_fingerprint(mesh, np.zeros((6, 2048), np.float32), 8000)
        with pytest.raises(ValueError, match="G.711"):
            sharded_fingerprint(mesh, np.zeros((8, 2048), np.uint8), 8000)


class TestShardingReviewFixes:
    def test_negative_tolerance_uses_default(self, rng):
        from tiresias_tpu_torch.config import DEF_SEARCH_TOLERANCE

        db, mask = _random_db(rng)
        mesh = _mesh(4, 2)
        db_s, mask_s, a = shard_db(mesh, db, mask)
        q = rng.uniform(-30, 20, (2, 16, 2)).astype(np.float32)
        _, _, v_neg = sharded_search(mesh, db_s, mask_s, q, coefs=2,
                                     tolerance=-1.0, n_audios=a)
        _, _, v_def = sharded_search(mesh, db_s, mask_s, q, coefs=2,
                                     tolerance=DEF_SEARCH_TOLERANCE,
                                     n_audios=a)
        assert torch.equal(v_neg, v_def)

    def test_with_top1_false_returns_same_votes(self, rng):
        db, mask = _random_db(rng)
        mesh = _mesh(4, 2)
        db_s, mask_s, a = shard_db(mesh, db, mask)
        q = rng.uniform(-30, 20, (2, 16, 2)).astype(np.float32)
        _, _, votes = sharded_search(mesh, db_s, mask_s, q, coefs=2,
                                     tolerance=1.0, n_audios=a)
        b2, c2, votes2 = sharded_search(mesh, db_s, mask_s, q, coefs=2,
                                        tolerance=1.0, n_audios=a,
                                        with_top1=False)
        assert b2 is None and c2 is None
        assert torch.equal(votes, votes2)


# ---- the meshed store against the JAX meshed store ---------------------- #

N_COEFS = 3


def _bits(x):
    x = torch.from_numpy(np.array(x)) if not isinstance(
        x, torch.Tensor) else x
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _gathered(view, part) -> torch.Tensor:
    """A meshed view's per-shard tensor, concatenated in db order (one
    shard per db index on a (4, 1) mesh of one process)."""
    shards = sorted(view.shards, key=lambda s: s.index)
    return torch.cat([part(s.view) for s in shards])


class MeshPair:
    """One catalog in a JAX store on a (4, 1) mesh of virtual devices and a
    port store on a (4, 1) mesh of CPU cells, mutated alike."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.j = jfs.FingerprintStore(
            n_coefs=N_COEFS,
            mesh=jax_make_mesh(4, 1, devices=jax.devices()[:4]))
        self.t = tfs.FingerprintStore(n_coefs=N_COEFS, mesh=_mesh(4, 1))
        self.flat = tfs.FingerprintStore(n_coefs=N_COEFS, device="cpu")
        for s in (self.j, self.t, self.flat):
            s.create_context("a")
            s.create_context("b")
        self.uuids: list[str] = []
        self.full_builds = {"jax": 0, "port": 0}
        jput, tbuild = self.j._device_put, self.t._build_view

        def jax_put(*a, **k):
            self.full_builds["jax"] += 1
            return jput(*a, **k)

        def port_build(*a, **k):
            self.full_builds["port"] += 1
            return tbuild(*a, **k)

        self.j._device_put = jax_put
        self.t._build_view = port_build

    def add(self, n_frames: int, ctx: str = "a") -> str:
        fp = self.rng.normal(-25.0, 15.0, (n_frames, N_COEFS))
        fp[:, 1:] = self.rng.normal(0.0, 8.0, (n_frames, N_COEFS - 1))
        uuid = f"u{len(self.uuids):04d}"
        for s in (self.j, self.t, self.flat):
            s.add_audio(uuid, ctx, fp.astype(np.float32), "h" + uuid,
                        uuid=uuid)
        self.uuids.append(uuid)
        return uuid

    def delete(self, *uuids: str) -> None:
        for s in (self.j, self.t, self.flat):
            assert s.delete_audios(uuids) == len(uuids)

    def warm(self):
        for v in self.j.search_views():
            self.j.value_map_q_for(v)
            for c in (2, 3):
                self.j.bound_maps_for(v, c)
            self.j.seq_for(v)
            self.j.ctx_ids_for(v)
        views = self.t.search_views()
        for v in views:
            self.t.seq_for(v)
            self.t.ctx_ids_for(v)
            for s in v.shards:
                self.t.value_map_q_for(s.view)
                for c in (2, 3):
                    self.t.bound_maps_for(s.view, c)
                self.t.match_index_for(s.view)
                self.t.ctx_ids_for(s.view)
        return views, [{k: x.clone() for k, x in v.tensors().items()}
                       for v in views]


def _check_mesh_views(pair: MeshPair) -> None:
    jviews, tviews = pair.j.search_views(), pair.t.search_views()
    fviews = pair.flat.search_views()
    assert [v.tier_frames for v in jviews] == [v.tier_frames for v in tviews]
    for jv, tv, fv in zip(jviews, tviews, fviews):
        assert (jv.n_audios, jv.dead_rows) == (tv.n_audios, tv.dead_rows)
        assert tv.segments == jv.segments
        assert tv.rows == np.asarray(jv.db).shape[0]
        n, live = tv.n_audios, [i not in tv.dead_rows
                                for i in range(tv.n_audios)]
        pairs = {
            "db": (lambda s: s.db, jv.db, fv.db),
            "mask": (lambda s: s.mask, jv.mask, fv.mask),
            "value_map": (pair.t.value_map_for, pair.j.value_map_for(jv),
                          pair.flat.value_map_for(fv)),
            "value_map_q": (pair.t.value_map_q_for,
                            pair.j.value_map_q_for(jv),
                            pair.flat.value_map_q_for(fv)),
        }
        for c in (2, 3):
            for m in range(len(pair.j.bound_maps_for(jv, c)[1])):
                pairs[f"bound{c}[{m}]"] = (
                    lambda s, c=c, m=m: pair.t.bound_maps_for(s, c)[1][m],
                    pair.j.bound_maps_for(jv, c)[1][m],
                    pair.flat.bound_maps_for(fv, c)[1][m])
        for name, (part, jx, fx) in pairs.items():
            got = _gathered(tv, part)
            assert _same(got, jx), name
            # the unsharded port view: the same rows, then padding
            assert _same(got[: fx.shape[0]], fx), name
        idx = {k: _gathered(tv, lambda s, k=k: getattr(
            pair.t.match_index_for(s), k)) for k in ("entries", "pos",
                                                     "n_live")}
        for k, x in idx.items():
            fx = getattr(pair.flat.match_index_for(fv), k)
            assert _same(x[: fx.shape[0]], fx), k
        live = torch.tensor(live)
        assert _same(pair.t.seq_for(tv)[:n], torch.from_numpy(
            np.array(pair.j.seq_for(jv))[:n]))
        for ids in (pair.t.ctx_ids_for(tv),
                    _gathered(tv, pair.t.ctx_ids_for)):
            assert _same(ids[:n][live], torch.from_numpy(
                np.array(pair.j.ctx_ids_for(jv))[:n])[live])


def _mesh_step(pair: MeshPair, mutate, routes: list, changed=None):
    """Warm, mutate, update and hold everything; ``routes`` per tier as in
    tests/test_torch_views.py ("same", "inc", "full"); ``changed``: the db
    indexes whose shards an "inc" update may rebuild (every other shard
    keeps its view object)."""
    old_views, before = pair.warm()
    old_by_tier = {v.tier_frames: v for v in old_views}
    pair.full_builds.update(jax=0, port=0)
    mutate()
    pair.j.search_views()
    views = pair.t.search_views()
    n_full = routes.count("full")
    assert pair.full_builds == {"jax": n_full, "port": n_full}
    for v, route in zip(views, routes):
        old = old_by_tier.get(v.tier_frames)
        if route == "same":
            assert v is old
        elif route == "inc" and changed is not None:
            kept = {s.index for s, o in zip(v.shards, old.shards)
                    if s.view is o.view}
            assert kept == set(range(4)) - set(changed), kept
    for v, saved in zip(old_views, before):
        now = v.tensors()
        for name, x in saved.items():
            assert _same(now[name], x), (v.tier_frames, name)
    _check_mesh_views(pair)


class TestMeshedStore:
    def test_append_within_and_across_a_bucket(self):
        pair = MeshPair(1)
        for i in range(127):
            pair.add(20 + i % 100)
        _check_mesh_views(pair)
        # 512 rows per view on a (4, 1) mesh: shard 0 holds rows 0-127
        _mesh_step(pair, lambda: pair.add(50), ["inc"], changed=[0])
        _mesh_step(pair, lambda: [pair.add(30) for _ in range(3)], ["inc"],
                   changed=[1])
        for _ in range(381):
            pair.add(10)
        _mesh_step(pair, lambda: pair.add(60), ["full"])  # 513 rows

    def test_delete_masks_off_one_shard(self):
        pair = MeshPair(2)
        for i in range(300):
            pair.add(20 + i % 60, "ab"[i % 5 == 0])
        _mesh_step(pair, lambda: pair.delete(pair.uuids[200]), ["inc"],
                   changed=[1])
        _mesh_step(pair, lambda: pair.delete(pair.uuids[3], pair.uuids[260]),
                   ["inc"], changed=[0, 2])

        def mutate():
            pair.add(40)
            gone = pair.add(70, "b")
            pair.delete(gone, pair.uuids[10])

        _mesh_step(pair, mutate, ["inc"], changed=[0, 2])
        _mesh_step(pair, lambda: pair.t.delete_context("b")
                   and pair.j.delete_context("b")
                   and pair.flat.delete_context("b"), ["inc"])

    def test_segments_straddling_a_shard_edge(self, monkeypatch):
        """Auto-split audios whose segment rows lie on both sides of a
        shard edge: the head's min-combined map row equals the JAX store's
        (computed on the global array), built in full and row by row, and
        after the audio is deleted."""
        for mod in (jfs, tfs):
            monkeypatch.setattr(mod, "MAX_TIER_FRAMES", 128)
        pair = MeshPair(3)
        for i in range(126):
            pair.add(40 + i % 80)
        pair.add(333)  # rows 126-128: across the edge of shards 0 and 1
        _check_mesh_views(pair)
        (view,) = pair.t.search_views()
        assert (126, 127, 128) in view.segments
        assert view.shards[0].view.seg_ext and view.shards[1].view.seg_orphans
        _mesh_step(pair, lambda: pair.add(20), ["inc"], changed=[1])
        for _ in range(124):
            pair.add(10)
        # appended across the edge of shards 1 and 2 (rows 254-257)
        _mesh_step(pair, lambda: pair.add(500), ["inc"], changed=[1, 2])
        _mesh_step(pair, lambda: pair.delete(pair.uuids[126]), ["inc"],
                   changed=[0, 1])
        _mesh_step(pair, lambda: pair.add(300), ["inc"], changed=[2])

    def test_compaction_rebuilds_in_full(self):
        pair = MeshPair(4)
        for i in range(140):
            pair.add(10 + i % 50)
        _mesh_step(pair, lambda: pair.delete(*pair.uuids[:128]), ["full"])
        _mesh_step(pair, lambda: pair.delete(pair.uuids[130]), ["inc"])

    def test_two_tiers_one_mutated(self):
        pair = MeshPair(5)
        for n in (40, 200, 90, 250, 128):
            pair.add(n)
        _mesh_step(pair, lambda: pair.add(180), ["same", "inc"])
        _mesh_step(pair, lambda: pair.delete(pair.uuids[0]), ["inc", "same"])
