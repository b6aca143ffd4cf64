"""The port's multi-process placement (``parallel/distributed.py``) against
the JAX package's, on the CPU.

What one host can test, as ``tests/test_distributed.py`` does for JAX:
``put_global`` places each cell's rows of a replicated host array;
``Tiresias(mesh="global")`` without a process group builds a mesh over this
process's cells; ``initialize_distributed`` reads torchrun's environment,
adopts an outside process group and never falls back to Gloo on a card;
and, in subprocesses with timeouts of their own, a 1-process Gloo cluster
and the 2-process cluster of ``tiresias_tpu_torch.dryrun`` (4 CPU cells per
process, one (4, 2) mesh) run the engine end to end, both ranks agreeing.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tiresias_tpu.api import Tiresias as JaxTiresias
from tiresias_tpu.config import TiresiasConfig as JaxConfig
from tiresias_tpu.parallel import make_mesh as jax_make_mesh
from tiresias_tpu.parallel.distributed import put_global as jax_put_global
from tiresias_tpu_torch import dryrun
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import TiresiasConfig
from tiresias_tpu_torch.parallel import distributed as tdist
from tiresias_tpu_torch.parallel import make_mesh, put_global, sharding
from tiresias_tpu_torch.parallel.sharding import Cell
from tiresias_tpu_torch.utils.audio import synth_tone

SR = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRICT = dict(coefs=2, tolerance=0.05, trunc_coef1=False)


class TestPutGlobal:
    @pytest.mark.parametrize("axis", ["db", "batch", None])
    def test_each_cell_holds_its_rows(self, axis):
        from jax.sharding import PartitionSpec

        mesh = make_mesh(4, 2, devices=["cpu"] * 8)
        arr = np.random.default_rng(3).standard_normal((8, 16, 2)).astype(
            np.float32)
        placed = put_global(arr, mesh, axis)
        n = {"db": 4, "batch": 2, None: 1}[axis]
        assert placed.rows == 8
        assert sorted(i for i, _ in placed.parts) == list(range(n))
        for (i, dev), x in placed.parts.items():
            assert x.device == dev
            per = 8 // n
            np.testing.assert_array_equal(x.numpy(),
                                          arr[i * per:(i + 1) * per])
        # the JAX placement of the same spec holds the same blocks
        spec = {"db": PartitionSpec("db", None, None),
                "batch": PartitionSpec("batch", None, None),
                None: PartitionSpec()}[axis]
        jarr = jax_put_global(arr, jax_make_mesh(4, 2), spec)
        for shard in jarr.addressable_shards:
            rows = np.asarray(shard.data)
            i = (shard.index[0].start or 0) // rows.shape[0]
            np.testing.assert_array_equal(
                placed.part(i, torch.device("cpu")).numpy(), rows)
        with pytest.raises(ValueError, match="split evenly"):
            put_global(arr[:7], mesh, "db")

    def test_global_engine_search_equals_jax(self, tmp_path, monkeypatch):
        """``mesh="global"`` without a process group: a mesh over this
        process's cells, the same result as the JAX global engine."""
        # 8 CPU cells: the counterpart of JAX's 8 virtual CPU devices
        monkeypatch.setattr(tdist, "local_devices",
                            lambda device="cuda": [torch.device("cpu")] * 8)
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path / "t")),
                       restore=False, mesh="global", device="cpu")
        jeng = JaxTiresias(JaxConfig(data_dir=str(tmp_path / "j")),
                           restore=False, mesh="global")
        assert eng.mesh.devices.size == jeng.mesh.devices.size == 8
        assert not eng.mesh.distributed
        got = []
        for e in (eng, jeng):
            e.create_context("c")
            for i in range(8):
                e.add_audio_pcm("c", f"t{i}", synth_tone(200 + 150 * i, 1.0,
                                                         SR), SR)
            r = e.search_pcm("c", synth_tone(500, 1.0, SR), SR, **STRICT)
            got.append((r.status, r.name, r.frame_count))
            e.close()
        assert got[0] == got[1] == ("FOUND", "t2", 32)


class TestCollectiveOrder:
    """Collectives pair up between ranks by the order each rank issues them:
    within a process one search's all_gathers run at a time, and what cannot
    keep one order across ranks refuses a multi-process mesh."""

    def test_concurrent_searches_gather_one_search_at_a_time(
            self, tmp_path, monkeypatch):
        mesh = make_mesh(4, 1, devices=["cpu"] * 4, distributed=True)
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                       mesh=mesh, device="cpu")
        eng.create_context("c")
        for i in range(6):  # 1 s and 5 s clips: two views, two gathers
            eng.add_audio_pcm("c", f"t{i}", synth_tone(
                200 + 150 * i, 5.0 if i % 3 == 0 else 1.0, SR), SR)
        assert len(eng.store.search_views()) == 2
        log = []

        def exchange(m, local):  # world size 1, slow enough to interleave
            log.append(threading.get_ident())
            time.sleep(0.002)
            return [local]

        monkeypatch.setattr(sharding, "_exchange", exchange)
        queries = [synth_tone(200 + 150 * i, 0.7, SR) for i in range(6)]
        want = [eng.search_pcm("c", q, SR, **STRICT).name for q in queries]
        per_search = len(log) // len(queries)
        assert per_search == 2 and want == [f"t{i}" for i in range(6)]
        log.clear()
        got: dict = {}

        def worker(i):
            got[i] = [eng.search_pcm("c", q, SR, **STRICT).name
                      for q in queries]

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        eng.close()
        assert all(v == want for v in got.values())
        assert len(log) == 4 * len(queries) * per_search
        for n in range(0, len(log), per_search):
            assert len(set(log[n:n + per_search])) == 1, log

    def test_server_refuses_a_multiprocess_mesh(self, tmp_path):
        from tiresias_tpu_torch.serve import RecognitionServer

        mesh = make_mesh(2, 1, devices=[Cell(torch.device("cpu"), 0),
                                        Cell(torch.device("cpu"), 1)],
                         distributed=True)
        assert mesh.is_multiprocess
        eng = Tiresias(TiresiasConfig(data_dir=str(tmp_path)), restore=False,
                       mesh=mesh, device="cpu")
        try:
            # warming issues searches every rank must order: not in the
            # background
            assert not eng.warmup_async().is_alive()
            with pytest.raises(ValueError, match="multi-process mesh"):
                RecognitionServer(eng)
        finally:
            eng.close()


class TestInitialize:
    @pytest.fixture(autouse=True)
    def _fresh(self, monkeypatch):
        monkeypatch.setattr(tdist, "_initialized", False)
        monkeypatch.setattr(tdist, "_local", None)

    def test_outside_initialization_is_adopted(self, monkeypatch):
        """A process group someone else initialized is not initialized
        again (that would raise)."""
        monkeypatch.setattr(dist, "is_initialized", lambda: True)

        def boom(*a, **k):
            raise AssertionError("re-initialized an initialized group")

        monkeypatch.setattr(dist, "init_process_group", boom)
        tdist.initialize_distributed(device="cpu", local_device_ids=[0, 1])
        assert tdist._initialized
        assert tdist.local_devices("cpu") == [torch.device("cpu")] * 2
        tdist.initialize_distributed()  # idempotent: no second call

    def test_torchrun_environment(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: seen.update(backend=backend,
                                                              **kw))
        for k, v in (("MASTER_ADDR", "10.0.0.7"), ("MASTER_PORT", "2345"),
                     ("WORLD_SIZE", "4"), ("RANK", "3")):
            monkeypatch.setenv(k, v)
        tdist.initialize_distributed(device="cpu", local_device_ids=range(2))
        assert seen["backend"] == "gloo"
        assert seen["init_method"] == "tcp://10.0.0.7:2345"
        assert (seen["world_size"], seen["rank"]) == (4, 3)

    def test_coordinator_address_and_arguments_win(self, monkeypatch):
        seen = {}
        monkeypatch.setattr(dist, "init_process_group",
                            lambda backend, **kw: seen.update(**kw))
        monkeypatch.setenv("RANK", "5")
        tdist.initialize_distributed("localhost:1234", num_processes=2,
                                     process_id=1, device="cpu")
        assert seen["init_method"] == "tcp://localhost:1234"
        assert (seen["world_size"], seen["rank"]) == (2, 1)

    def test_failures_raise(self, monkeypatch):
        """No coordinator, no card, or a failing backend: each raises, and
        a card is never swapped for Gloo."""
        for k in ("MASTER_ADDR", "MASTER_PORT"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(ValueError, match="coordinator"):
            tdist.initialize_distributed(device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                tdist.initialize_distributed("localhost:1", device="cuda")

        def refused(*a, **k):
            raise RuntimeError("connection refused")

        monkeypatch.setattr(dist, "init_process_group", refused)
        with pytest.raises(RuntimeError, match="refused"):
            tdist.initialize_distributed("localhost:1", device="cpu")
        assert not tdist._initialized


_ONE_PROCESS = r"""
import sys, tempfile
import torch
port = sys.argv[1]
from tiresias_tpu_torch.parallel import (
    global_mesh, initialize_distributed, is_multiprocess)
initialize_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                       local_device_ids=range(8), device="cpu")
assert not is_multiprocess()
mesh = global_mesh()
assert mesh.devices.size == 8 and mesh.distributed, mesh
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import TiresiasConfig
from tiresias_tpu_torch.parallel import sharding
from tiresias_tpu_torch.utils.audio import synth_tone
calls = []
real = sharding._exchange
def spy(*a):
    calls.append(1)
    return real(*a)
sharding._exchange = spy
with tempfile.TemporaryDirectory() as d:
    eng = Tiresias(TiresiasConfig(data_dir=d), restore=False, mesh="global",
                   device="cpu")
    eng.create_context("c")
    for i in range(4):
        eng.add_audio_pcm("c", f"t{i}", synth_tone(200 + 150 * i, 0.5, 8000),
                          8000)
    r = eng.search_pcm("c", synth_tone(350, 0.5, 8000), 8000, coefs=2,
                       tolerance=0.05, trunc_coef1=False)
    assert r.status == "FOUND" and r.name == "t1", (r.status, r.name)
    eng.close()
assert calls, "the gather never went through all_gather"
print("DISTRIBUTED_OK")
"""


class TestClusters:
    def test_single_process_cluster_end_to_end(self):
        """initialize_distributed + global_mesh + an engine search in a
        fresh process: the gather goes through all_gather at world size
        1."""
        proc = subprocess.run(
            [sys.executable, "-c", _ONE_PROCESS, str(dryrun._free_port())],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": REPO},
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "DISTRIBUTED_OK" in proc.stdout

    def test_two_process_cluster_end_to_end(self):
        """The dry run's 2-process Gloo cluster: one (4, 2) mesh, each rank
        holding db rows of its own; add, search, live add, delete, an
        auto-split audio and the halo exchange; both ranks must agree."""
        agreed = dryrun.gloo_cluster(timeout=150)
        assert '"search": ["FOUND", "t1"' in agreed
        assert '"appended": ["FOUND", "t9"' in agreed
        assert '"autosplit": ["FOUND", "long"' in agreed

    def test_multichip_dry_run_on_cpu_cells(self):
        out = dryrun.dryrun_multichip(8, device="cpu")
        assert out["queries"] == 16 and out["audios"] == 16
