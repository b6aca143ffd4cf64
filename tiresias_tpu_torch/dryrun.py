"""Dry runs of the port's sharded pipeline (the counterpart of the JAX
package's ``dryrun_multichip`` and two-process Gloo cluster check).

    python -m tiresias_tpu_torch.dryrun                 # 8 cells on the card
    python -m tiresias_tpu_torch.dryrun --device cpu    # 8 CPU cells
    python -m tiresias_tpu_torch.dryrun --cluster       # 2 processes on Gloo

:func:`dryrun_multichip` runs every sharded op one step over an n-cell
``(db, batch)`` mesh of this process's devices (repeated when there are
fewer than n) and holds each result to the unsharded op on the home device.
:func:`gloo_cluster` starts two processes, each with 4 CPU cells, joined by
``torch.distributed`` on Gloo into one (4, 2) global mesh, drives the engine
through add, search, live add, delete, an auto-split audio and search, plus
the sharded fingerprints' halo exchange, and requires both ranks to agree.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from tiresias_tpu_torch.config import DspConfig
from tiresias_tpu_torch.ops import match, match_kernels, match_lattice
from tiresias_tpu_torch.ops.mfcc import (
    PAD_VALUE,
    fingerprint_padded_batch,
    fingerprint_signal,
)
from tiresias_tpu_torch.parallel import distributed as tdist
from tiresias_tpu_torch.parallel import sharding as sh

SR = 8000


def _example_data(n_audios: int, b: int, n_samples: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    pcm = (0.3 * rng.standard_normal((b, n_samples))).astype(np.float32)
    t = 64
    db = rng.uniform(-30, 25, (n_audios, t, 2)).astype(np.float32)
    n_frames = rng.integers(8, t, n_audios)
    mask = np.arange(t)[None, :] < n_frames[:, None]
    return pcm, np.where(mask[..., None], db, PAD_VALUE).astype(
        np.float32), mask


def _check(label: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.shape != want.shape or not torch.equal(got, want.to(got.device)):
        raise AssertionError(f"dryrun: {label} differs from the unsharded op")


def dryrun_multichip(n_cells: int = 8, device: str = "cuda") -> dict:
    """One step of every sharded op over an ``n_cells`` mesh of this
    process's ``device`` devices (cells repeat a device when there are fewer
    devices), each held to the unsharded op. Returns a summary."""
    devices = tdist.local_devices(device)
    n_batch = 2 if n_cells % 2 == 0 and n_cells > 1 else 1
    mesh = sh.make_mesh(n_cells // n_batch, n_batch,
                        devices=[devices[i % len(devices)]
                                 for i in range(n_cells)])
    home = mesh.home
    dsp = DspConfig()
    pcm, db, mask = _example_data(max(16, n_cells), 2 * n_cells, 2048)
    # data-parallel fingerprints over every cell
    qfp = sh.sharded_fingerprint(mesh, pcm, SR, dsp)
    _check("sharded_fingerprint", qfp,
           fingerprint_padded_batch(pcm, SR, dsp, device=home))
    # db-sharded K4 and K5 with the gather and top-1
    db_s, mask_s, a = sh.shard_db(mesh, db, mask)
    tdb = torch.from_numpy(db).to(home)
    q, act, use2 = match.prepare_query(qfp, None)
    for aligned in (False, True):
        _, _, votes = sh.sharded_search(mesh, db_s, mask_s, qfp, coefs=2,
                                        tolerance=1.0, aligned=aligned,
                                        n_audios=a)
        fn = (match_kernels.match_votes_fused_aligned if aligned
              else match_kernels.match_votes_fused)
        with sh.on_device(home):
            _check(f"sharded_search aligned={aligned}", votes,
                   fn(tdb, q, act, use2, 1.0, 2))
    # the dialplan lattice votes and both certified prefilters per shard
    tmask = torch.from_numpy(mask).to(home)
    vm = match_lattice.build_value_map(tdb[..., 0], tmask)
    vmq = match_lattice.quantize_value_map(vm)
    q0 = torch.trunc(qfp[..., 0]).contiguous()
    valid = torch.ones(q0.shape, dtype=torch.bool, device=home)
    inf = float("inf")
    with sh.on_device(home):
        full = match_lattice.lattice_votes(vm, q0, valid, 0.5, -inf, inf)
    _check("sharded_lattice_votes", sh.sharded_lattice_votes(
        mesh, vm, q0, valid, 0.5, -inf, inf), full)
    _, certs = sh.sharded_lattice_prefiltered(mesh, vm, vmq, q0, valid, 0.5,
                                              -inf, inf, k=4)
    specs, maps = match_lattice.build_bound_maps(tdb, tmask, 2)
    q2, act2, use22 = match.prepare_query(qfp, None, trunc_coef1=False)
    _, certs2 = sh.sharded_aligned_prefiltered(
        mesh, db_s, maps, q2, act2, use22, 0.05, specs, 2, k=4)
    # sequence parallel: one long signal with the halo exchange
    long_pcm = pcm.reshape(-1)
    usable = len(long_pcm) // (dsp.hop_size * n_cells) * (dsp.hop_size
                                                          * n_cells)
    got = sh.sharded_fingerprint_long(mesh, long_pcm[:usable], SR, dsp)
    want = fingerprint_signal(long_pcm[:usable], SR, dsp, device=home)
    _check("sharded_fingerprint_long", got, torch.from_numpy(want))
    return {"mesh": repr(mesh), "queries": int(qfp.shape[0]), "audios": a,
            "lattice_certified": int(certs.all(dim=1).sum()),
            "aligned_certified": int(certs2.all(dim=1).sum())}


_CLUSTER_CODE = r"""
import json, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
pid, port = int(sys.argv[1]), sys.argv[2]
from tiresias_tpu_torch.parallel import (
    global_mesh, initialize_distributed, is_multiprocess)
from tiresias_tpu_torch.parallel import sharding as sh
initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                       local_device_ids=range(4), device="cpu")
assert is_multiprocess()
mesh = global_mesh(4, 2)
assert mesh.size == 8 and len(mesh.local_cells()) == 4
assert {i for i, _, _ in mesh.local_cells()} == ({0, 1} if pid == 0
                                                  else {2, 3})
from tiresias_tpu_torch.api import Tiresias
from tiresias_tpu_torch.config import DspConfig, TiresiasConfig
from tiresias_tpu_torch.ops.mfcc import fingerprint_signal
from tiresias_tpu_torch.utils.audio import synth_chirp, synth_tone
import tiresias_tpu_torch.store.fingerprint_store as fs
SR = 8000
out = {}
# the halo exchange crosses the ranks: rank 0's last tail to rank 1
sig = synth_chirp(200, 1800, 4.096, SR).astype(np.float32)
long_fp = sh.sharded_fingerprint_long(mesh, sig, SR)
assert torch.equal(long_fp, torch.from_numpy(
    fingerprint_signal(sig, SR, DspConfig(), device="cpu")))
out["long_frames"] = int(long_fp.shape[0])
strict = dict(coefs=2, tolerance=0.05, trunc_coef1=False)
def tone(i, s=0.5):
    return synth_tone(200 + 150 * i, s, SR)
tmp = tempfile.TemporaryDirectory()
engines = [Tiresias(TiresiasConfig(data_dir=f"{tmp.name}/{n}"),
                    restore=False, mesh=m, device="cpu")
           for n, m in (("mesh", mesh), ("flat", None))]
for eng in engines:
    eng.create_context("c")
    for i in range(4):
        eng.add_audio_pcm("c", f"t{i}", tone(i), SR)
def search(q, **kw):
    got = [eng.search_pcm("c", q, SR, **kw) for eng in engines]
    pick = [(r.status, r.name, r.match_count, r.frame_count) for r in got]
    assert pick[0] == pick[1], pick  # the mesh == the unsharded engine
    return pick[0]
out["search"] = search(tone(1), **strict)
assert out["search"][:2] == ("FOUND", "t1"), out
out["dialplan"] = search(tone(2), tolerance=1.0)
out["aligned"] = search(tone(3), aligned=True, **strict)
# a live append after the views exist: the touched shard updates
for eng in engines:
    eng.add_audio_pcm("c", "t9", tone(9), SR)
out["appended"] = search(tone(9), **strict)
assert out["appended"][1] == "t9", out
# a live delete on the sharded view
for eng in engines:
    gone = [e for e in eng.get_audios("c") if e.name == "t1"][0]
    assert eng.delete_audio(gone.uuid)
out["deleted"] = search(tone(1), **strict)
assert out["deleted"][1] != "t1", out
# an auto-split audio: its segment rows min-combine in the lattice map
fs.MAX_TIER_FRAMES = 128
for eng in engines:
    eng.add_audio_pcm("c", "long", synth_chirp(300, 1500, 20.0, SR), SR)
view = [v for v in engines[0].store.search_views() if v.segments][0]
for s in view.shards:
    heads = [g[0] for g in s.view.segments]
    vm = engines[0].store.value_map_for(s.view)
    assert all(torch.isfinite(vm[h]).any() for h in heads)
out["autosplit"] = search(synth_chirp(300, 1500, 20.0, SR)[SR:4 * SR],
                          **strict)
assert out["autosplit"][1] == "long", out
# mesh="global": every rank's cells, (8, 1)
eng = Tiresias(TiresiasConfig(data_dir=f"{tmp.name}/global"), restore=False,
               mesh="global", device="cpu")
assert eng.mesh.shape == {"db": 8, "batch": 1} and eng.mesh.distributed
eng.create_context("c")
eng.add_audio_pcm("c", "g", tone(5), SR)
out["global"] = [eng.search_pcm("c", tone(5), SR, **strict).name]
for e in engines + [eng]:
    e.close()
tmp.cleanup()
print(f"PROC{pid}_OK " + json.dumps(out, sort_keys=True), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gloo_cluster(timeout: float = 300.0) -> str:
    """Two processes, 4 CPU cells each, one (4, 2) mesh over Gloo; both must
    succeed within ``timeout`` seconds and report the same results, which
    are returned. Raises otherwise, after killing both."""
    port = _free_port()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _CLUSTER_CODE, str(i), str(port)], env=env,
            cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        line = next((x for x in out.splitlines()
                     if x.startswith(f"PROC{i}_OK ")), None)
        if p.returncode != 0 or line is None:
            raise RuntimeError(f"gloo cluster process {i} failed:\n{out}")
        results.append(line.split("_OK ", 1)[1])
    if results[0] != results[1]:
        raise RuntimeError(f"the ranks disagree: {results}")
    return results[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cluster", action="store_true",
                    help="the two-process Gloo cluster (CPU)")
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args(argv)
    if args.cluster:
        print(f"gloo_cluster ok: 2 processes x 4 cells, agreed "
              f"{gloo_cluster(args.timeout)}")
    else:
        print(f"dryrun_multichip ok: "
              f"{json.dumps(dryrun_multichip(args.cells, args.device))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
