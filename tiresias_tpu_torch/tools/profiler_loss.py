"""Where torch.profiler loses device records, and what a smoke run's timing
costs.

    python -m tiresias_tpu_torch.tools.profiler_loss probe
    python -m tiresias_tpu_torch.tools.profiler_loss account [TREE ...]

``probe`` (one fresh process on the card) takes profiles of 20 calls each
and counts the device records that arrived: K-b ``select_candidates`` (a
ctypes launch) with a ~0.5 ms or a ~20 ms spin kernel at the window's head,
inside ``record_function``, and a torch-native op, in turns; then 1,200
short profiles in a row; then short profiles each after a large one (3,000
or more records), without and with CUPTI forced to flush its buffers
(``cuptiActivityFlushAll``) after every profile. It prints one JSON line a
part: how many profiles lost records, and how many each lost.

``account`` runs each TREE's ``chip_smoke.main()`` (a checkout of the port,
an earlier commit unpacked with ``git archive``; default this checkout) in a
process of its own, with that tree's timing helpers wrapped, and prints
``[account] TREE {...}``: the wall seconds in ``device_ms`` (its first
profile, its further profiles, its CUDA-events fallback, where the tree's
``device_ms`` has them), in ``events_ms`` called directly, and in K-b's
kernels-per-call checks (in process, and in fresh processes), in all and
up to each ``[time]`` line; then ``probe``'s first part (:func:`head`) in
that process, after the whole run. Both need a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

REPS = 20


class Accountant:
    """Wall time in a chip_smoke module's timing helpers (see the module's
    docstring), gathered by wrapping them in ``timing`` (the tree's
    ``tiresias_tpu_torch.utils.timing``) and ``cs`` (its ``chip_smoke``)."""

    def __init__(self, timing, cs):
        self.s = {"device_ms_calls": 0, "device_ms_s": 0.0,
                  "profiles": 0, "first_profile_s": 0.0,
                  "further_profiles": 0, "further_profiles_s": 0.0,
                  "events_fallbacks": 0, "events_fallback_s": 0.0,
                  "fallback_first_profile_s": 0.0,
                  "events_direct_calls": 0, "events_direct_s": 0.0,
                  "kernels_per_call_calls": 0, "kernels_per_call_s": 0.0,
                  "fresh_processes_calls": 0, "fresh_processes_s": 0.0}
        self.phases = []
        self._call = None
        real_profile, real_events = timing.profile, timing.events_ms
        real_device = timing.device_ms
        acct = self

        class Profile:  # marks each profile a device_ms call takes
            def __init__(self, *a, **k):
                if acct._call is not None:
                    acct._call["marks"].append(time.perf_counter())
                self.p = real_profile(*a, **k)

            def __enter__(self):
                return self.p.__enter__()

            def __exit__(self, *exc):
                return self.p.__exit__(*exc)

        def events_ms(fn, *a, **k):
            t0 = time.perf_counter()
            try:
                return real_events(fn, *a, **k)
            finally:
                dt = time.perf_counter() - t0
                if acct._call is not None:
                    acct._call["events"] += dt
                else:
                    acct.s["events_direct_calls"] += 1
                    acct.s["events_direct_s"] += dt

        def device_ms(fn, *a, **k):
            acct._call = {"marks": [], "events": 0.0}
            n0 = len(timing.CLOCKS)
            t0 = time.perf_counter()
            try:
                return real_device(fn, *a, **k)
            finally:
                acct._close(t0, timing.CLOCKS[n0:] == ["events"])

        timing.profile = Profile
        timing.events_ms = events_ms
        timing.device_ms = device_ms
        for name, fn in (("device_ms", device_ms), ("events_ms", events_ms)):
            if hasattr(cs, name):
                setattr(cs, name, fn)
        for name, key in (("select_kernels_per_call", "kernels_per_call"),
                          ("select_kernels_fresh", "fresh_processes")):
            if hasattr(cs, name):
                setattr(cs, name, self._timed(getattr(cs, name), key))
        real_say = cs.say

        def say(msg):
            if msg.startswith("[time]"):
                self.phases.append([msg, self.totals()])
            real_say(msg)

        cs.say = say

    def _timed(self, fn, key):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.s[key + "_calls"] += 1
                self.s[key + "_s"] += time.perf_counter() - t0
        return wrapped

    def _close(self, t0: float, fell_back: bool) -> None:
        t1 = time.perf_counter()
        marks, ev = self._call["marks"], self._call["events"]
        self._call = None
        s = self.s
        s["device_ms_calls"] += 1
        s["device_ms_s"] += t1 - t0
        s["profiles"] += len(marks)
        spans = [b - a for a, b in zip(marks, marks[1:] + [t1 - ev])]
        if spans:
            s["fallback_first_profile_s" if fell_back
              else "first_profile_s"] += spans[0]
            s["further_profiles"] += len(spans) - 1
            s["further_profiles_s"] += sum(spans[1:])
        if fell_back:
            s["events_fallbacks"] += 1
            s["events_fallback_s"] += ev

    def totals(self) -> dict:
        return {k: round(v, 3) if isinstance(v, float) else v
                for k, v in self.s.items()}


_ACCOUNT = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from tiresias_tpu_torch.utils import timing
tool = {"__name__": "profiler_loss"}
exec(compile(open(sys.argv[1]).read(), sys.argv[1], "exec"), tool)
acct = tool["Accountant"](timing, cs)
t0 = time.perf_counter()
try:
    rc = cs.main()
except SystemExit as e:
    rc = e.code
main_s = round(time.perf_counter() - t0, 1)
# the window's head in this process, after the whole run
after = tool["head"](20) if rc == 0 else None
print("[account] " + json.dumps({"rc": rc, "main_s": main_s,
                                 **acct.totals(), "head_after_run": after,
                                 "phases": acct.phases}), flush=True)
"""


def account(tree: str, timeout: float) -> dict:
    """``tree``'s chip_smoke under an :class:`Accountant`, in a process of
    its own with that tree first on ``sys.path``; its output passes through
    and the accounts are returned."""
    tree = os.path.abspath(tree)
    proc = subprocess.Popen(
        [sys.executable, "-c", _ACCOUNT, os.path.abspath(__file__)],
        cwd=tree, env=dict(os.environ, PYTHONPATH=tree),
        stdout=subprocess.PIPE, text=True)
    out = None
    timer = threading.Timer(timeout, proc.kill)  # a hung run ends here
    timer.start()
    try:
        for line in proc.stdout:
            sys.stdout.write(line)
            if line.startswith("[account] "):
                out = json.loads(line.split(" ", 1)[1])
        proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if out is None:
        raise RuntimeError(f"{tree}: chip_smoke printed no accounts "
                           f"(exit {proc.returncode})")
    return out


# ---- probe ---------------------------------------------------------------- #


def _count(prof, key: str) -> tuple[int, int]:
    """(records whose name holds ``key``, spin-kernel records) of a
    profile's device events."""
    import torch

    k = spins = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k += key in e.name
            spins += "spin_kernel" in e.name
    return k, spins


def _window(fn, spin_cycles: int, annotate: bool = False,
            lead: int = 0) -> object:
    """One profile: ``lead`` ~1 us spins and a spin of ``spin_cycles``, then
    ``REPS`` calls of ``fn`` (each in ``record_function`` with
    ``annotate``), then the spin again."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(2_000)
        torch.cuda._sleep(spin_cycles)
        for i in range(REPS):
            if annotate:
                with record_function(f"call{i}"):
                    fn()
            else:
                fn()
        torch.cuda._sleep(spin_cycles)
        torch.cuda.synchronize()
    return prof


def _cupti_flush() -> None:
    """``cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)`` in the
    CUPTI library the profiler loaded into this process."""
    import ctypes

    with open("/proc/self/maps") as f:
        path = next(line.split()[-1] for line in f if "libcupti" in line)
    lib = ctypes.CDLL(path)
    lib.cuptiActivityFlushAll.argtypes = [ctypes.c_uint32]
    lib.cuptiActivityFlushAll.restype = ctypes.c_int
    rc = lib.cuptiActivityFlushAll(1)
    if rc != 0:
        raise RuntimeError(f"cuptiActivityFlushAll: CUPTI error {rc}")


def _subjects():
    """(K-b ``select_candidates`` on [64, 10,112] bounds at k=256, an
    in-place multiply of 4M floats), each run once."""
    import torch

    from tiresias_tpu_torch.ops import match_lattice as ml

    g = torch.Generator(device="cuda").manual_seed(0)
    bnd = torch.randint(-1, 400, (64, 10_112), generator=g, device="cuda",
                        dtype=torch.int32)
    x = torch.rand((4_000_000,), generator=g, device="cuda")

    def select():
        ml.select_candidates(bnd, 256)

    def native():
        x.mul_(1.0000001)

    select()
    native()
    torch.cuda.synchronize()
    return select, native


def head(n_rounds: int = 30) -> dict:
    """Profiles of ``REPS`` calls in turns, ``n_rounds`` of each variant: a
    ctypes launch after a ~0.5 ms or a ~20 ms spin, inside
    ``record_function``, and a torch-native op; how many lost records, and
    the counts of timed and spin records seen."""
    select, native = _subjects()
    variants = {"ctypes, 0.5 ms spin": (select, 1_000_000, False, "kb_select"),
                "ctypes, 20 ms spin": (select, 40_000_000, False, "kb_select"),
                "ctypes, record_function": (select, 1_000_000, True,
                                            "kb_select"),
                "torch-native, 0.5 ms spin": (native, 1_000_000, False,
                                              "elementwise")}
    got = {name: [] for name in variants}
    for _ in range(n_rounds):
        for name, (fn, spin, ann, key) in variants.items():
            got[name].append(_count(_window(fn, spin, ann), key))
    return {name: {"profiles": len(r),
                   "lost": sum(1 for k, s in r if k != REPS or s != 2),
                   "timed_records": sorted({k for k, _ in r}),
                   "spins": sorted({s for _, s in r})}
            for name, r in got.items()}


def probe(n_rounds: int = 30, n_sessions: int = 1200) -> dict:
    import numpy as np
    import torch

    out = {"head": head(n_rounds)}
    print("[probe] head " + json.dumps(out["head"]), flush=True)
    select, _ = _subjects()
    x = torch.zeros(1024, device="cuda")
    # 2. many short profiles in a row
    lost = [REPS + 2 - sum(_count(_window(select, 1_000_000), "kb_select"))
            for _ in range(n_sessions)]
    out["sessions"] = {f"{i}-{i + 99}": {
        "profiles_losing": int(np.count_nonzero(lost[i:i + 100])),
        "records_lost": int(sum(lost[i:i + 100]))}
        for i in range(0, n_sessions, 100)}
    print("[probe] sessions " + json.dumps(out["sessions"]), flush=True)
    # 3. a short profile after a large one, without and with a forced flush
    from torch.profiler import ProfilerActivity, profile

    out["after_large"] = {}
    for variant in ("no flush", "forced flush", "no flush again",
                    "forced flush again"):
        lost_head = timed = losing = 0
        for i in range(40):
            with profile(activities=[ProfilerActivity.CUDA]):
                for _ in range(3000 + 37 * i):
                    x.add_(1.0)
                torch.cuda.synchronize()
            if "forced" in variant:
                _cupti_flush()
            k, s = _count(_window(select, 1_000_000, lead=64), "kb_select")
            if "forced" in variant:
                _cupti_flush()
            lost_head += 66 - s
            timed += REPS - k
            losing += (66 - s) + (REPS - k) > 0
        out["after_large"][variant] = {"profiles": 40,
                                       "profiles_losing": losing,
                                       "head_records_lost": lost_head,
                                       "timed_records_lost": timed}
    print("[probe] after_large " + json.dumps(out["after_large"]),
          flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("probe", help="where the profiler loses records")
    acc = sub.add_parser("account", help="a smoke run's timing costs")
    acc.add_argument("trees", nargs="*", help="checkouts of the port")
    acc.add_argument("--timeout", type=float, default=1500.0)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.cmd == "probe":
        t0 = time.perf_counter()
        probe()
        print(f"[probe] done in {time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rcs = []
    for tree in args.trees or [here]:
        got = account(tree, args.timeout)
        print(f"[account] {tree} " + json.dumps(
            {k: v for k, v in got.items() if k != "phases"}), flush=True)
        rcs.append(got["rc"])
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
