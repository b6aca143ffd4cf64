"""The traced run's reading of torch.profiler's device records.

The window is profiled with CUDA activity only. It opens with a lead-in of
spin kernels, a copy of ``tiresias_tpu_torch/utils/timing.py``'s
``lead_in``: in a process that has run for minutes CUPTI loses the first
device records of a profile, and the lead-in's ``LEAD_IN`` short spins come
first, so such a loss misses them and not the window's work. Each call of
the window is marked on the device by one spin of its own length before
it, and the window ends in a long spin: so every device record falls into
the call that launched it, with no clock shared between host and device.

Each device operation (kernel, copy or memset) takes a layer from the map
in ``metrics/kernel_layers.json``: a kernel whose name holds one of a
layer's names is that layer's; a scope opened by one of its ``opens`` names
takes every operation up to and including the next whose name holds its
``closes``; an operation that no name claims (the program's plain-torch
steps and copies) takes the layer of the next claimed operation of its call,
and after the call's last claimed one the ``tail`` layer.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

SPIN = "spin_kernel"  # the kernel of torch.cuda._sleep
LEAD_IN = 64
LEAD_CYCLES = 2_000  # ~1 us
MARK_CYCLES = 20_000  # ~10 us
EDGE_CYCLES = 1_000_000  # ~0.5 ms
SHORT_US, LONG_US = 4.0, 100.0  # spin lengths that tell the three apart

LAYER_MAP = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "metrics", "kernel_layers.json")


def lead_in() -> None:
    for _ in range(LEAD_IN):
        torch.cuda._sleep(LEAD_CYCLES)
    torch.cuda._sleep(EDGE_CYCLES)


def mark_call() -> None:
    torch.cuda._sleep(MARK_CYCLES)


def edge() -> None:
    torch.cuda._sleep(EDGE_CYCLES)


def device_records(prof) -> list[tuple[str, float, float]]:
    """``(name, start us, end us)`` of every device record, by start, read
    from the profiler's raw records (building its event tree takes several
    times as long)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    base = min((e.start_ns() for e in evs), default=0)
    out = []
    for e in evs:
        s = e.start_ns() - base
        out.append((e.name(), s / 1e3, (s + e.duration_ns()) / 1e3))
    out.sort(key=lambda r: r[1])
    return out


def short(name: str, width: int = 160) -> str:
    """A device operation's name for the breakdown: no leading ``void``,
    at most ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[: width - 3] + "..."


def load_layer_map(path: str = LAYER_MAP) -> dict:
    with open(path) as f:
        return json.load(f)


def classify(names: list[str], layer_map: dict) -> list[str]:
    """The layer of each of one call's operations, in launch order."""
    layers: list = [None] * len(names)
    scope = None
    for i, name in enumerate(names):
        if scope is not None:
            layers[i] = scope["layer"]
            if scope["closes"] in name:
                scope = None
            continue
        for sc in layer_map.get("scopes", ()):
            if any(p in name for p in sc["opens"]):
                scope, layers[i] = sc, sc["layer"]
                break
        else:
            for layer, parts in layer_map["layers"].items():
                if any(p in name for p in parts):
                    layers[i] = layer
                    break
    nxt = layer_map["tail"]
    for i in range(len(names) - 1, -1, -1):
        if layers[i] is None:
            layers[i] = nxt
        else:
            nxt = layers[i]
    return layers


def union_us(spans) -> float:
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


@dataclasses.dataclass
class CallTrace:
    wall_ms: float  # the call's host-clock time
    start_us: float  # its marker's start on the device
    ops: list  # (name, start us, end us, layer)

    @property
    def busy_ms(self) -> float:
        return union_us((s, e) for _, s, e, _ in self.ops) / 1e3


@dataclasses.dataclass
class Trace:
    calls: list  # CallTrace of every call whose marker arrived
    window_s: float  # first marker to the closing spin, on the device
    busy_s: float  # the union of every operation in that window
    lead_lost: int  # lead-in spins that arrived short of LEAD_IN + 1
    markers_lost: int  # calls made whose marker did not arrive

    def layer_ms(self, layer: str) -> float | None:
        """Device ms a call of one layer's operations, or None where no
        call was traced."""
        if not self.calls:
            return None
        total = sum(e - s for c in self.calls for _, s, e, lay in c.ops
                    if lay == layer)
        return total / 1e3 / len(self.calls)

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for c in self.calls:
            for name, s, e, _ in c.ops:
                key = short(name)
                by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device seconds by what the host was doing, told apart by the
        call markers: from one call's last operation to the next call's
        start (the engine building its results and returning, and the
        harness), from a call's start to its first operation, and inside a
        call, named by the operation that ended the gap."""
        after = "from a call's last device op to the next call's start"
        before = "from a call's start to its first device op"
        by: dict = {}

        def add(key, us):
            if us > 0:
                by[key] = by.get(key, 0.0) + us / 1e6

        prev_end = None
        for c in self.calls:
            ops = sorted(c.ops, key=lambda o: o[1])
            if prev_end is not None:
                add(after, min(c.start_us, ops[0][1] if ops else c.start_us)
                    - prev_end)
                prev_end = max(prev_end, c.start_us)
            else:
                prev_end = c.start_us
            for i, (name, s, e, _) in enumerate(ops):
                add(before if i == 0 else f"in a call, before {short(name)}",
                    s - prev_end)
                prev_end = max(prev_end, e)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda x: -x[1])[:top]


def read(records, call_walls_ms: list[float], layer_map: dict) -> Trace:
    """Split a window's device records into its calls (``call_walls_ms``:
    the host-clock time of each call made, in order). A long spin before
    the first marker is the lead-in's, one after the last marker the
    window's close; where the close was lost the window ends with its last
    record."""
    spins = [(s, e) for n, s, e in records if SPIN in n]
    leads = [sp for sp in spins if sp[1] - sp[0] < SHORT_US]
    longs = [sp for sp in spins if sp[1] - sp[0] >= LONG_US]
    marks = [sp for sp in spins if SHORT_US <= sp[1] - sp[0] < LONG_US]
    first = marks[0][0] if marks else float("inf")
    last = marks[-1][0] if marks else float("inf")
    lead_long = any(s < first for s, _ in longs)
    lead_lost = max(0, LEAD_IN + 1 - len(leads) - int(lead_long))
    closes = [s for s, _ in longs if s > last]
    close = closes[0] if closes else max((e for _, _, e in records),
                                         default=0.0)
    ops = [(n, s, e) for n, s, e in records
           if SPIN not in n and first <= s < close]
    # the records lost at the window's head are the first calls' markers:
    # the markers that arrived belong to the last calls made
    walls = call_walls_ms[len(call_walls_ms) - len(marks):] if marks else []
    calls = []
    j = 0
    for i, (m0, _) in enumerate(marks):
        m1 = marks[i + 1][0] if i + 1 < len(marks) else close
        mine = []
        while j < len(ops) and ops[j][1] < m1:
            mine.append(ops[j])
            j += 1
        layers = classify([n for n, _, _ in mine], layer_map)
        calls.append(CallTrace(walls[i], m0, [
            (n, s, e, lay) for (n, s, e), lay in zip(mine, layers)]))
    window_s = (close - first) / 1e6 if marks else 0.0
    busy_s = union_us((s, e) for _, s, e in ops) / 1e6
    return Trace(calls, window_s, busy_s, lead_lost,
                 len(call_walls_ms) - len(marks))
