"""A cell by its name: its entry in ``BENCHMARK.json``, its configuration
file, its traffic mix, its own file under ``workloads/``, and the metrics it
reports, each found by name in files of its own."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold ``-``)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    key = f"_bench_{kind}_{name}".replace("-", "_").replace(".", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    own: dict  # workloads/<name>.json: the check's sample and limits
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def generator(self):
        return load_module("traffic", self.traffic["generator"])


def load(name: str, root: str = ROOT) -> Cell:
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in spec["workloads"])
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {known})")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(BENCH_DIR, "traffic",
                                   f"{entry['traffic']}.json")),
        own=_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json")),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )
