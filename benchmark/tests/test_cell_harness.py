"""The harness finds every cell, configuration, traffic mix and metric by
name; prints the contract's line; and fails, with no line, where it has no
card or where JAX was loaded."""

import json
import os
import subprocess
import sys

import pytest

from benchlib import cell as cells
from conftest import BENCH_DIR, BIG_SEED, ROOT, tiny

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_by_name(name):
    c = cells.load(name, ROOT)
    assert c.config["name"] == next(w["config"] for w in SPEC["workloads"]
                                    if w["name"] == name)
    assert callable(c.generator.plan)
    assert {"windows", "limits"} <= set(c.own["check"])
    assert "setup_s" in [m["name"] for m in c.end_to_end]
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(cells.load_module("metrics", m["name"]).read)


def test_every_metric_and_config_has_its_file():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           m["name"] + ".py"))
    for c in SPEC["configs"]:
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == \
            c["name"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="no cell"):
        cells.load("no-such-cell", ROOT)


def test_no_card_no_line():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         CELLS[0], "--seed", str(BIG_SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA card" in p.stderr


def test_the_result_line_keeps_the_contract():
    from benchlib.runner import run_cell

    c = tiny("aligned-10k-b128")
    out = run_cell(c, BIG_SEED, 0.5, False, device="cpu")
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert set(line["metrics"]) == {m["name"] for m in c.end_to_end} == {
        "windows_per_s", "answer_p95_ms", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, BENCH_DIR)
    import run

    sys.modules["tiresias_tpu_torch_x_probe"] = object()
    try:
        assert "tiresias_tpu_torch_x_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["tiresias_tpu_torch_x_probe"]
    sys.modules["jax.numpy"] = object()
    try:
        assert run.forbidden_modules() == ["jax.numpy"]
    finally:
        del sys.modules["jax.numpy"]


PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}, {tests!r}]
{body}
top = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps(top))
"""


def _top_level(body: str) -> set:
    code = PROBE.format(bench=BENCH_DIR, root=ROOT,
                        tests=os.path.join(BENCH_DIR, "tests"), body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    top = _top_level("import reference.dsp, reference.search, "
                     "reference.g711, benchlib.judge, control")
    assert not top & {"jax", "jaxlib", "flax", "tiresias_tpu",
                      "tiresias_tpu_torch"}


def test_a_run_loads_nothing_of_jax():
    top = _top_level(
        "from conftest import tiny, BIG_SEED\n"
        "from benchlib.runner import run_cell\n"
        "run_cell(tiny('aligned-10k-b128'), BIG_SEED, 0.3, False,"
        " device='cpu')")
    assert "tiresias_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "tiresias_tpu"}
