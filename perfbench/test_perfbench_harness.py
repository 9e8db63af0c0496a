"""The harness's files, its lookup of every cell, the contract's form of
BENCHMARK.json, the result line and the module check (CPU)."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.modcheck import forbidden_modules

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_lookup(cell):
    c, cfg, traffic, e2e, layer = harness.load_cell(BENCH, cell)
    conf = {x["name"]: x for x in BENCH["configs"]}[c["config"]]
    assert cfg == json.load(open(os.path.join(ROOT, conf["file"])))
    assert cfg["query"]["engine"] in ("sortjoin", "gather")
    assert traffic["mode"] in ("quant", "type1", "type2")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert names <= {"reads_per_s", "device_ms_per_mread", "setup_s"}, \
        "the harness computes each end-to-end metric it prints"
    assert layer, "every cell reports a per-layer metric"
    for m in layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in names, "a cell reports what its per-layer metrics move"


def test_unknown_cell():
    with pytest.raises(SystemExit):
        harness.load_cell(BENCH, "no-such-cell")


def _short_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert all(_short_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _short_line(c["source"])
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        # the source and the cuts live in BENCHMARK.json alone; the file
        # says why each cut was made
        assert not {"name", "source", "reduced"} & set(cfg)
        assert all(NAME.match(k) and k in cfg["assumed"] for k in c["reduced"])
        names.add(c["name"])
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _short_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    assert len(pairs) == len(BENCH["workloads"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _short_line(m["layer"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_module_check():
    assert forbidden_modules(["cammiq_tpu_torch", "cammiq_tpu_torch.x", "numpy",
                              "perfbench.harness", "benchmark", "jax_like"]) == []
    bad = ["cammiq_tpu", "cammiq_tpu.x", "jax", "jaxlib.xla_client", "flax",
           "bench", "benchmarks.realized_free"]
    assert forbidden_modules(bad) == sorted(bad)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    """No harness file imports JAX or the JAX package; the reference imports
    nothing of the port either."""
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py") or f.startswith("test_"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "cammiq_tpu", "bench",
                               "benchmarks"}, path
            if os.path.basename(dirpath) == "reference":
                assert "cammiq_tpu_torch" not in tops, path


def test_needs_a_card():
    """Without CUDA the harness exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert r.returncode != 0 and r.stdout.strip() == ""
