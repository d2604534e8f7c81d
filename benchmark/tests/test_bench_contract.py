"""BENCHMARK.json keeps to the contract's shapes, and every cell's files
are found by name; a cell added as new files is found with no edit."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_every_cell_reports_what_it_must():
    e2e = BENCH["end_to_end"]
    for w in BENCH["workloads"]:
        names = [m["name"] for m in harness.metrics_of(BENCH, w["name"],
                                                       False)]
        assert "setup_s" in names and len(names) >= 2
        per = harness.metrics_of(BENCH, w["name"], True)
        assert per
        for m in per:
            moved = next(x for x in e2e if x["name"] == m["moves"])
            assert w["name"] in moved.get("workloads", [w["name"]])


def test_files_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        cfg = harness.load_json(ROOT, c["file"])
        assert {"model", "operators", "vocab"} <= set(cfg)
    for w in BENCH["workloads"]:
        mix = harness.load_json(harness.HERE, "traffic",
                                f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(harness.HERE, "drivers",
                                           f"{mix['kind']}.py"))
        cell = harness.load_json(harness.HERE, "workloads",
                                 f"{w['name']}.json")
        assert cell["limits"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert os.path.exists(harness.reader_path(m["name"])), m["name"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A copy of the benchmark with a new mix, a new cell, a new metric
    and its reader, each a new file, and entries added to BENCHMARK.json:
    the harness finds them, and no existing file changed."""
    copy = tmp_path / "repo"
    shutil.copytree(harness.HERE, copy / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: open(os.path.join(copy, "benchmark", p), "rb").read()
              for p in _files(copy / "benchmark")}
    mix = harness.load_json(harness.HERE, "traffic", "fivek_bulk.json")
    mix.update(loop="open", rate_per_s=30.0)
    (copy / "benchmark/traffic/fivek_slow.json").write_text(json.dumps(mix))
    (copy / "benchmark/workloads/fivek_serve_slow.json").write_text(
        json.dumps({"check": {"requests": 8},
                    "limits": {"missing": 0}}))
    (copy / "benchmark/metrics/queue_len.py").write_text(
        "def read(r):\n    return 1.0\n")
    bench["workloads"].append({"name": "fivek_serve_slow",
                               "config": "t2onet_fivek",
                               "traffic": "fivek_slow", "chips": 1,
                               "why": "a slower open loop"})
    bench["per_layer"].append({"name": "queue_len", "unit": "req",
                               "better": "lower", "source": "host_clock",
                               "layer": "serve.MicroBatcher",
                               "moves": "serve_req_per_s",
                               "workloads": ["fivek_serve_slow"]})
    bench["end_to_end"][0]["workloads"].append("fivek_serve_slow")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json, argparse, time\n"
        f"sys.path.insert(0, {str(copy)!r})\n"
        "from benchmark import harness\n"
        "a = argparse.Namespace(workload='fivek_serve_slow', seed=3, "
        "seconds=1.0, trace=1)\n"
        "r = harness.Run(a, time.time(), device='cpu')\n"
        "m = [x['name'] for x in harness.metrics_of(r.bench, r.name, True)]\n"
        "mod = harness.load_module(harness.reader_path('queue_len'), 'q')\n"
        "print(json.dumps([r.traffic['rate_per_s'], r.cell['limits'], m,"
        " mod.read({}), harness.HERE]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(copy), check=True)
    rate, limits, per_layer, value, here = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert rate == 30.0 and limits == {"missing": 0}
    assert per_layer == ["queue_len"] and value == 1.0
    assert here == str(copy / "benchmark")
    for p, data in before.items():
        assert open(os.path.join(copy, "benchmark", p), "rb").read() == data


def _files(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return out


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted(
    p for p in _files(harness.HERE) if p.endswith(".py")
    and not p.startswith("_build")))
def test_no_jax_and_a_reference_of_its_own(path):
    """No module imports jax, jaxlib, flax or the JAX package (top-level
    names compared whole); the reference imports nothing of the port."""
    top = _imports(os.path.join(harness.HERE, path))
    assert not top & {"jax", "jaxlib", "flax", "t2onet_tpu"}, path
    if path.startswith("reference"):
        assert "t2onet_tpu_torch" not in top, path
