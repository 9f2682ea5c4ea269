"""``BENCHMARK.json`` against the contract it is written to, the files it
names, the result line's schema, which modules a run loads, and a device
metric path without a card."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from bench_tiny import ROOT, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs_cells_and_files():
    bench = _bench()
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == [] and 1 <= len(c["why"]) <= 200 and len(c["source"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for part in (("traffic", f"{w['traffic']}.json"), ("limits", f"{w['name']}.json")):
            assert os.path.exists(os.path.join(ROOT, "benchmark", *part))
    assert {c for c, _ in pairs} == set(configs)


def test_metrics():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # every cell it lists reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    for cell in cells:  # setup_s, another end-to-end metric and a per-layer metric in every cell
        assert sum(cell in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])


def test_result_line_schema():
    _, result = run_tiny("ufm_base.predict_b1")
    assert list(result)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"latency_p95_ms", "pairs_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


FORBIDDEN = ("jax", "jaxlib", "flax", "ufm_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); from bench_tiny import run_tiny; "
            "run_tiny('ufm_refine.predict_b4'); run_tiny('ufm_base.train_b8')")
    assert not _loaded(code) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_system():
    code = ("import benchmark.reference.ufm, benchmark.reference.train, benchmark.harness.yardstick, "
            "benchmark.harness.check, benchmark.harness.trace, benchmark.harness.inputs")
    assert not _loaded(code) & {"ufm_torch", *FORBIDDEN}


def test_no_card_no_result():
    """Without CUDA the command refuses (exit 2) and prints no result; the
    profiled stretch fails rather than read the CPU."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ufm_base.predict_b1", "--seed", "1",
                          "--seconds", "1", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2 and out.stdout.strip() == ""
    from benchmark.harness.trace import profile_stretch

    with pytest.raises((RuntimeError, AssertionError)):
        profile_stretch(lambda i: None, 1, "cpu")
