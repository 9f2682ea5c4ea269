"""Run one cell of the benchmark of ``ufm_torch`` once, and print its result.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads`` in ``BENCHMARK.json``) is a configuration
(``benchmark/configs/<config>.json``) under a traffic mix
(``benchmark/traffic/<traffic>.json``), held to the limits of
``benchmark/limits/<cell>.json``. The run makes its weights and inputs from
``--seed``, warms up (set-up), measures for ``--seconds``, and with
``--trace 1`` profiles a short steady stretch after the window. Then it frees
the system and compares what the timed path produced with the plain
reference (``benchmark/reference``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each read by
``benchmark/metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``,
and last ``compared``: each number compared beside its limit, which the last
lines of standard error repeat.

It refuses to run (exit code 2, no result) when the configuration's
reference module is unknown or breaks the contract of
``benchmark/reference/__init__.py``, without CUDA, or with fewer cards than
the cell asks for, and exits with code 3 and no result if JAX, flax or the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

PROCESS_START = time.time()


def _process_start() -> float:
    """The wall-clock time at which this process started (Linux), else the
    time this module began to run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return PROCESS_START


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ufm_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def metric_reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(ROOT, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metrics: end-to-end, or per-layer with ``trace``; a metric
    with ``workloads`` belongs only to the cells it lists."""
    return [m for m in bench["per_layer" if trace else "end_to_end"] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device, process_start: float,
             config_override=None, traffic_override=None):
    """Drive the cell once and return (its :class:`Run`, the result dict)."""
    import torch

    from benchmark.harness import check
    from benchmark.harness.cells import DRIVERS, Run

    bench = load_json("BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = config_override or load_json(conf_entry["file"])
    traffic = traffic_override or load_json("benchmark", "traffic", f"{entry['traffic']}.json")
    limits = check.load_limits(ROOT, cell)
    run = Run(cell, config, traffic, seed, seconds, trace, device, limits, process_start)
    DRIVERS[traffic["kind"]](run)

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    verdict = check.judge(run.values, limits)
    dev = torch.device(device)
    result = {
        "correct": verdict["correct"] and run.failed == 0 and run.attempted > 0,
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": entry["chips"],
            "memory_peak_bytes": run.memory_peak_bytes,
        },
    }
    if trace and run.stretch is not None:
        result["device"]["busy_s"] = run.stretch.busy_s()
        result["device"]["window_s"] = run.stretch.window_s
        result["breakdown"] = {"device_ops": run.stretch.top_device_ops(), "idle_gaps": run.stretch.idle_gaps()}
    result["compared"] = verdict["compared"]
    return run, result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    process_start = _process_start()
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import reference

    bench = load_json("BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(conf_entry["file"])
    try:
        reference.load(config)
    except reference.Refused as exc:
        print(f"configuration {entry['config']!r}: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"this cell needs {entry['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # the caller's process as the configuration states it deployed
    torch.set_num_threads(config["deployment"]["intra_op_threads"])
    run, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", process_start)
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark must not load were loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps({"run": {"setup_s": run.setup_s, "phases": run.phases, "window_s": run.window_s,
                              "reference_s": run.reference_s,
                              "readings": {k: v for k, v in run.readings.items() if not k.startswith("_")}}}),
          file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
