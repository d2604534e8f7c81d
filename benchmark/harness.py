"""What a run knows and does besides its driver: the cell's files found by
name, the set-up clock, the traced stretch, the memory peak, the metric
readers, the check of loaded modules, and the result's line.

Files, by the names in BENCHMARK.json:
- `benchmark/configs/<config>.json`: the model configuration as run;
- `benchmark/traffic/<traffic>.json`: the traffic mix or training job,
  whose "kind" names its driver, `benchmark/drivers/<kind>.py`;
- `benchmark/workloads/<cell>.json`: the cell's check (its sample and the
  limit of each number compared);
- `benchmark/metrics/<metric>.py`, or for `name.part` the reader of
  `name` when the first is absent: `read(readings)` returns the metric's
  value, or None where the run has nothing to read for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "t2onet_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, workload: str):
    """(workload entry, config entry) of a cell of BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, config


def reader_path(metric: str) -> str:
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{metric.split('.')[0]}.py")
    return path


def metrics_of(bench: dict, cell: str, trace: bool):
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run of one cell: what the drivers read and call."""

    def __init__(self, args, t_start: float, device: str = "cuda",
                 overrides=None):
        """`device` and `overrides` ({"model": {...}, "traffic": {...}},
        replacing those keys) serve the CPU rehearsals of the tests; a
        run of the benchmark takes neither."""
        self.t_start = t_start
        self.root = ROOT
        self.device = device
        self.seed = args.seed
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.bench = load_json(ROOT, "BENCHMARK.json")
        self.entry, config_entry = find_cell(self.bench, args.workload)
        self.name = args.workload
        self.config = load_json(ROOT, config_entry["file"])
        self.traffic = load_json(HERE, "traffic",
                                 f"{self.entry['traffic']}.json")
        self.cell = load_json(HERE, "workloads", f"{self.name}.json")
        overrides = overrides or {}
        self.config["model"].update(overrides.get("model", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.readings = {}
        self.setup_s = None
        self.memory_peak = None
        self._tracer = None
        self._trace_done = False
        self.kernels = None
        self.trace_summary = None

    # -- what the configuration and the traffic give -----------------------
    def model_config(self) -> dict:
        return self.config["model"]

    def op_config(self) -> dict:
        return self.config["operators"]

    def vocab(self) -> dict:
        return load_json(ROOT, self.config["vocab"])

    # -- the clocks ---------------------------------------------------------
    def mark_setup_done(self):
        self.setup_s = time.time() - self.t_start

    def phase(self, name: str):
        """A set-up phase ends: its seconds go to a note."""
        now = time.time()
        last = getattr(self, "_phase_t", self.t_start)
        self._phase_t = now
        self.note(f"set-up {name}: {now - last:.3f} s")

    @staticmethod
    def note(text: str):
        print(text, file=sys.stderr, flush=True)

    def sync(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def read_memory_peak(self):
        import torch

        self.memory_peak = (max(torch.cuda.max_memory_allocated(d)
                                for d in range(self.entry["chips"]))
                            if self.device == "cuda" else 0)

    # -- the traced stretch ---------------------------------------------------
    def install_kernel_log(self):
        if self.trace:
            from benchmark.kernels import KernelLog

            self.kernels = KernelLog()
            self.kernels.install()

    def trace_tick(self, elapsed: float):
        """Called from the driver's loop with the window's elapsed
        seconds: starts the traced stretch at the mix's `trace_at` share
        of the window and stops it `trace_s` later."""
        if not self.trace or self._trace_done:
            return
        start = self.traffic["trace_at"] * self.seconds
        if self._tracer is None and elapsed >= start:
            from benchmark.trace import Trace

            self._tracer = Trace(self.kernel_parts())
            self._tracer.start()
            self.kernels.recording = True
            self._trace_t0 = elapsed
        elif self._tracer is not None and \
                elapsed - self._trace_t0 >= self.traffic["trace_s"]:
            self.finish_trace()

    def finish_trace(self):
        if self._tracer is None or self._trace_done:
            return
        self.trace_summary = self._tracer.stop()
        self.kernels.recording = False
        self._trace_done = True
        least = self.kernels.least_seconds()
        self.readings["trace"] = self.trace_summary
        self.readings["kernel_least"] = least

    @staticmethod
    def kernel_parts():
        from benchmark.kernels import PARTS

        return tuple(PARTS.values())

    # -- the result ---------------------------------------------------------
    def power_line(self):
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=20).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            out = f"nvidia-smi not read: {e}"
        self.note(f"card and power limit: {out}")

    def result(self, outcome: dict) -> dict:
        import torch

        self.readings["setup_s"] = self.setup_s
        metrics = {}
        for m in metrics_of(self.bench, self.name, self.trace):
            mod = load_module(reader_path(m["name"]),
                              f"metric_{m['name'].replace('.', '_')}")
            value = mod.read(self.readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        limits = self.cell["limits"]
        numbers = outcome["numbers"]
        for k in sorted(set(numbers) - set(limits)):
            self.note(f"reading {k}: {numbers[k]!r} (not compared)")
        checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
                  for k in limits}
        correct = (outcome["failed"] == 0 and set(limits) <= set(numbers)
                   and all(v["value"] <= v["limit"] for v in checks.values()))
        cuda = self.device == "cuda"
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": self.entry["chips"],
                  "memory_peak_bytes": int(self.memory_peak)}
        line = {"correct": bool(correct), "attempted": outcome["attempted"],
                "failed": outcome["failed"], "metrics": metrics,
                "device": device}
        if self.trace and self.trace_summary is not None:
            device["busy_s"] = self.trace_summary["busy_s"]
            device["window_s"] = self.trace_summary["window_s"]
            line["breakdown"] = {
                "device_ops": self.trace_summary["device_ops"],
                "idle_gaps": self.trace_summary["idle_gaps"]}
        line["checks"] = checks
        return line
