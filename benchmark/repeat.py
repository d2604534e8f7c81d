"""Run a cell several times, one process a run as the driver runs it, and
summarise: each run's result in one line, then each metric's median and
spread (the distance between the first and third quartiles of
`statistics.quantiles(values, n=4)`, over the median).

    python3 benchmark/repeat.py --workload <name> --seeds 1 2 3 \\
        --seconds 20 [--trace 1] [--log chiprun_out/runs.jsonl]

`--log` appends every run's full result line and the end of its
standard error to that file.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--log", default=None)
    a = p.parse_args(argv)
    values = {}
    for seed in a.seeds:
        cmd = [sys.executable, os.path.join(HERE, "run.py"), "--workload",
               a.workload, "--seed", str(seed), "--seconds",
               str(a.seconds), "--trace", str(a.trace)]
        t = time.time()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.time() - t
        line = None
        lines = proc.stdout.strip().splitlines()
        if proc.returncode == 0 and lines:
            line = json.loads(lines[-1])
        short = {"workload": a.workload, "seed": seed, "rc": proc.returncode,
                 "wall_s": round(wall, 1)}
        if line is not None:
            short["correct"] = line["correct"]
            short["metrics"] = {k: v["value"]
                                for k, v in line["metrics"].items()}
            short["checks"] = {k: v["value"]
                               for k, v in line["checks"].items()}
            short["memory_peak_bytes"] = line["device"]["memory_peak_bytes"]
            for k in ("busy_s", "window_s"):
                if k in line["device"]:
                    short[k] = line["device"][k]
            for k, v in short["metrics"].items():
                values.setdefault(k, []).append(v)
        else:
            short["stderr_tail"] = proc.stderr[-3000:]
        print(json.dumps(short), flush=True)
        if a.log:
            with open(os.path.join(ROOT, a.log), "a") as f:
                f.write(json.dumps({"run": short, "line": line,
                                    "stderr": proc.stderr[-6000:]}) + "\n")
    for k, v in values.items():
        print(json.dumps({"metric": k, "n": len(v),
                          "median": statistics.median(v),
                          "spread": spread(v)}), flush=True)


if __name__ == "__main__":
    main()
