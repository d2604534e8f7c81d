"""Run one cell of BENCHMARK.json once and print its result's line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`: each number compared with its limit. The last lines
of standard error give the same numbers and limits.

The run fails, and prints no result, where PyTorch finds no CUDA card or
fewer than the cell asks for, and where JAX, flax or the JAX package is
loaded once the window has closed. The kernels' build goes to
`benchmark/_build` in the checkout.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, not this directory, is where imports resolve
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)
os.environ["T2ONET_TORCH_BUILD_DIR"] = os.path.join(HERE, "_build")
os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import Run, forbidden_modules, load_module

    run = Run(args, T_START)
    import torch

    # one intra-op thread: the host's work is the program's Python
    # threads, and idle workers spinning beside them make runs spread
    torch.set_num_threads(1)

    chips = run.entry["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA card(s); PyTorch finds "
              f"{found}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    run.install_kernel_log()
    driver = load_module(os.path.join(HERE, "drivers",
                                      f"{run.traffic['kind']}.py"),
                         f"driver_{run.traffic['kind']}")
    outcome = driver.run(run)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark runs "
              f"without JAX and the JAX package", file=sys.stderr)
        return 3
    run.power_line()
    line = run.result(outcome)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 - no result line on any failure
        traceback.print_exc()
        code = 1
    sys.exit(code)
