"""Failure detection and restart for long training runs (counterpart of
`t2onet_tpu.cli.train_supervisor`).

It wraps any trainer CLI: when the training process exits non-zero it
starts it again with `--resume` appended (the port's trainers resume from
their latest checkpoint), after a delay that doubles with each crash, up
to a crash budget.

  python -m t2onet_tpu_torch.cli.train_supervisor --max_restarts 5 -- \
      python -m t2onet_tpu_torch.cli.train_fivek --synthetic \
      --num_iters 10000 ...
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser()
    p.add_argument("--max_restarts", type=int, default=5)
    p.add_argument("--backoff", type=float, default=10.0,
                   help="initial restart delay (doubles per crash)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the training command")
    a = p.parse_args(argv)
    cmd = a.cmd[1:] if a.cmd and a.cmd[0] == "--" else a.cmd
    if not cmd:
        p.error("no training command given (use -- python -m ...)")

    restarts = 0
    delay = a.backoff
    while True:
        launch = list(cmd)
        if restarts > 0 and "--resume" not in launch:
            launch.append("--resume")
        print(f"[supervisor] launching (attempt {restarts + 1}): "
              f"{' '.join(launch)}", flush=True)
        t0 = time.time()
        proc = subprocess.run(launch)
        dt = time.time() - t0
        if proc.returncode == 0:
            print(f"[supervisor] training completed in {dt:.0f}s")
            return 0
        restarts += 1
        if restarts > a.max_restarts:
            print(f"[supervisor] giving up after {a.max_restarts} restarts "
                  f"(last exit {proc.returncode})")
            return proc.returncode
        # a long healthy run before the crash resets the backoff
        if dt > 600:
            delay = a.backoff
        print(f"[supervisor] exit {proc.returncode} after {dt:.0f}s; "
              f"restarting in {delay:.0f}s (resume from latest checkpoint)",
              flush=True)
        time.sleep(delay)
        delay = min(delay * 2, 600)


if __name__ == "__main__":
    sys.exit(main())
