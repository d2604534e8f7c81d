"""Ablation trainer: purely supervised, no episode-L1 phase (counterpart
of `t2onet_tpu.cli.train_actor_fs`; reference
experiments/t2onet-L1/train_actor_fs.py: teacher forcing only, op NLL +
param MSE). `cli.train_fivek` with `--fs_only`.

  python -m t2onet_tpu_torch.cli.train_actor_fs --synthetic ...
"""

from __future__ import annotations

import sys

from t2onet_tpu_torch.cli import train_fivek


def main(argv=None):
    """Train; returns the final TrainState."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--fs_only" not in argv:
        argv.append("--fs_only")
    return train_fivek.main(argv)


if __name__ == "__main__":
    main()
