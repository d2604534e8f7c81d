"""One command line over the port's entry points (counterpart of
`python -m t2onet_tpu`): `python -m t2onet_tpu_torch <command> [args...]`.

Each command is also `python -m t2onet_tpu_torch.cli.<module>`. Every
command runs on the card unless it is given `--device cpu`.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    # training
    "train-fivek": ("cli.train_fivek", "FiveK seq2seqL1 trainer"),
    "test-fivek": ("cli.test_fivek", "FiveK eval: L1/SSIM/FID + variance"),
    "train-gier": ("cli.train_gier", "GIER seq2seqL1 trainer"),
    "test-gier": ("cli.test_gier", "GIER eval"),
    "train-gan": ("cli.train_gan", "T2ONet+D (conditional GAN) trainer"),
    "train-actor-fs": ("cli.train_actor_fs", "supervised-only ablation"),
    "train-rl": ("cli.train_rl", "REINFORCE fine-tuning"),
    "train-inpaint": ("cli.train_inpaint", "inpainting backend trainer"),
    "train-supervisor": ("cli.train_supervisor",
                         "crash-restarting trainer wrapper"),
    # planning
    "plan-fivek": ("cli.plan_fivek", "FiveK pseudo-ground-truth planner"),
    "plan-gier": ("cli.plan_gier", "GIER planner (mask-conditioned)"),
    "plan-fleet": ("cli.plan_fleet", "multi-worker planner fan-out"),
    # inference / serving
    "demo": ("cli.demo", "single-image request -> edit program"),
    "serve": ("cli.serve", "batched HTTP serving engine"),
    # utilities
    "convert": ("cli.convert", "reference model.pth -> run directory"),
    "op-sweep": ("cli.op_sweep", "per-operator parameter sweeps"),
}
# the commands whose main returns an exit code; the others return their
# results (a trainer its state, a planner its count), and exit with 0
EXIT_CODE_COMMANDS = ("train-supervisor",)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        width = max(len(c) for c in COMMANDS)
        lines = "\n".join(f"  {c:<{width}}  {desc}"
                          for c, (_, desc) in COMMANDS.items())
        print("usage: python -m t2onet_tpu_torch <command> [args...]\n\n"
              f"commands:\n{lines}\n\n"
              "run `python -m t2onet_tpu_torch <command> --help` for its "
              "flags")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r} — run `python -m t2onet_tpu_torch "
              f"help`", file=sys.stderr)
        return 2
    mod = importlib.import_module(f"t2onet_tpu_torch.{COMMANDS[cmd][0]}")
    ret = mod.main(rest)
    return ret if cmd in EXIT_CODE_COMMANDS else 0


if __name__ == "__main__":
    raise SystemExit(main())
