"""GIER trainer (counterpart of `t2onet_tpu.cli.train_gier`): the FiveK
trainer's alternating protocol on GIER's requests, with GIER's defaults
(session 3, op horizon 8, 20k iterations, data modes
global+shapeAlign) and, with --is_load_mask 1, the local-edit masks in
the episode phase.

  python -m t2onet_tpu_torch.cli.train_gier --is_load_mask 1 \\
      --data_dir data_real_gier \\
      --act_dir data_real_gier_acts/GIER_actions_set_1 \\
      --data_mode shapeAlign
"""

from __future__ import annotations

from t2onet_tpu_torch.cli import train_fivek


def train_parser():
    p = train_fivek.train_parser()
    p.set_defaults(dataset="GIER", session=3, num_iters=20_000,
                   decoder_max_len=8)
    p.add_argument("--data_mode", default="global+shapeAlign",
                   help="'+'-combined filters: valid/shapeAlign/"
                        "shapeAlign_nonCrop/global/full")
    p.add_argument("--is_load_mask", type=int, default=0)
    return p


def main(argv=None):
    """Train; returns the final TrainState."""
    return train_fivek.main(argv, parser=train_parser())


if __name__ == "__main__":
    main()
