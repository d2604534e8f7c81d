"""GIER evaluation (counterpart of `t2onet_tpu.cli.test_gier`; protocol
of the reference's experiments/t2onet/test_GIER_seq2seqL1.py): the FiveK
eval CLI on GIER's test requests at native resolution, with GIER's
defaults (session 3, op horizon 8, data modes global+shapeAlign).

  python -m t2onet_tpu_torch.cli.test_gier --data_dir data_real_gier \\
      --glove_path data_real_gier_acts/GIER_vocabs_glove_feat_3.npy \\
      --run_dir output/GIER_trial_1
"""

from __future__ import annotations

from t2onet_tpu_torch.cli import test_fivek


def eval_parser():
    p = test_fivek.eval_parser()
    p.set_defaults(dataset="GIER", session=3, decoder_max_len=8)
    p.add_argument("--data_mode", default="global+shapeAlign",
                   help="'+'-combined filters: valid/shapeAlign/"
                        "shapeAlign_nonCrop/global/full")
    return p


def main(argv=None) -> dict:
    """Evaluate; returns the metrics (and the variance)."""
    return test_fivek.main(argv, parser=eval_parser())


if __name__ == "__main__":
    main()
