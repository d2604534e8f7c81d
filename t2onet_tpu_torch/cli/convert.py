"""Convert a reference PyTorch checkpoint into a port run directory
(counterpart of `t2onet_tpu.cli.convert`).

A reference `model.pth` state_dict is loaded by its own names (the LSTM
biases folded into one) and saved as a `cli.train_fivek` or
`cli.train_gan` run saves it, so that `test_fivek`, `demo`, `serve` and
`plan_fivek --disc_run_dir` read the converted weights with no extra
flag:

    python -m t2onet_tpu_torch.cli.convert --torch_ckpt model.pth \\
        --run_dir output/converted --synthetic
    python -m t2onet_tpu_torch.cli.test_fivek --run_dir output/converted ...

`--kind gan` also loads the discriminator's scales and the condition
encoder of a seq2seqGAN model.pth into the `disc/` twin that
`plan_fivek --dist_type seq2seqGAN-disc` restores. The geometry comes
from the trainers' flags; the vocab from the dataset flags, or
`--vocab_size` without any dataset. It runs on the card (`--device cuda`,
the default) and raises where PyTorch finds none.
"""

from __future__ import annotations

import argparse
import os
import shutil

import torch

from t2onet_tpu_torch.cli import common


def main(argv=None):
    """Convert; returns the checkpoint directory written."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_base_args(p)
    p.add_argument("--torch_ckpt", required=True,
                   help="reference model.pth (torch state_dict)")
    p.add_argument("--kind", choices=("actor", "gan"), default="actor",
                   help="actor = seq2seqL1 model.pth; gan = seq2seqGAN "
                        "model.pth (actor + multiscale D + cond encoder)")
    p.add_argument("--vocab_size", type=int, default=0,
                   help="skip dataset/vocab loading and use this size "
                        "(must match the checkpoint's embedding rows)")
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    a = p.parse_args(argv)
    device = common.resolve_device(a.device)
    run_dir = common.resolve_run_dir(a)

    from t2onet_tpu_torch.convert import (load_torch_checkpoint,
                                          load_torch_gan_checkpoint)
    from t2onet_tpu_torch.train.checkpoint import (CheckpointManager,
                                                   StateCheckpointer)
    from t2onet_tpu_torch.train.loop import TrainState

    if a.vocab_size:
        vocab_size, w2v = a.vocab_size, None
    else:
        vocab2id, _, w2v = common.build_vocab_only(a)
        vocab_size = len(vocab2id)
    actor, _cfg = common.build_actor(a, vocab_size, w2v)
    if a.kind == "actor":
        load_torch_checkpoint(a.torch_ckpt, actor)
        ckpt_name = "seq2seqL1_model"
    else:
        from t2onet_tpu_torch.cli.train_gan import build_disc

        keys = torch.load(a.torch_ckpt, map_location="cpu",
                          weights_only=True).keys()
        if not any(k.startswith("actor.") for k in keys):
            raise SystemExit(f"{a.torch_ckpt} holds no actor weights — "
                             "a disc-only checkpoint cannot seed a run dir")
        bundle = build_disc(a, "cpu")
        load_torch_gan_checkpoint(a.torch_ckpt, actor=actor, bundle=bundle)
        ckpt_name = "seq2seqGAN_model"
        StateCheckpointer(os.path.join(run_dir, ckpt_name, "disc")).save(
            bundle.to(device).state_dict(), 0, best=True)

    # a conversion replaces an earlier one whole: a stale stats.json would
    # keep best_val_dist 0.0, and 0.0 < 0.0 would never refresh
    # checkpoint_best.pt, which would go on serving the old weights
    ckpt_dir = os.path.join(run_dir, ckpt_name)
    for stale in ("stats.json", "checkpoint_best.pt"):
        path = os.path.join(ckpt_dir, stale)
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
    # val_dist 0.0 makes the weights checkpoint_best.pt, which test_fivek,
    # demo and serve restore by default
    state = TrainState(actor.to(device))
    CheckpointManager(ckpt_dir).save(state, 0, val_dist=0.0)
    n = sum(t.numel() for t in actor.parameters())
    print(f"converted {a.torch_ckpt} ({a.kind}, {n:,} params) -> {ckpt_dir}")
    return ckpt_dir


if __name__ == "__main__":
    main()
