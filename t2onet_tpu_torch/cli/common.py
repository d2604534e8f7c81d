"""Shared CLI plumbing: flags -> Config, actor construction, scalar logging
(counterpart of the trainer's parts of `t2onet_tpu.cli.common`). Only the
flags the synthetic trainer reads are here, with the JAX CLI's defaults
and `--device` in place of `--cpu`; the file datasets' flags and the
unported model modes (GloVe rows, discrete params, bf16 ResNet) come with
the code that reads them."""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from t2onet_tpu_torch.config import (Config, ModelConfig, OperatorConfig,
                                     TrainConfig)


def add_base_args(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda" if torch.cuda.is_available()
                   else "cpu", help="torch device: cuda (default when a "
                   "card is present), cuda:N or cpu")
    # run / data
    p.add_argument("--dataset", default="FiveK")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--trial", type=int, default=1)
    p.add_argument("--session", type=int, default=1)
    p.add_argument("--manual_seed", type=int, default=10)
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no image files needed)")
    p.add_argument("--synthetic_n", type=int, default=512)
    p.add_argument("--img_size", type=int, default=128)
    # model
    p.add_argument("--encoder_max_len", type=int, default=17)
    p.add_argument("--decoder_max_len", type=int, default=5)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--word_vec_dim", type=int, default=300)
    p.add_argument("--use_attention", type=int, default=1)
    p.add_argument("--bidirectional", type=int, default=1)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--operator_fc_dim", type=int, default=512)
    p.add_argument("--resnet_widths", default=None,
                   help="comma-separated ResNet stage widths (default "
                        "64,128,256,512); shrink for tiny smoke runs")
    p.add_argument("--vis_feat_dim", type=int, default=None,
                   help="vis-encoder output feature dim (default 512)")
    # operator ranges
    p.add_argument("--exposure_range", type=float, default=3.5)
    p.add_argument("--sharpness_range", type=float, default=1.5)
    p.add_argument("--brightness_range", type=float, default=2.0)
    p.add_argument("--curve_steps", type=int, default=8)
    return p


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_iters", type=int, default=10_000)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--explore_prob", type=float, default=0.05)
    p.add_argument("--print_every", type=int, default=100)
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--val_batches", type=int, default=8,
                   help="validation batches per checkpoint; 0 skips "
                        "in-training validation (no best tracking)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max_keep_ckpts", type=int, default=0,
                   help="prune all but the newest N step checkpoints "
                        "(0 keeps everything)")
    return p


def args_to_config(a) -> Config:
    model = ModelConfig(
        encoder_max_len=a.encoder_max_len, decoder_max_len=a.decoder_max_len,
        hidden_size=a.hidden_size, word_vec_dim=a.word_vec_dim,
        n_layers=a.n_layers, bidirectional=bool(a.bidirectional),
        use_attention=bool(a.use_attention),
        operator_fc_dim=a.operator_fc_dim,
        **({"resnet_widths": tuple(
            int(x) for x in a.resnet_widths.split(","))}
           if a.resnet_widths else {}),
        **({"vis_feat_dim": a.vis_feat_dim} if a.vis_feat_dim else {}))
    ops = OperatorConfig(
        exposure_range=a.exposure_range, sharpness_range=a.sharpness_range,
        brightness_range=a.brightness_range, curve_steps=a.curve_steps)
    train = TrainConfig(
        batch_size=a.batch_size, num_iters=a.num_iters,
        learning_rate=a.learning_rate, explore_prob=a.explore_prob,
        print_every=a.print_every, checkpoint_every=a.checkpoint_every,
        train_img_size=a.img_size, seed=a.manual_seed)
    return Config(operators=ops, model=model, train=train,
                  dataset=a.dataset, session=a.session)


def resolve_run_dir(a) -> str:
    """The run directory (default output/{dataset}_trial_{trial}), made if
    missing; the flags that produced it go to its opt.json."""
    run_dir = a.run_dir or f"output/{a.dataset}_trial_{a.trial}"
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "opt.json"), "w") as f:
        json.dump(vars(a), f, indent=2, default=str)
    return run_dir


def build_dataset_and_vocab(a, phase: str = "train"):
    """(dataset, vocab2id). The port has the synthetic dataset; the file
    datasets need the planner's action files and come with a later
    slice."""
    if not a.synthetic:
        raise NotImplementedError(
            "only --synthetic is ported: the FiveK/GIER training split "
            "needs the planner's action files (output/actions_set_N)")
    from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab

    n = a.synthetic_n if phase == "train" else max(a.synthetic_n // 8, 16)
    seed = {"train": 0, "val": 1, "test": 2}[phase]
    ds = SyntheticFiveK(n=n, img_size=a.img_size, seed=seed,
                        req_max_len=a.encoder_max_len,
                        op_max_len=a.decoder_max_len)
    return ds, synthetic_vocab()


def build_actor(a, vocab_size: int):
    """(Actor on the CPU, Config), weights drawn from a generator seeded
    with --manual_seed. The word rows are all trained: GloVe rows, the
    only ones the JAX CLI freezes, are not ported."""
    from t2onet_tpu_torch.models.actor import Actor

    cfg = args_to_config(a)
    actor = Actor(cfg.model, cfg.operators, vocab_size,
                  generator=torch.Generator().manual_seed(a.manual_seed),
                  explore_prob=a.explore_prob)
    return actor, cfg


class ScalarLogger:
    """JSONL scalar log, one record per call: {"step", "time", ...}."""

    def __init__(self, run_dir: str, name: str = "metrics"):
        self.path = os.path.join(run_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
