"""Shared CLI plumbing: flags -> Config, the device and its precision,
datasets, actor construction, scalar logging (counterpart of the
trainers' and evals' parts of `t2onet_tpu.cli.common`). The flags are
the JAX CLI's, with its defaults, `--device` in place of `--cpu`, and
`--glove_path` for hosts without h5py. As in JAX, the ResNet's depth has
no flag: a Bottleneck encoder is reached through `ModelConfig`."""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from t2onet_tpu_torch.config import (Config, ModelConfig, OperatorConfig,
                                     TrainConfig)
from t2onet_tpu_torch.parallel import mesh
from t2onet_tpu_torch.precision import set_cuda_precision


def add_base_args(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda", help="torch device: cuda "
                   "(the default), cuda:N or cpu; cuda where PyTorch finds "
                   "no card raises")
    # run / data
    p.add_argument("--dataset", default="FiveK")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--trial", type=int, default=1)
    p.add_argument("--session", type=int, default=1)
    p.add_argument("--action_id", type=int, default=1)
    p.add_argument("--act_dir", default=None,
                   help="planner actions dir (default output/actions_set_N,"
                        " GIER: output/GIER_actions_set_N)")
    p.add_argument("--data_dir", default="data",
                   help="root holding FiveK/, GIER/, language/")
    p.add_argument("--glove_path", default=None,
                   help="GloVe word matrix, .h5 or an .npy copy (default "
                        "{data_dir}/language/{dataset}_vocabs_glove_feat_"
                        "{session}.h5, used when it exists)")
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
    p.add_argument("--fix_input_embedding", type=int, default=1,
                   help="freeze the GloVe word rows, train only the 4 "
                        "special rows (downgraded to 0 when no GloVe "
                        "matrix is loaded)")
    p.add_argument("--resnet_widths", default=None,
                   help="comma-separated ResNet stage widths (default "
                        "64,128,256,512); shrink for tiny smoke runs")
    p.add_argument("--vis_feat_dim", type=int, default=None,
                   help="vis-encoder output feature dim (default 512)")
    p.add_argument("--discrete_param", type=int, default=0,
                   help="classify each scalar op param over discrete_step "
                        "bins (the reference's discrete_param)")
    p.add_argument("--discrete_step", type=int, default=10)
    p.add_argument("--vis_bf16", type=int, default=0,
                   help="run the vis encoder's convolutions and "
                        "activations in bfloat16; params and BatchNorm "
                        "statistics stay f32")
    # operator ranges
    p.add_argument("--exposure_range", type=float, default=3.5)
    p.add_argument("--sharpness_range", type=float, default=1.5)
    p.add_argument("--brightness_range", type=float, default=2.0)
    p.add_argument("--curve_steps", type=int, default=8)
    return p


def resolve_device(name: str) -> torch.device:
    """`--device` as a torch.device. An entry point runs on the card
    unless its caller asks for the CPU: asking for CUDA where PyTorch finds
    no card raises, rather than carry on on the CPU. A CUDA device also
    turns TF32 off (`set_cuda_precision`)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: PyTorch finds no CUDA "
                               f"card here; pass --device cpu to run on the "
                               f"CPU")
        set_cuda_precision()
    return device


def resolve_fused_exec(flag: int, device: torch.device) -> bool:
    """`--fused_exec`: 1 executes each rollout step through the fused step
    (the chain kernel on a CUDA tensor, its plain version on the CPU), 0
    through the one-hot bank, -1 (the default) the kernels on a CUDA
    device and the bank on the CPU."""
    return device.type == "cuda" if flag == -1 else bool(flag)


def add_data_parallel_arg(p: argparse.ArgumentParser):
    """The trainers' `--data_parallel` (JAX's, int, default 1)."""
    p.add_argument("--data_parallel", type=int, default=1,
                   help="> 0: under torchrun, each process trains as a rank "
                        "of the data-parallel group on its rows of the "
                        "global --batch_size (one process: one device)")
    return p


def join_data_parallel(a):
    """`--data_parallel` (JAX's flag: > 0 shards the batch over every
    device): under torchrun's environment this process joins the
    data-parallel group as its rank (`parallel.mesh.init_data_parallel`:
    NCCL on `cuda:{LOCAL_RANK}`, gloo with `--device cpu`, torch's
    default timeout for collectives), and the global
    `--batch_size` must divide by the world size. With one process and
    more than one card visible it says that it trains on one card and how
    to start a rank a card. Returns (device, joined)."""
    if not mesh.launched_by_torchrun():
        device = resolve_device(a.device)
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        if a.data_parallel > 0 and n > 1:
            print(f"data parallelism: one process trains on {device} of the "
                  f"{n} visible cards; start one rank a card with "
                  f"`torchrun --nproc_per_node {n} -m <this module> ...`")
        return device, False
    w = int(os.environ["WORLD_SIZE"])
    if a.data_parallel <= 0:
        if w > 1:
            raise SystemExit(f"--data_parallel {a.data_parallel} under "
                             f"torchrun's {w} ranks: each would train alone")
        return resolve_device(a.device), False
    if a.batch_size % w:
        raise SystemExit(f"--batch_size {a.batch_size} not divisible by the "
                         f"world size {w}")
    resolve_device(a.device)
    device = mesh.init_data_parallel(a.device, timeout=None)
    if mesh.rank() == 0:
        print(f"data-parallel over {w} rank(s) "
              f"({torch.distributed.get_backend()}), "
              f"{a.batch_size // w} rows a rank")
    return device, True


def rank0_print():
    """print on data-parallel rank 0 (and in one process); a no-op on the
    other ranks."""
    return print if mesh.rank() == 0 else (lambda *args, **kwargs: None)


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
        fix_input_embedding=bool(a.fix_input_embedding),
        discrete_param=bool(a.discrete_param),
        discrete_step=a.discrete_step, vis_bf16=bool(a.vis_bf16),
        **({"resnet_widths": tuple(
            int(x) for x in a.resnet_widths.split(","))}
           if a.resnet_widths else {}),
        **({"vis_feat_dim": a.vis_feat_dim} if a.vis_feat_dim else {}))
    ops = OperatorConfig(
        exposure_range=a.exposure_range, sharpness_range=a.sharpness_range,
        brightness_range=a.brightness_range, curve_steps=a.curve_steps)
    # an eval CLI has no training flags: TrainConfig's defaults stand
    train = TrainConfig(**{k: getattr(a, k) for k in (
        "batch_size", "num_iters", "learning_rate", "explore_prob",
        "print_every", "checkpoint_every") if hasattr(a, k)},
        train_img_size=a.img_size, seed=a.manual_seed)
    return Config(operators=ops, model=model, train=train,
                  dataset=a.dataset, session=a.session)


def resolve_run_dir(a, record: bool = True) -> str:
    """The run directory (default output/{dataset}_trial_{trial}), made if
    missing. With `record` the flags go to its opt.json; a read-only CLI
    (eval) passes record=False, so that the opt.json stays the record of
    the flags that trained the run's checkpoints."""
    run_dir = a.run_dir or f"output/{a.dataset}_trial_{a.trial}"
    os.makedirs(run_dir, exist_ok=True)
    if record:
        with open(os.path.join(run_dir, "opt.json"), "w") as f:
            json.dump(vars(a), f, indent=2, default=str)
    return run_dir


# the synthetic set's op names by vocab id (t2onet_tpu.cli.common's)
SYNTHETIC_ID2OP = dict(enumerate(
    ["<NONE>", "<START>", "<END>", "brightness", "contrast", "saturation",
     "hue", "inpaint_obj", "tint", "sharpness", "color_bg"]))


def _glove_rows(a, vocab_dir: str):
    """The GloVe matrix from --glove_path, else from the .h5 beside the
    vocabularies when it exists, else None."""
    from t2onet_tpu_torch.data.text import load_embedding

    glove = a.glove_path or os.path.join(
        vocab_dir, f"{a.dataset}_vocabs_glove_feat_{a.session}.h5")
    return load_embedding(glove) if os.path.exists(glove) else None


def build_vocab_only(a):
    """(vocab2id, id2op, GloVe matrix or None) without the dataset's
    annotations or images: what a CLI that edits a user's image needs to
    tokenize (the demo, as the JAX CLI's)."""
    if a.synthetic:
        from t2onet_tpu_torch.data.synthetic import synthetic_vocab

        return synthetic_vocab(), dict(SYNTHETIC_ID2OP), None
    from t2onet_tpu_torch.data.text import load_vocab

    vocab_dir = os.path.join(a.data_dir, "language")
    vocab2id, _, _, id2op = load_vocab(vocab_dir, a.dataset, a.session)
    return vocab2id, id2op, _glove_rows(a, vocab_dir)


def build_dataset_and_vocab(a, phase: str = "train",
                            eval_img_mode: str = "native",
                            wire_u8: bool = False):
    """(dataset, vocab2id, id2op, GloVe matrix or None), as the JAX CLI's.

    The synthetic set; or from {data_dir}/{dataset} and
    {data_dir}/language: the train split with the planner's actions
    (`GIERDatasetAct`, `FiveKAct`; uint8 images with wire_u8) from
    --act_dir (default output/GIER_actions_set_N,
    output/actions_set_N), val/test without (`GIERDataset`, `FiveK`).
    eval_img_mode (val/test): 'native' loads short-side-600
    images at their own shapes (batch 1), 'train_size' square images at
    --img_size that batch. The GloVe rows come from --glove_path, else
    from the .h5 beside the vocabularies when it exists."""
    if a.synthetic:
        from t2onet_tpu_torch.data.synthetic import (SyntheticFiveK,
                                                     synthetic_vocab)

        n = a.synthetic_n if phase == "train" else max(a.synthetic_n // 8, 16)
        seed = {"train": 0, "val": 1, "test": 2}[phase]
        ds = SyntheticFiveK(n=n, img_size=a.img_size, seed=seed,
                            req_max_len=a.encoder_max_len,
                            op_max_len=a.decoder_max_len)
        return ds, synthetic_vocab(), dict(SYNTHETIC_ID2OP), None
    from t2onet_tpu_torch.data.text import load_vocab

    vocab_dir = os.path.join(a.data_dir, "language")
    vocab2id, _, _, id2op = load_vocab(vocab_dir, a.dataset, a.session)
    wire = np.uint8 if wire_u8 else np.float32
    if a.dataset == "GIER":
        from t2onet_tpu_torch.data.gier import GIERDataset, GIERDatasetAct

        gier_dir = os.path.join(a.data_dir, "GIER")
        data_mode = getattr(a, "data_mode", "global")
        if phase == "train":
            act_dir = a.act_dir or f"output/GIER_actions_set_{a.action_id}"
            ds = GIERDatasetAct(
                gier_dir, vocab_dir, act_dir, phase, data_mode=data_mode,
                is_load_mask=bool(getattr(a, "is_load_mask", 0)),
                session=a.session, train_img_size=a.img_size,
                wire_dtype=wire)
        else:
            # planner actions exist for the train split only
            ds = GIERDataset(gier_dir, vocab_dir, phase, data_mode=data_mode,
                             session=a.session, train_img_size=a.img_size,
                             eval_img_mode=eval_img_mode)
    else:
        from t2onet_tpu_torch.data.fivek import FiveK, FiveKAct

        img_dir = os.path.join(a.data_dir, "FiveK", "images")
        anno_dir = os.path.join(a.data_dir, "FiveK", "annotations")
        if phase == "train":
            # planner actions exist for the train split only
            act_dir = a.act_dir or f"output/actions_set_{a.action_id}"
            ds = FiveKAct(img_dir, anno_dir, act_dir, phase, a.session,
                          a.img_size, op_max_len=a.decoder_max_len,
                          wire_dtype=wire)
        else:
            ds = FiveK(img_dir, anno_dir, phase, a.session, a.img_size,
                       eval_img_mode=eval_img_mode, wire_dtype=wire)
    return ds, vocab2id, id2op, _glove_rows(a, vocab_dir)


def build_actor(a, vocab_size: int, word2vec=None):
    """(Actor on the CPU, Config), weights drawn from a generator seeded
    with --manual_seed, the word rows from `word2vec` when given.
    --fix_input_embedding 1 without GloVe rows falls back to 0, as the
    JAX CLI does: random word rows frozen would leave the request encoder
    untrainable."""
    import dataclasses
    import warnings

    from t2onet_tpu_torch.models.actor import Actor

    cfg = args_to_config(a)
    if cfg.model.fix_input_embedding and word2vec is None:
        warnings.warn("--fix_input_embedding 1 without a GloVe embedding: "
                      "downgrading to 0 (nothing pretrained to freeze)")
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           fix_input_embedding=False))
    actor = Actor(cfg.model, cfg.operators, vocab_size,
                  generator=torch.Generator().manual_seed(a.manual_seed),
                  explore_prob=cfg.train.explore_prob, word2vec=word2vec)
    return actor, cfg


class ScalarLogger:
    """JSONL scalar log, one record per call: {"step", "time", ...}.
    `enabled=False` (a data-parallel rank other than 0) writes nothing."""

    def __init__(self, run_dir: str, name: str = "metrics",
                 enabled: bool = True):
        self.path = os.path.join(run_dir, f"{name}.jsonl")
        self._f = open(self.path, "a") if enabled else None

    def log(self, step: int, **scalars):
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
