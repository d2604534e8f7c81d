"""Export a run directory of the JAX package's trainers as a run directory
of the PyTorch port, so that the port's evals, demo, server, planner and
`--resume` read it as one of their own runs.

    python scripts/torch_export_jax_run.py --cpu --run_dir output/jax_run \
        --out_dir output/port_run --synthetic
    python scripts/torch_export_jax_run.py --cpu --kind gan \
        --run_dir output/jax_gan --out_dir output/port_gan --data_dir data

`--run_dir` is the JAX run (its orbax `seq2seqL1_model/`, or for `--kind
gan` `seq2seqGAN_model/` with its `disc/` twin); the geometry comes from
the JAX trainers' flags, the vocab from the dataset flags or
`--vocab_size`. Every step checkpoint and `checkpoint_best` become the
port's `checkpoint_iter{itr:08d}.pt` and `checkpoint_best.pt`: the
actor's weights and BatchNorm statistics
(`t2onet_tpu_torch.convert.load_jax_variables`), the step, and the Adam
moments (`jax_adam_to_torch`); `stats.json` is copied. For a GAN run the
discriminator and condition encoder go to `disc/`
(`disc_variables_to_state_dict`); the G and D optimizers' `gan_opt/` is
not exported, so a port `train_gan --resume` of the export starts their
moments afresh. This script imports both packages; the port itself
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_STEP_RE = re.compile(r"^checkpoint_iter(\d+)$")


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.array, tree)


def export_ckpt_dir(src, dst, jstate, actor, state):
    """Each orbax checkpoint of src (a JAX CheckpointManager dir) as a
    port checkpoint in dst; returns the names written."""
    from t2onet_tpu.train.checkpoint import CheckpointManager as JaxManager
    from t2onet_tpu_torch.convert import jax_adam_to_torch, load_jax_variables
    from t2onet_tpu_torch.train.checkpoint import _save

    os.makedirs(dst, exist_ok=True)
    manager = JaxManager(src)
    named = [(n, p) for n, p in actor.named_parameters() if p.requires_grad]
    written = []
    for name in sorted(os.listdir(src)):
        if not (_STEP_RE.match(name) or name == "checkpoint_best"):
            continue
        js = manager.restore(jstate, os.path.join(src, name))
        params, stats = _numpy(js.params), _numpy(js.batch_stats)
        load_jax_variables(actor, params, stats)
        adam = js.opt_state[0]
        opt = jax_adam_to_torch(state.opt, named, int(adam.count),
                                _numpy(adam.mu), _numpy(adam.nu), stats,
                                actor.cfg)
        _save({"step": int(js.step),
               "model": {k: v.clone() for k, v in actor.state_dict().items()},
               "optimizer": opt}, os.path.join(dst, f"{name}.pt"))
        written.append(f"{name}.pt")
    if os.path.exists(os.path.join(src, "stats.json")):
        shutil.copy(os.path.join(src, "stats.json"),
                    os.path.join(dst, "stats.json"))
    return written


def export_disc_dir(src, dst, a):
    """Each orbax disc/ checkpoint of a JAX GAN run as the port's
    discriminator state_dict in dst."""
    import jax
    import jax.numpy as jnp

    from t2onet_tpu.cli.train_gan import DiscBundle as JaxBundle
    from t2onet_tpu.train.checkpoint import PytreeCheckpointer
    from t2onet_tpu_torch.cli.train_gan import build_disc
    from t2onet_tpu_torch.convert import load_jax_disc
    from t2onet_tpu_torch.train.checkpoint import _save

    jb = JaxBundle(ndf=64, n_layers=a.n_layers_D, num_D=a.num_D)
    d_params, d_bs = jb.init(
        jax.random.PRNGKey(a.manual_seed + 7),
        jnp.zeros((1, 6, a.img_size, a.img_size)),
        jnp.zeros((a.n_layers, 1, 2 * a.hidden_size)))
    ckpt = PytreeCheckpointer(src)
    bundle = build_disc(a, "cpu")
    os.makedirs(dst, exist_ok=True)
    written = []
    for name in sorted(os.listdir(src)):
        if not (_STEP_RE.match(name) or name == "checkpoint_best"):
            continue
        tree = ckpt.restore({"d_params": d_params, "d_batch_stats": d_bs},
                            os.path.join(src, name))
        load_jax_disc(bundle, _numpy(tree["d_params"]),
                      _numpy(tree["d_batch_stats"]))
        _save({k: v.clone() for k, v in bundle.state_dict().items()},
              os.path.join(dst, f"{name}.pt"))
        written.append(f"{name}.pt")
    return written


def main(argv=None):
    """Export; returns {directory written: [file names]}."""
    from t2onet_tpu.cli import common as jax_common

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    jax_common.add_base_args(p)
    p.add_argument("--out_dir", required=True,
                   help="the port run directory to write")
    p.add_argument("--kind", choices=("actor", "gan"), default="actor")
    p.add_argument("--vocab_size", type=int, default=0,
                   help="skip the vocab files and use this size")
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    a = p.parse_args(argv)
    jax_common.maybe_force_cpu(a)
    if not a.run_dir:
        p.error("--run_dir (the JAX run directory) is required")

    import jax
    import jax.numpy as jnp
    import torch

    from t2onet_tpu.train.loop import create_train_state
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.models.actor import Actor
    from t2onet_tpu_torch.train.loop import TrainState

    if a.vocab_size:
        vocab_size, w2v = a.vocab_size, None
    else:
        vocab2id, _, w2v = jax_common.build_vocab_only(a)
        vocab_size = len(vocab2id)
    jactor, cfg = jax_common.build_actor(a, vocab_size, w2v)
    jstate = create_train_state(
        jactor, jax.random.PRNGKey(a.manual_seed),
        jnp.zeros((1, a.encoder_max_len), jnp.int32),
        jnp.zeros((1, 3, a.img_size, a.img_size)))
    actor = Actor(ModelConfig(**dataclasses.asdict(cfg.model)),
                  OperatorConfig(**dataclasses.asdict(cfg.operators)),
                  vocab_size, generator=torch.Generator().manual_seed(0))
    state = TrainState(actor)
    ckpt_name = "seq2seqL1_model" if a.kind == "actor" else \
        "seq2seqGAN_model"
    src = os.path.join(a.run_dir, ckpt_name)
    dst = os.path.join(a.out_dir, ckpt_name)
    out = {dst: export_ckpt_dir(src, dst, jstate, actor, state)}
    if a.kind == "gan":
        out[os.path.join(dst, "disc")] = export_disc_dir(
            os.path.join(src, "disc"), os.path.join(dst, "disc"), a)
    for d, names in out.items():
        print(f"exported {len(names)} checkpoints -> {d}")
    return out


if __name__ == "__main__":
    main()
