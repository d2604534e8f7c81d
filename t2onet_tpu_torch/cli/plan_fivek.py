"""Planner CLI: pseudo ground-truth action sequences for FiveK
(counterpart of `t2onet_tpu.cli.plan_fivek`): beam 3, ops
[0,1,2,3,5,6], err 1e-2, every candidate's parameters fitted by one
batched Adam per step on the device. Candidates are ranked by the L1 or
L2 pixel distance to the target, or with `--dist_type seq2seqGAN-disc`
by a trained text-conditioned discriminator: 1 - sigmoid(D(I_0, I_out |
request)) (reference beam_search.py:190-193, 226-236), from a
`cli.train_gan` run (`--disc_run_dir`) or a reference seq2seqGAN
model.pth (`--torch_gan_ckpt`).

  python -m t2onet_tpu_torch.cli.plan_fivek --data_dir data_real_h2h \\
      --img_size 128 --pair_batch 8 --manual_seed 10 \\
      --out_dir data_real_h2h_acts/actions_set_1
  python -m t2onet_tpu_torch.cli.plan_fivek --data_dir data_real_h2h \\
      --glove_path data_real_h2h_acts/FiveK_vocabs_glove_feat_1.npy \\
      --dist_type seq2seqGAN-disc --disc_run_dir output/gan \\
      --out_dir output/actions_disc
  python -m t2onet_tpu_torch.cli.plan_fivek --synthetic --limit 8 \\
      --device cpu --out_dir output/actions_set_1

It runs on the card (`--device cuda`, the default) and raises where
PyTorch finds none; `--device cpu` runs it on the CPU. The learned
distance plans one pair at a time. `--data_parallel N` splits each
lockstep batch's fits over the first N cards (`parallel.mesh`; it needs
`--pair_batch > 1`, and raises where fewer cards are visible; with
`--device cpu`, N entries of the CPU).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.parallel.mesh import make_mesh
from t2onet_tpu_torch.planner.beam import normalize_dist_type
from t2onet_tpu_torch.planner.generate import (plan_dataset,
                                               plan_dataset_batched)

DISC_DIST = "seq2seqgan-disc"


def dist_type(value: str) -> str:
    """--dist_type: l1 / l2 ('L1'/'L2' accepted)."""
    try:
        return normalize_dist_type(value)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def any_dist_type(value: str) -> str:
    """plan_fivek's --dist_type: a pixel distance, or the learned
    'seq2seqGAN-disc' ('disc' accepted)."""
    if value.lower() in (DISC_DIST, "disc"):
        return DISC_DIST
    return dist_type(value)


def add_plan_args(p: argparse.ArgumentParser, learned: bool = False):
    """The flags both planner CLIs share, with the JAX CLIs' defaults;
    `learned` lets --dist_type name the disc distance (plan_fivek)."""
    p.add_argument("--phase", default="train")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--start", type=int, default=0,
                   help="first pair index (for sharding the index range)")
    p.add_argument("--beam_size", type=int, default=3)
    p.add_argument("--n_starts", type=int, default=2)
    p.add_argument("--n_iters", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--pair_batch", type=int, default=1,
                   help=">1: lockstep-batch pairs into one device fit")
    p.add_argument("--dist_type", default="l1",
                   type=any_dist_type if learned else dist_type,
                   help="l1 / l2 pixel distance (reference 'L1'/'L2')"
                        + (" or seq2seqGAN-disc" if learned else ""))
    return p


def plan_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    add_plan_args(p, learned=True)
    p.add_argument("--out_dir", default="output/actions_set_1")
    p.add_argument("--err", type=float, default=1e-2)
    p.add_argument("--mode", default="plain",
                   choices=["plain", "eps", "fixed"])
    p.add_argument("--disc_run_dir", default=None,
                   help="cli.train_gan run dir (--dist_type "
                        "seq2seqGAN-disc)")
    p.add_argument("--torch_gan_ckpt", default=None,
                   help="reference seq2seqGAN model.pth: its actor and "
                        "discriminator drive the disc distance")
    p.add_argument("--which_ckpt", default="best",
                   help="best / latest / an explicit actor checkpoint path")
    p.add_argument("--num_D", type=int, default=2)
    p.add_argument("--n_layers_D", type=int, default=3)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="shard the lockstep pair fits over this many "
                        "devices (needs --pair_batch > 1)")
    return p


def build_disc_distance(a, vocab2id, w2v, device):
    """The learned distance's hooks, (score_fn, score_aux_fn), from a
    train_gan run's actor and discriminator (or a reference model.pth):
    a candidate scores 1 - sigmoid(D(I_0, I_out | request)), the
    reference's load_seq2seqgan_disc (beam_search.py:52-63).

    Both run in eval mode: train-mode BatchNorm1d on a single request
    would normalise the condition code to a constant, erasing the text,
    and a train-mode discriminator would couple each candidate's score to
    the rest of the fitting batch."""
    from t2onet_tpu_torch.cli.train_gan import build_disc
    from t2onet_tpu_torch.convert import load_torch_gan_checkpoint
    from t2onet_tpu_torch.data.text import txt2idx
    from t2onet_tpu_torch.models.gan import make_disc_planner_score
    from t2onet_tpu_torch.train.checkpoint import (StateCheckpointer,
                                                   restore_actor)

    if not a.disc_run_dir and not a.torch_gan_ckpt:
        raise SystemExit("--dist_type seq2seqGAN-disc needs --disc_run_dir "
                         "(a cli.train_gan run directory) or "
                         "--torch_gan_ckpt (a reference model.pth)")
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    bundle = build_disc(a, "cpu")
    if a.torch_gan_ckpt:
        load_torch_gan_checkpoint(a.torch_gan_ckpt, actor=actor,
                                  bundle=bundle)
    else:
        ckpt_dir = os.path.join(a.disc_run_dir, "seq2seqGAN_model")
        restore_actor(actor, ckpt_dir, a.which_ckpt)
        # an explicit --which_ckpt names the actor's file; the
        # discriminator's twin has its basename in disc/
        d_which = a.which_ckpt
        if d_which not in ("best", "latest"):
            d_which = os.path.join(ckpt_dir, "disc", os.path.basename(
                os.path.normpath(d_which)))
        bundle.load_state_dict(StateCheckpointer(
            os.path.join(ckpt_dir, "disc")).restore(d_which))
    actor = actor.to(device).eval().requires_grad_(False)
    bundle = bundle.to(device).eval().requires_grad_(False)
    score_fn = make_disc_planner_score(bundle.netD)

    @torch.no_grad()
    def score_aux_fn(img_x, request):
        x = txt2idx(request, vocab2id, a.encoder_max_len)[0]
        x = torch.from_numpy(x.astype(np.int64))[None].to(device)
        cond = bundle.cond_encoder(actor.lang_encoder(x)[1][0])
        return (torch.from_numpy(np.array(img_x, np.float32)).to(device),
                cond)

    return score_fn, score_aux_fn


def main(argv=None):
    """Plan; returns the number of pairs written."""
    a = plan_parser().parse_args(argv)
    device = common.resolve_device(a.device)
    disc = a.dist_type == DISC_DIST
    if disc and a.pair_batch > 1:
        raise SystemExit("--dist_type seq2seqGAN-disc plans pairs one at a "
                         "time (drop --pair_batch)")
    if a.data_parallel > 1 and a.pair_batch <= 1:
        raise SystemExit("--data_parallel shards the lockstep pair fits — "
                         "it needs --pair_batch > 1")
    mesh = None
    if a.data_parallel > 1:
        mesh = make_mesh(n_devices=a.data_parallel, device=device)
        print(f"data-parallel planning over {mesh}")

    vocab2id = w2v = None                 # read only by the disc distance
    if a.synthetic:
        ds, vocab2id, _, w2v = common.build_dataset_and_vocab(a, a.phase)

        def pairs():
            for i in range(a.start, len(ds)):
                img, imgs, _, _, _, req = ds.make_item(i)
                yield img[None], imgs[-1][None], req
    else:
        # planning comes before the actions exist: the plain pair reader,
        # every split at train_size, so that every fit has one shape
        from t2onet_tpu_torch.data.fivek import FiveK

        ds = FiveK(os.path.join(a.data_dir, "FiveK", "images"),
                   os.path.join(a.data_dir, "FiveK", "annotations"),
                   a.phase, a.session, a.img_size,
                   eval_img_mode="train_size")

        def pairs():
            for i in range(a.start, len(ds)):
                img_x, img_y, _, req = ds[i]
                yield img_x[None], img_y[None], req

    kw = dict(beam_size=a.beam_size, err=a.err, mode=a.mode,
              n_starts=a.n_starts, n_iters=a.n_iters, lr=a.lr,
              seed=a.manual_seed, device=device)
    score_aux_fn = None
    if disc:
        if vocab2id is None:
            vocab2id, _, w2v = common.build_vocab_only(a)
        kw["score_fn"], score_aux_fn = build_disc_distance(a, vocab2id, w2v,
                                                           device)
    else:
        kw["dist_type"] = a.dist_type
    if a.pair_batch > 1:
        return plan_dataset_batched(pairs(), a.out_dir, phase=a.phase,
                                    pair_batch=a.pair_batch, limit=a.limit,
                                    start_index=a.start, mesh=mesh, **kw)
    return plan_dataset(pairs(), a.out_dir, phase=a.phase, limit=a.limit,
                        start_index=a.start, score_aux_fn=score_aux_fn, **kw)


if __name__ == "__main__":
    main()
