"""Multi-device dry run of the port (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`): the four surfaces of JAX's dry run
at tiny widths, each over n devices.

- The data-parallel supervised and episode steps and the GAN step: n
  rank processes over gloo on the CPU (`workers.run_ranks`), each on
  its rows of one global batch.
- The planner's lockstep batch over a mesh of n CPU entries
  (`batch_beam_search(mesh=)`).
- One serving micro-batch over the same mesh (`ServingEngine(mesh=)`).

It prints one `dryrun_multichip ok: ...` line.

    python -m t2onet_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

SIZE = 16
ENC_LEN = 12


def _actor():
    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.data.synthetic import synthetic_vocab
    from t2onet_tpu_torch.models.actor import Actor

    vocab = synthetic_vocab()
    cfg = ModelConfig.tiny(encoder_max_len=ENC_LEN, decoder_max_len=5)
    actor = Actor(cfg, OperatorConfig(), len(vocab),
                  generator=torch.Generator().manual_seed(0))
    return actor, vocab


def _batch(b):
    """The JAX dry run's constant batch, b rows."""
    t = 7
    gt_params = np.zeros((b, t - 2, 24), np.float32)
    gt_params[:, 0, 0] = 0.4
    return {
        "x": np.tile(np.array([[1, 5, 2] + [0] * (ENC_LEN - 3)], np.int64),
                     (b, 1)),
        "y": np.tile(np.array([[1, 3, 4, 2, 0, 0, 0]], np.int64), (b, 1)),
        "img_x": np.full((b, 3, SIZE, SIZE), 0.5, np.float32),
        "img_y": np.full((b, t - 1, 3, SIZE, SIZE), 0.55, np.float32),
        "gt_params": gt_params,
        "gt_img": np.full((b, 3, SIZE, SIZE), 0.55, np.float32)}


def training_surfaces(job, device):
    """A rank's side: one supervised, one sampled episode and one GAN step
    of the tiny actor on its rows of the global batch."""
    from t2onet_tpu_torch.cli.train_gan import GANState, gan_step
    from t2onet_tpu_torch.data.loader import device_put_batch
    from t2onet_tpu_torch.models.common import init_torch_defaults
    from t2onet_tpu_torch.models.gan import DiscBundle, Seq2SeqGANLosses
    from t2onet_tpu_torch.parallel import mesh
    from t2onet_tpu_torch.train import loop

    actor, _ = _actor()
    state = loop.TrainState(actor.to(device))
    batch = device_put_batch(mesh.rows_of(_batch(job["batch"])), device)
    gen = torch.Generator(device=device).manual_seed(0)
    sup = loop.supervised_step(state, {k: batch[k] for k in (
        "x", "y", "img_x", "img_y", "gt_params")})
    epi_batch = {k: batch[k] for k in ("x", "img_x", "gt_img")}
    epi = loop.episode_step(state, epi_batch, generator=gen)
    cfg = actor.cfg
    bundle = DiscBundle(cfg.n_layers * 2 * cfg.hidden_size, cond_nc=16,
                        ndf=8, n_layers=2, num_D=2)
    init_torch_defaults(bundle, torch.Generator().manual_seed(7))
    gan = GANState(bundle.to(device), state.params)
    losses = Seq2SeqGANLosses(n_layers=2, num_D=2, lambda_feat=10.0)
    gm = gan_step(state, gan, epi_batch, losses, generator=gen)
    return {"sup_loss": float(sup["loss"]), "epi_loss": float(epi["L1_loss"]),
            "gan_G": float(gm["G_loss"]), "gan_D": float(gm["D_loss"])}


def dryrun_multichip(n_devices: int, job_dir=None) -> dict:
    """Run the four surfaces over n devices and print one line."""
    from t2onet_tpu_torch.parallel.mesh import make_mesh
    from t2onet_tpu_torch.parallel.workers import run_ranks
    from t2onet_tpu_torch.planner.beam import batch_beam_search
    from t2onet_tpu_torch.serve import ServingEngine

    t0 = time.time()

    def log(msg):
        print(f"[dryrun +{time.time() - t0:6.1f}s] {msg}", flush=True)

    batch_size = 2 * n_devices
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks({"kind": "dryrun", "device": "cpu",
                           "batch": batch_size}, n_devices,
                          job_dir or os.path.join(tmp, "ranks"))
    r0 = ranks[0]
    for key in ("sup_loss", "epi_loss", "gan_G", "gan_D"):
        vals = [r[key] for r in ranks]
        if not np.isfinite(vals).all() or len(set(vals)) != 1:
            raise RuntimeError(f"dryrun: {key} differs over the ranks or "
                               f"is not finite: {vals}")
    log(f"data-parallel steps ok over {n_devices} ranks: "
        f"sup {r0['sup_loss']:.4f} epi {r0['epi_loss']:.4f} "
        f"GAN G {r0['gan_G']:.4f} D {r0['gan_D']:.4f}")

    m = make_mesh(n_devices=n_devices, device="cpu")
    rng = np.random.default_rng(0)
    i0 = rng.uniform(0.2, 0.8, (2 * n_devices, 3, SIZE, SIZE)).astype(
        np.float32)
    igt = np.clip(i0 * 1.3, 0.0, 1.0)
    plans = batch_beam_search(i0, igt, beam_size=2, operations=[0, 1],
                              max_step=2, n_starts=1, n_iters=4, mesh=m)
    dists = [acts[0][-1][2] if acts and acts[0] else float("nan")
             for acts, _ in plans]
    if len(plans) != len(i0) or not np.isfinite(dists).all():
        raise RuntimeError(f"dryrun: planner lockstep gave {dists}")
    log(f"planner lockstep ok: mean final dist {np.mean(dists):.4f}")

    actor, vocab = _actor()
    engine = ServingEngine(actor, vocab, mesh=m, decode_size=SIZE,
                           quantum=SIZE, max_side=4 * SIZE,
                           max_batch=n_devices, u8_wire=False, io_threads=2)
    imgs = [rng.uniform(0.2, 0.8, (3, 2 * SIZE, 2 * SIZE)).astype(np.float32)
            for _ in range(n_devices)]
    results = engine.edit_batch(imgs, ["brighten the image"] * n_devices)
    if len(results) != n_devices or not all(
            r.image.shape == (3, 2 * SIZE, 2 * SIZE)
            and np.isfinite(r.image).all() for r in results):
        raise RuntimeError("dryrun: the serving micro-batch failed")
    log(f"serving micro-batch ok: {len(results)} reqs, "
        f"{len(results[0].ops)} ops on req 0")
    out = {"mesh": n_devices, "sup_loss": r0["sup_loss"],
           "epi_loss": r0["epi_loss"], "plan_dist": float(np.mean(dists)),
           "gan_G": r0["gan_G"], "gan_D": r0["gan_D"],
           "serve_reqs": len(results)}
    print(f"dryrun_multichip ok: mesh=({n_devices}) "
          f"sup_loss={out['sup_loss']:.4f} epi_loss={out['epi_loss']:.4f} "
          f"plan_dist={out['plan_dist']:.4f} gan_G={out['gan_G']:.4f} "
          f"gan_D={out['gan_D']:.4f} serve_reqs={out['serve_reqs']}",
          flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
