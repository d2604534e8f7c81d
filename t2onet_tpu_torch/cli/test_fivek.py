"""FiveK evaluation: greedy rollout, L1 and SSIM, the variance probe and
the HTML gallery (counterpart of `t2onet_tpu.cli.test_fivek`; protocol of
the reference's experiments/t2onet/test_seq2seqL1.py).

Real data is evaluated per pair at native resolution (short side 600):
each input is edge-padded to a 64-px bucket, rolled out alone, cropped
back, and scored on the host at its true size. `--synthetic` evaluates
the synthetic test set in batches of 16. Then the variance probe runs
16 images under the 10 canonical requests. The weights come from
`{run_dir}/{ckpt_name}/checkpoint_best.pt` (`--checkpoint best`, the
default), the newest step checkpoint (`latest`) or a file; with none
there the random init is evaluated, with a warning.

On a CUDA device (`--device cuda`, the default; it raises where PyTorch
finds no card) each rollout step executes through the fused step, whose
forward is the chain kernel at K=1 (`--fused_exec`, -1: the kernels on
CUDA, the bank on the CPU). With `--fid_inception_ckpt` (InceptionV3
weights under torchvision's names) the metrics add FID: the inputs' and
the outputs' pool3 features against the ground truths'
(`--fid_variant 1`, the default, is pytorch-fid's patched network).

  python -m t2onet_tpu_torch.cli.test_fivek --data_dir data_real_h2h \\
      --glove_path data_real_h2h_acts/FiveK_vocabs_glove_feat_1.npy \\
      --run_dir output/FiveK_trial_1 --visualize 1
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.data.loader import device_put_batch
from t2onet_tpu_torch.data.text import txt2idx
from t2onet_tpu_torch.evals.bucketing import (crop_valid, fit_within,
                                              pad_to_bucket)
from t2onet_tpu_torch.evals.html import HTML
from t2onet_tpu_torch.evals.metrics import TEST_TXTS, ImageEvaluator
from t2onet_tpu_torch.evals.visualize import update_web_row
from t2onet_tpu_torch.train.checkpoint import restore_actor
from t2onet_tpu_torch.train.loop import eval_episode


def _device(actor) -> torch.device:
    return next(actor.parameters()).device


def _numpy(t):
    return None if t is None else t.cpu().numpy()


def _features_fn(a, device):
    """The FID extractor when --fid_inception_ckpt names weights, else
    None (no FID, as the reference without the .pth)."""
    ckpt = getattr(a, "fid_inception_ckpt", None)
    if not ckpt:
        return None
    from t2onet_tpu_torch.evals.inception import load_fid_inception

    return load_fid_inception(ckpt, device,
                              fid_variant=bool(getattr(a, "fid_variant", 1)))


def test_native_res(actor, ds, a, id2op, run_dir: str = "output/test",
                    visualize: bool = False, quantum: int = 64,
                    fused_exec: bool = False,
                    records: Optional[list] = None) -> dict:
    """Per-pair eval at native resolution (the reference's batch-1 loop
    over short-side-600 images): an image whose long side exceeds 1024 is
    downscaled with its ground truth first, then edge-padded to a
    `quantum` bucket and rolled out on the actor's device; the output is
    cropped back and L1 and SSIM computed on the host at the true size
    (and with --fid_inception_ckpt the three images' FID features).
    A gallery row every 25 pairs with `visualize`. `records`, when given,
    gets one dict per pair: its program (op ids), its metrics and the
    host-clock seconds of its stages (load: decode, resize, pad; rollout:
    upload, the rollout and the readback of the output; metrics, which
    hold the FID features' features_s; gallery)."""
    device = _device(actor)
    evaluator = ImageEvaluator(host_metrics=True,
                               features_fn=_features_fn(a, device))
    webpage = None
    if visualize:
        webpage = HTML(os.path.join(run_dir, "test", "web"),
                       f"inference result trial {a.trial}")
    for i in range(len(ds)):
        t0 = time.perf_counter()
        item = ds[i]
        if isinstance(item, dict):          # GIERDataset items
            img_x, img_y = item["input"], item["output"]
            req_idx = np.asarray(item["request_idx"])
            req = item["request"]
        else:                               # FiveK tuples
            img_x, img_y, req_idx, req = item
        if max(img_x.shape[1:]) > 1024:
            # short side 600 with a long side past 1024: downscale the
            # pair rather than crop it, so the metrics see every pixel
            img_x = fit_within(img_x, 1024)
            img_y = fit_within(img_y, 1024)
        padded, valid_hw = pad_to_bucket(img_x, quantum)
        h, w = valid_hw
        t1 = time.perf_counter()
        batch = {"x": torch.from_numpy(req_idx.astype(np.int32))[None]
                 .to(device),
                 "img_x": torch.from_numpy(padded)[None].to(device)}
        pred, out = eval_episode(actor, batch, fused_exec=fused_exec)
        pred_c = crop_valid(pred, valid_hw)[0].cpu().numpy()
        t2 = time.perf_counter()
        m = evaluator.update(img_x[None, :, :h, :w], pred_c[None],
                             img_y[None, :, :h, :w])
        t3 = time.perf_counter()
        if (i + 1) % 64 == 0:
            print(f"eval {i + 1}/{len(ds)} pairs", flush=True)
        if webpage is not None and i % 25 == 0:
            update_web_row(webpage, i, req, img_x,
                           _numpy(crop_valid(out["imgs"][0], valid_hw)),
                           _numpy(out["ops"][0]), _numpy(out["params"][0]),
                           id2op, gt_img=img_y,
                           attn=None if out["attn"] is None
                           else _numpy(out["attn"][0]))
        t4 = time.perf_counter()
        if records is not None:
            records.append(dict(m, ops=out["ops"][0].tolist(),
                                load_s=t1 - t0, rollout_s=t2 - t1,
                                metrics_s=t3 - t2, gallery_s=t4 - t3))
    if webpage is not None:
        webpage.save()
    return evaluator.eval()


def test(actor, ds, a, id2op, visualize: bool = False,
         run_dir: str = "output/test", fused_exec: bool = False) -> dict:
    """Batched eval of a fixed-size set (synthetic): every item once, in
    batches of 16 with a short tail; metrics on the actor's device; a
    gallery row every 10 samples with `visualize`."""
    device = _device(actor)
    evaluator = ImageEvaluator(features_fn=_features_fn(a, device))
    webpage = None
    if visualize:
        webpage = HTML(os.path.join(run_dir, "test", "web"),
                       f"inference result trial {a.trial}")
        webpage.add_header(f"Visualization of result for trial {a.trial}")
    sample_id = 0
    for batch in ds.batches(16, 0, shuffle=False, sequential=True):
        b = device_put_batch({"x": batch["x"], "img_x": batch["img_x"],
                              "gt": batch["img_y"][:, -1]}, device)
        pred, out = eval_episode(actor, b, fused_exec=fused_exec)
        for i in range(pred.shape[0]):
            evaluator.update(b["img_x"][i:i + 1], pred[i:i + 1],
                             b["gt"][i:i + 1])
            if webpage is not None and sample_id % 10 == 0:
                update_web_row(
                    webpage, sample_id, batch["req"][i],
                    _numpy(b["img_x"][i]), _numpy(out["imgs"][i]),
                    _numpy(out["ops"][i]), _numpy(out["params"][i]),
                    id2op, gt_img=_numpy(b["gt"][i]),
                    attn=None if out["attn"] is None
                    else _numpy(out["attn"][i]))
            sample_id += 1
    if webpage is not None:
        webpage.save()
    return evaluator.eval()


def test_variance(actor, ds, a, vocab2id, n_images: int = 16,
                  fused_exec: bool = False,
                  records: Optional[list] = None) -> float:
    """How much the output depends on the request: each of the first
    `n_images` inputs rolled out under the 10 canonical requests
    (`TEST_TXTS`) in one batch, the variance over the 10 outputs averaged
    over pixels and images (reference test_seq2seqL1.py:99-142).
    `records`, when given, gets one dict per image: its 10 programs (op
    ids) and its variance."""
    device = _device(actor)
    reqs = np.concatenate(
        [txt2idx(t, vocab2id, a.encoder_max_len) for t in TEST_TXTS], 0)
    x = torch.from_numpy(reqs.astype(np.int32)).to(device)
    avg_var, n = 0.0, 0
    for batch in ds.batches(1, n_images, shuffle=False):
        img = torch.from_numpy(batch["img_x"]).to(device)
        imgs = img.repeat(len(TEST_TXTS), 1, 1, 1)
        pred, out = eval_episode(actor, {"x": x, "img_x": imgs},
                                 fused_exec=fused_exec)
        var = float(pred.var(dim=0, correction=0).mean())
        n += 1
        avg_var += (var - avg_var) / n
        if records is not None:
            records.append({"ops": out["ops"].tolist(), "variance": var})
    print(f"avg var: {avg_var:.6f}")
    return avg_var


def eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    p.add_argument("--visualize", type=int, default=0)
    p.add_argument("--checkpoint", default="best",
                   help="best, latest, or a checkpoint file")
    p.add_argument("--ckpt_name", default="seq2seqL1_model",
                   help="checkpoint subdirectory of the run dir: "
                        "seq2seqGAN_model evaluates a train_gan actor")
    p.add_argument("--skip_variance", action="store_true")
    p.add_argument("--fused_exec", type=int, default=-1, choices=(-1, 0, 1),
                   help="execute each rollout step through the fused step "
                        "(the chain kernel on CUDA) instead of the one-hot "
                        "bank. -1 (default): on for a CUDA device, off on "
                        "the CPU")
    p.add_argument("--fid_inception_ckpt", default=None,
                   help=".pth of InceptionV3 weights (torchvision names: "
                        "pt_inception-2015-12-05 or torchvision's): adds "
                        "FID")
    p.add_argument("--fid_variant", type=int, default=1,
                   help="1: pytorch-fid's patched network (the reference's "
                        "default), 0: plain torchvision")
    return p


def main(argv=None, parser=None) -> dict:
    """Evaluate; returns the metrics (and the variance). `parser`
    defaults to `eval_parser()` (cli/test_gier.py passes its own)."""
    a = (parser or eval_parser()).parse_args(argv)
    device = common.resolve_device(a.device)
    run_dir = common.resolve_run_dir(a, record=False)

    ds, vocab2id, id2op, w2v = common.build_dataset_and_vocab(a, "test")
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    ckpt_dir = os.path.join(run_dir, a.ckpt_name)
    if os.path.exists(os.path.join(ckpt_dir, "checkpoint_best.pt")) or \
            a.checkpoint not in ("best", "latest"):
        path = restore_actor(actor, ckpt_dir, a.checkpoint)
        print(f"loaded checkpoint ({a.checkpoint}) from {path}")
    else:
        print("WARNING: no checkpoint found — evaluating random init")
    actor = actor.to(device).eval()
    fused = common.resolve_fused_exec(a.fused_exec, device)
    print(f"{len(ds)} test items on {device}; rollout executor: "
          f"{'fused step' if fused else 'one-hot bank'}")

    if a.synthetic:
        res = test(actor, ds, a, id2op, visualize=bool(a.visualize),
                   run_dir=run_dir, fused_exec=fused)
    else:
        res = test_native_res(actor, ds, a, id2op, run_dir=run_dir,
                              visualize=bool(a.visualize), fused_exec=fused)
    if not a.skip_variance:
        res["variance"] = test_variance(actor, ds, a, vocab2id,
                                        fused_exec=fused)
    print({k: round(float(v), 5) for k, v in res.items()})
    return res


if __name__ == "__main__":
    main()
