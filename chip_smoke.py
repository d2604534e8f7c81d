"""Drive the PyTorch port's serving, training and evaluation paths once
on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 4b,serve_pipeline,http,inpaint,demo_plan
    python3 chip_smoke.py --phases gan,gan_plan,fid,pix2pixhd
    python3 chip_smoke.py --phases dp,mesh_serve,mesh_plan
    python3 chip_smoke.py --phases ops_extra,convert,supervisor,tp_heads
    python3 chip_smoke.py --phases inpaint,demo_plan,edges

The second form runs the named phases alone after phases 1-3 (the
eval's checkpoint that demo_plan reads is written without the eval) and
prints their results as one JSON line, with no kernels line and no ok
line. Phases (any failure exits non-zero): (any failure exits non-zero):

1. device: a CUDA card of compute capability 9.0, with TF32 off for
   matmuls and cuDNN convolutions so that f32 means f32 (the port's own
   switch, `precision.set_cuda_precision`, which its entry points set);
2. build: every kernel source of t2onet_tpu_torch/csrc/ with nvcc, one
   process per source, side by side;
3. host packages: which of cv2, PIL, h5py, matplotlib and scipy import
   (cv2 must: the datasets read JPEGs with it; scipy must: the eval's
   host SSIM; without h5py the GloVe matrices come from their .npy copies
   in data_real_gier_acts/ and data_real_h2h_acts/; without matplotlib
   the eval gallery draws its attention heatmaps with cv2);
4. chain kernel against plain: the chain kernel (B1) and its plain
   PyTorch version on the same tensors on the card, at the serving shapes,
   at the chain benchmark's (bench.py's draw: b128, 512 px, K5), at K=8
   and K=16 with an all-sharpness image (the largest halos), and at K=1
   as the trainer's fused step runs it (b64, 128 px, and b128 x 512 px,
   every slot), and at K=1 as the eval's rollout runs it (b1 on a real
   FiveK image edge-padded to its 640 x 640 bucket, every slot, and on a
   576 x 1024 bucket, and the variance probe's b10 at the image's own
   600 x 600, every slot among the 10), bit-exact (both round every
   multiply and add alone, in the same order), then both timed: call
   time (CUDA events around one wrapper call, `time_ms`) and the
   kernel's device time (a CUDA graph of 40 calls, `device_ms`), the
   eval's shapes slot by slot with the plain version's call time beside
   (phase 4b);
5. step backward against plain: the step_bwd kernel (B3) and its plain
   version at the trainer's shape (b64, 128 px, every slot), at
   b128 x 512 px and at odd shapes, on images with exact 0 / 0.5 / 1,
   gray and two-equal-channel patches and saturating brightness: d_img
   bit-exact (and so within 1e-6), d_params within 1e-5 of the image's
   largest d_params entry (both sum per-pixel f32 terms in f64, in
   different orders), and a second call identical bit for bit; both
   timed, the kernel by call and device time, with B1 at K=1 beside;
6. masked kernels against plain: the masked chain (B2) at b128 x 512 px
   x K5 (bench.py's draw, a mask binary in one half and fractional in
   the other), at K=1 at the GIER trainer's b64 x 128 px, at 2 x 33 x 97,
   at K=8 and on real GIER masks (RLE-decoded, resized); the masked step
   backward (B4) at b64 x 128 px, b128 x 512 px and odd shapes, with the
   tie patches half inside and half outside the mask; the checks of
   phases 4 and 5; under an all-ones mask B2 must equal B1 and B4 equal
   B3 bit for bit; both timed beside B1 and B3; then (6b) B3 and B4 on
   slot-uniform batches at b64 x 128 px, device time per slot against
   the bound of the bytes that slot moves; then (6c) B1 and B2 on
   slot-uniform chains at b64 x 128 px x K1 and B1 at b128 x 512 px x
   K5, device and call time per slot against its bound (bytes or
   instructions, whichever is larger; an unmasked chain with a white step
   need not read its input, nor run the steps before it);
7. serve: a full-width actor (ModelConfig() defaults, 918-token
   vocabulary, seeded random weights) behind ServingEngine on the card:
   32 requests over two shape buckets with the launch counters read
   around the run, two of them again on the CPU for parity, then the
   request rate over 64 requests at 512 px;
8. train: `t2onet_tpu_torch.cli.train_fivek --synthetic` at
   ModelConfig() widths, batch 64, 128 px, 8 iterations (4 of each
   phase) through the fused step kernels, with the launch counters read
   around the run: finite losses, changed weights, a checkpoint, and
   chain = step_bwd = 5 launches per episode iteration (the validation's
   greedy rollout adds 5 of chain); then each
   phase's step time on batches already on the card, and the episode
   step through the fused kernels against the bank;
9. card vs CPU: one episode step of a full-width actor from the same
   weights and the same Gumbel noise, b8 at 64 px, through the kernels
   on the card and the plain versions on the CPU;
10. GIER train: `t2onet_tpu_torch.cli.train_gier --is_load_mask 1` on
   the repo's real GIER data (data_real_gier, shapeAlign: 446 requests)
   and planner actions (data_real_gier_acts) at ModelConfig() widths,
   GloVe word rows frozen, decoder_max_len 8, batch 64, 128 px, 8
   iterations: finite losses, changed weights, frozen GloVe rows, a
   checkpoint, and chain_masked = step_bwd_masked = 8 launches per
   episode iteration, no unmasked step backward and 8 unmasked chains
   (the validation's greedy rollout, without masks); then the host's ms per
   batch, each phase's step time on batches already on the card, and
   the masked episode step's device time from torch.profiler;
11. GIER card vs CPU: one sampled masked episode step of a full-width
   GIER actor, b8 real items at 64 px with real local masks on every op
   (so that each executed step blends through one), the same
   weights and noise, B2/B4 on the card against the plain versions on
   the CPU, within phase 9's bounds;
12. FiveK eval: `t2onet_tpu_torch.cli.test_fivek` on the repo's 50 real
   FiveK test pairs (data_real_h2h, short side 600, 640 x 640 buckets)
   from a checkpoint_best.pt of a full-width seeded random actor (GloVe
   rows from the .npy), gallery on, then the variance probe: finite
   metrics, and chain = 5 launches per pair and per probe image, no
   other kernel; ms per pair on the host clock by stage (image load,
   rollout, host metrics, gallery), and the first 4 pairs' rollouts
   profiled (torch.profiler: their device time, and the chain kernel's
   device time and launches per pair); then the first 4 pairs and the
   first 2 probe images on the CPU from the same checkpoint (the fused
   step's plain version): the same programs, L1 and SSIM within 1e-4, the
   probe's variance within 1e-3 of the CPU's, relatively;
13. GIER eval: `t2onet_tpu_torch.cli.test_gier` on the real GIER test
   split (57 requests) the same way, 8 launches per request and per
   probe image;
14. FiveK planning: `t2onet_tpu_torch.cli.plan_fivek` on the first 16
   FiveK train pairs at the committed set's settings (b8 lockstep, 128
   px, seed 10; no kernel launched), held to the JAX planner's
   data_real_h2h_acts/actions_set_1: every top-beam op sequence equal or
   a near-tie (printed with JAX's beams), step distances within 1e-4,
   init distances within 1e-6, parameters within PLAN_PARAM_TOL, edit
   JPEGs within PLAN_PIXEL_TOL levels; pairs/s, s per lockstep batch,
   and one fit step's device ms (torch.profiler) and the card's idle
   share over it;
15. GIER planning: `cli.plan_gier` on the first 16 GIER shapeAlign train
   pairs (masks, all 8 ops, err 1e-3) the same way, against
   data_real_gier_acts/GIER_actions_set_1;
16. FiveK on real data: `cli.train_fivek` on data_real_h2h with the
   committed actions and the GloVe .npy at ModelConfig() widths, b64,
   128 px, 8 iterations with validation on real FiveK val: finite
   losses, frozen GloVe rows, step_bwd = 5 launches per episode
   iteration, chain the same plus 5 for the validation batch; the host's
   ms per b64 batch with the item cache cold and warm, each phase's step
   time on a real batch already on the card; then one supervised and
   one episode step on a real b8 batch at 64 px, card against CPU,
   within phase 9's bounds;
17. the actor's modes: `cli.train_fivek --synthetic` at ModelConfig()
   width, b64, 128 px, 4 iterations in each of f32, `--vis_bf16 1`,
   `--episode_probe 64`, `--discrete_param 1` and `--per_step_bn`
   (step_bwd = 10, chain = 10 + 5 for the validation batch, no masked
   kernel; finite losses), each phase's step time on a batch on the card
   and, for f32, bf16 and the probe, its device time with the
   convolutions' share and largest kernels (torch.profiler);
   bf16 against f32 on the card (train-BN features, one supervised
   step's gradients) within the bf16 bounds; one supervised and one
   sampled episode step of each mode, card against CPU at b8 x 64 px
   (the bins' noise fed too; bf16: the supervised step, bf16 bounds);
18. GIER in the new modes: `cli.train_gier --is_load_mask 1 --vis_bf16 1
   --episode_probe 64` on the real GIER data, 4 iterations: 8 launches
   of B2 and B4 per episode iteration, no B3, B1 for the validation
   only; step times;
19. ResNet-50 serving: a full-width random depth-50 actor behind
   ServingEngine(device="cuda"), 32 requests at 512 px (B1 once per
   micro-batch), the first 4 programs equal to the CPU's; the decode of
   a b8 micro-batch beside ResNet-18's, host clock and device time;
20. RL: `cli.train_rl --synthetic` at full width, b64, 128 px, 2 warmup
   and 6 RL iterations with parameter noise 0.6: no kernel but the
   validation's 5 chains; the RL step's time; one RL step card against
   CPU under the same noise, within phase 9's bounds;
21. serving pipeline: phase 7's actor behind ServingEngine and a
   MicroBatcher (linger 10 ms, pipeline depth 2): 8 threads submit 64
   requests over two buckets; every result as edit_batch's (ops, params
   within 1e-4, images within 1 level) and one B1 launch per
   micro-batch; the bank executor (use_pallas=False) and decode_native
   engines against the kernel's; device_compute_probe(512), req/s
   through the batcher beside edit_batch's in turns, launch_s and sync_s,
   one micro-batch's device ms and idle share (torch.profiler); a failed
   flush and a failed launch mark their requests, the batcher serves on;
22. HTTP: `cli.serve`'s engine and server on 127.0.0.1 behind its
   batcher, 16 concurrent POST /edit with 512 px PNGs (200 with PNGs of
   the input's shape), /healthz, 404 and 400; `cli.serve --bench 64
   --img_size 512` and its JSON line;
23. inpaint: `cli.train_inpaint` on data_real_h2h at the CLI's defaults
   for 100 iterations (finite falling loss, a checkpoint, held-out hole
   L1 below the blanked hole's); the train step's time; one step card
   against CPU from the same weights (loss 1e-5 relative; the card's
   gradients within 1e-5 of their norm of the CPU's f64 ones, each tensor
   within phase 9's per-tensor bound, and within 5e-4 of the CPU's f32
   ones, whose own rounding sits ~1.2e-4 from f64); EdgeConnect's full-width generators from random
   state_dicts at 256², card against CPU within 1e-4;
24. demo and planning with a filler: `cli.demo` on a real FiveK test
   image from phase 12's checkpoint (B1 once per rollout step, card
   against CPU), `--program` with a mask and each filler at 256², card
   against CPU within one level of the 8-bit images the demo encodes
   (the decoded JPEGs' gap printed), EdgeConnect's edges on the card one
   hysteresis launch an edge map call and none on the CPU or with the
   gated filler; `cli.plan_gier --inpaint_ckpt` on
   the 4 first shapeAlign train pairs with an inpaint mask at phase 15's
   128 px: every filler call of the card's search again on the CPU from
   the same input (outputs within 1e-4), and 2 of the pairs planned on
   the CPU, held as phase 15 holds plans; no kernel launched;
25. gan: `cli.train_gan` on data_real_h2h with the committed actions at
   ModelConfig() width, b64, 128 px, 8 iterations (4 GAN), a checkpoint
   with its disc/ and gan_opt/ twins: B1 and B3 exactly 5 each a GAN
   iteration (the rollout's fused steps) plus 5 B1 a validation batch
   (4), finite losses; a GAN iteration's host clock and device time
   (torch.profiler); one GAN iteration of a full-width actor and
   discriminator on a real b8 batch at 64 px, card against CPU (losses
   1e-5, gradients within phase 9's bounds), and the GAN half alone on a
   fixed fake, card f32 against CPU f64 (losses and the discriminator's
   and condition encoder's gradients 1e-5 of their norm, each tensor
   1e-4 of its own; G's image gradient 1e-3);
26. gan_plan: `cli.plan_fivek --dist_type seq2seqGAN-disc --disc_run_dir`
   on phase 25's run over the first 8 FiveK train pairs at 128 px (beam
   1, one start, 10 Adam steps), no kernel launched; 2 of them replanned
   on the CPU and held as phase 14 holds plans;
27. fid: `cli.test_fivek --fid_inception_ckpt` with a random InceptionV3
   (`make_random_inception_pth`) on phase 12's 50 pairs from its
   checkpoint, no variance probe: B1 5 a pair and no other kernel,
   finite FIDs, the features' share of a pair; 4 images' features card
   against CPU within 1e-4 of their norm;
28. pix2pixhd: `define_generator('global')` and `('local')` at the
   widths of pix2pixHD's 2048x1024 recipe, the global G on one 1024x512
   image and the local G on one 2048x1024 image, card against CPU within
   1e-4, ms a forward;
29. dp: (a) `cli.train_fivek --synthetic --data_parallel 1` at full
   width, b64, 128 px, 4 iterations, in this process as rank 0 of a
   world of 1 on NCCL (torchrun's environment set here), against the
   same run without a group: the final weights bit for bit, B1 = B3 = 5
   an episode iteration plus 5 B1 for the validation batch; an episode
   step's host and device ms with and without the group; the cross-rank
   BatchNorm's all-reduces an episode step would make, and one NCCL
   all-reduce's host clock at world size 1; (b) two ranks on cuda:0 over
   gloo (`parallel.workers`; both build the kernels cold into one fresh
   directory at once), 32 rows a rank of a global b64 at full width, 128
   px, the same noise fed: one supervised, one fused FiveK episode and
   one fused GIER masked episode step (real data), each held to the same
   step in one process within phase 9's bounds, the ranks' weights equal
   bit for bit; B1 5 + B3 5, then B2 8 + B4 8 a rank;
30. mesh_serve: `fused_chain_sharded` over [cuda:0, cuda:0] (plus every
   further card) against `fused_chain` at b128 x 512² x K5, unmasked and
   masked: bit-exact, one launch a shard; phase 7's actor behind
   `ServingEngine(mesh=)`, max_batch 8, 32 requests over two buckets:
   the single engine's programs, images within one level, one B1 a shard
   a micro-batch; req/s beside the single engine's;
31. mesh_plan: `batch_beam_search(mesh=[cuda:0, cuda:0])` on phase 14's
   16 FiveK pairs at b8 lockstep: each shard's plans bit for bit the
   single card's plans of that shard's pairs alone, and held to the
   single card's b8 plans as phase 14 holds plans (another batch size
   sums the fits' reductions in another order): where the ops agree,
   each step's distance within PLAN_DIST_TOL; where they part, the final
   distances within MESH_PART_TOL; no kernel; `cli.plan_fleet --workers
   2` on 8 pairs, then `--verify_only`;
32. ops_extra: the HSV round trip and exposure, bnw, blur, hue and white
   balance at b8 x 512², card f32 against CPU f64, forward and
   vector-Jacobian products (EXTRA_* bounds); `ops.reverse`'s fits
   (brightness, the strong-brightness plateau, contrast, sharpness <->
   blur) on the card against the CPU: the same success flag, parameters
   within REVERSE_PARAM_ATOL; `cli.op_sweep` on a FiveK image at 512²
   on the card: the CPU's file list and arrays; no kernel;
33. convert: a full-width actor's state_dict with nonzero second LSTM
   biases as a reference model.pth, `python -m t2onet_tpu_torch convert
   --kind actor` (the dispatcher, in this process), `test_fivek` from that
   run directory on the first 8 FiveK test pairs (B1 5 a pair and nothing
   else), its programs those of the actor in memory and its images within
   CONVERT_IMG_ATOL; `--kind gan` with the reference discriminator (ndf
   64, 3 layers, 2 scales): the disc/ twin equal to it;
34. supervisor: `cli.train_supervisor` around a full-width `train_fivek
   --synthetic` (b64 x 128², 8 iterations, a checkpoint every 4) that a
   wrapper it writes makes exit 1 once, after the checkpoint at 4: the
   restart takes --resume, keeps the numbering and finishes at 8, with
   B1 15 and B3 10 in the resumed run;
35. tp_heads: two gloo ranks on cuda:0 as a (1 x 2) grid, each computing
   and stepping four of the eight parameter heads, one supervised and one
   fused episode step at full width on b64 x 128²: each rank against one
   process within phase 9's bounds, B1 5 + B3 5 a rank, each rank's Adam
   holding moments for its own heads only; `python -m t2onet_tpu_torch
   help`;
36. edges: the hysteresis kernel (csrc/hysteresis.cu) at the EdgeConnect
   cell's b8 x 256²: on all 382 committed GIER images (resized by the
   trainers' reader, gray on the card) its edges equal the plain flood
   fill's on the same classes and `edge_maps` equals the host's
   `canny_edges`, pixel for pixel; one launch a call; the kernel's call and device time (a CUDA graph of 40 calls),
   the flood fill's call time and the bound of its bytes (a byte read and
   a byte written a pixel); `train-inpaint --backend edgeconnect` at b8 x
   256² for 4 iterations: finite losses, one launch an edge map (4
   iterations and 4 held-out batches), its three files read back by
   `load_edgeconnect` and its fill finite.

The last three lines of stdout are the kernels JSON line, the card's
name and power limit from nvidia-smi, and {"ok": true, "device": ...}.
Imports nothing of JAX and nothing of the JAX package.
"""

import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

from t2onet_tpu_torch.cli import common, train_fivek
from t2onet_tpu_torch.config import (FIVEK_VOCAB_SIZE, ModelConfig,
                                     OperatorConfig)
from t2onet_tpu_torch.data.fivek import load_infer_img_short_size_bounded
from t2onet_tpu_torch.data.loader import device_put_batch
from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab
from t2onet_tpu_torch.data.text import parse_sent
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.ops import bank, build, chain, hysteresis, step
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.precision import set_cuda_precision
from t2onet_tpu_torch.serve import ServingEngine
from t2onet_tpu_torch.train import loop
from t2onet_tpu_torch.train.checkpoint import CheckpointManager

CHAIN_ATOL = 0.0      # bit-exact: both round each op alone, in one order
STEP_IMG_ATOL = 1e-6
STEP_PARAM_RTOL = 1e-5
TRAIN_RUN_DIR = os.path.join("output", "chip_smoke_train")
SUP_KEYS = ("x", "y", "img_x", "img_y", "gt_params")   # a supervised batch
TEXTS = ["increase the brightness", "improve contrast",
         "increase saturation", "sharpen the image"]   # cli/serve.py's


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def reset_launches():
    for counts in (chain.LAUNCHES, hysteresis.LAUNCHES):
        for k in counts:
            counts[k] = 0


def logged_losses(path, keys=("op_loss", "param_loss", "L1_loss",
                              "val_L1")):
    """[(step, key, value)] of the JSONL scalar log at path."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], k, r[k]) for r in recs for k in keys if k in r]


def knots_near_one(actor):
    """Curve knots near 1 as a trained model's (tone range 0.5-2, color
    0.9-1.1): random heads put them near 0, where the curve's division
    by the knot sum magnifies rounding."""
    with torch.no_grad():
        actor.executor.color_op.fc2.bias += 1.0
        actor.executor.tone_op.fc2.bias += 1.0
    return actor


# -- phase 1 ------------------------------------------------------------------
def device_phase():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name}, compute capability {cap}, "
        f"{torch.cuda.device_count()} card(s); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    set_cuda_precision()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    log(f"TF32 off for matmul and cuDNN (allow_tf32: {tf32})")
    if any(tf32):
        fail("set_cuda_precision left TF32 on")
    return smi


# -- phase 2 ------------------------------------------------------------------
def build_phase():
    t0 = time.perf_counter()
    libs = build.build()
    chain._library()
    step._library()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, entry in sorted(build.BUILD_LOG.items()):
        for line in entry["output"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "smem", "spill")):
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 3 ------------------------------------------------------------------
def host_packages_phase():
    """Which host packages the data path can import here: cv2 reads the
    JPEGs, scipy computes the eval's host SSIM, h5py the GloVe .h5 (the
    .npy copies stand in without it), matplotlib draws the eval gallery's
    attention heatmaps (cv2 draws them without it)."""
    import importlib

    found = {}
    for m in ("cv2", "PIL", "h5py", "matplotlib", "scipy"):
        try:
            importlib.import_module(m)
            found[m] = True
        except ImportError:
            found[m] = False
    log(f"host packages (import): {found}")
    for m in ("cv2", "scipy"):
        if not found[m]:
            fail(f"{m} is missing: the eval's data path needs it")
    return found



# -- phase 4 ------------------------------------------------------------------
def bench_workload(batch=128, size=512, steps=5, seed=0):
    """bench.py:build_workload's draw (same rng calls), plus forced cases:
    a chain with two sharpness steps, one with slots 0 and 5, and exact
    0 / 0.5 / 1 patches."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    base = np.stack([x, y, 0.5 * (x + y)], 0)
    imgs = np.clip(base[None] + rng.uniform(-0.2, 0.2, (batch, 3, size, size))
                   .astype(np.float32), 0, 1)
    vocab_ids = rng.choice([3, 4, 5, 6, 8, 9], size=(batch, steps))
    params = rng.uniform(0.1, 0.6, size=(batch, steps, 24)).astype(np.float32)
    slots = np.where(vocab_ids < 3, 0, vocab_ids - 2).astype(np.int32)
    slots[0] = [7, 1, 7, 4, 6]
    slots[1] = [0, 2, 5, 3, 0]
    for v, (r0, r1) in ((0.0, (0, 64)), (0.5, (64, 128)), (1.0, (128, 192))):
        imgs[:5, :, r0:r1, :96] = v
    return imgs, slots, params


def random_case(b, h, w, k=5, seed=1, identity=False):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (b, 3, h, w)).astype(np.float32)
    pool = [0, 5] if identity else [0, 1, 2, 3, 4, 5, 6, 7, 8]
    slots = rng.choice(pool, size=(b, k)).astype(np.int32)
    params = rng.uniform(0.1, 0.6, (b, k, 24)).astype(np.float32)
    return imgs, slots, params


def sharp_case(b, h, w, k, seed):
    """random_case with every step of image 0 a sharpness step: its tile
    path holds the largest halo a k-step chain can need."""
    imgs, slots, params = random_case(b, h, w, k=k, seed=seed)
    slots[0] = 7
    return imgs, slots, params


def step_k1_case(b, h, w, seed):
    """step_case's images, slots and params as a one-step chain."""
    imgs, slots, params, _ = step_case(b, h, w, seed)
    return (imgs, np.ascontiguousarray(slots[:, None]),
            np.ascontiguousarray(params[:, None]))


def to_card(*arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


def max_err(out, ref):
    if not torch.equal(torch.isnan(out), torch.isnan(ref)):
        return float("nan")
    d = (out - ref).abs()
    return float(torch.nan_to_num(d, nan=0.0).max())


def time_ms(fn, warmup=3, iters=20):
    """Call time: CUDA events around one call of the Python wrapper, so
    the host's work before the launch counts whenever it outlasts the
    kernel."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


L2_BYTES = 50 * 2 ** 20


def rotations(args, nbytes):
    """Copies of a call's input tensors, enough that taking them in turn
    touches three times the L2 cache: each call then reads its inputs from
    device memory, as a training step's backward does (max 8 copies)."""
    n = min(8, max(1, math.ceil(3 * L2_BYTES / nbytes)))
    return [tuple(a.clone() for a in args) for _ in range(n)]


def device_ms(fn, arg_sets, calls=40, reps=5):
    """Device time of one call, ms: `calls` calls of fn (on arg_sets in
    turn) captured in one CUDA graph, the graph replayed `reps` times
    between two CUDA events, each replay's time over `calls`. It holds
    every kernel the call launches and the card's gaps between them, and
    none of the host's work (the wrapper's checks, allocations and ctypes
    call ran once, at capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up on the capture stream
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.synchronize()
    return times


def kernel_phase():
    cases = {
        "bench b128 512x512 K5": bench_workload(),
        "serve b8 512x512 K5": random_case(8, 512, 512, seed=2),
        "serve b8 384x640 K5": random_case(8, 384, 640, seed=3),
        "1x64x1024": random_case(1, 64, 1024, seed=4),
        "3x320x448": random_case(3, 320, 448, seed=5),
        "2x33x97": random_case(2, 33, 97, seed=6),
        # the GIER decoder's length and the longest chain the kernel takes
        "3x320x448 K8": sharp_case(3, 320, 448, 8, seed=8),
        "2x33x97 K16": sharp_case(2, 33, 97, 16, seed=9),
        "identity 4x128x128": random_case(4, 128, 128, seed=7, identity=True),
        # the fused step's forward: phase 4's images at K=1
        "trainer b64 128x128 K1": step_k1_case(64, 128, 128, seed=10),
        "b128 512x512 K1": step_k1_case(128, 512, 512, seed=11),
    }
    worst = 0.0
    for name, arrays in cases.items():
        args = to_card(*arrays)
        out = chain.fused_chain(*args)
        torch.cuda.synchronize()
        ref = chain.fused_chain_reference(*args)
        err = max_err(out, ref)
        log(f"chain vs plain [{name}]: max abs err {err:.3e}")
        if not err <= CHAIN_ATOL:
            fail(f"chain kernel disagrees with its plain version on {name}: "
                 f"max abs err {err}, want {CHAIN_ATOL}")
        if name.startswith("identity") and not torch.equal(out, args[0]):
            fail("an all-identity chain changed the image")
        worst = max(worst, err)

    imgs, slots, params = to_card(*cases["bench b128 512x512 K5"])
    b, k = slots.shape

    def kern():
        chain.fused_chain(imgs, slots, params)

    def plain():
        chain.fused_chain_reference(imgs, slots, params)

    # in turns, so drift in clocks or power hits both alike
    p1 = time_ms(plain)
    k1 = time_ms(kern)
    k2 = time_ms(kern)
    p2 = time_ms(plain)
    kernel_ms = statistics.median(k1 + k2)
    plain_ms = statistics.median(p1 + p2)
    dev = {}
    for name in ("bench b128 512x512 K5", "serve b8 512x512 K5",
                 "trainer b64 128x128 K1"):
        args = to_card(*cases[name])
        dev[name] = statistics.median(device_ms(
            chain.fused_chain, rotations(args, 2 * args[0].numel() * 4)))
    log(f"chain b{b} 512x512 K{k}: kernel {kernel_ms:.4f} ms call, "
        f"{dev['bench b128 512x512 K5']:.4f} ms device "
        f"({b * k / kernel_ms * 1e3:.1f} op-applications/s by call time), "
        f"plain {plain_ms:.4f} ms ({b * k / plain_ms * 1e3:.1f} "
        f"op-applications/s); call times medians of 2x20 calls after 3 "
        f"warm-ups, device times medians of 5 graph replays of 40 calls")
    hbm = sum(chain_steps(r, False)[1] for r in np.asarray(slots.cpu())) \
        * 512 * 512 * 4
    log(f"  kernel moves {hbm / 1e6:.1f} MB of device memory: "
        f"{hbm / dev['bench b128 512x512 K5'] / 1e6:.1f} GB/s")
    # call time of the kernel and of its plain version at the serving
    # micro-batch and at the FiveK step's forward, in turns
    call = {}
    for name in ("serve b8 512x512 K5", "trainer b64 128x128 K1"):
        args = to_card(*cases[name])
        p1 = time_ms(lambda: chain.fused_chain_reference(*args))
        k1 = time_ms(lambda: chain.fused_chain(*args))
        k2 = time_ms(lambda: chain.fused_chain(*args))
        p2 = time_ms(lambda: chain.fused_chain_reference(*args))
        call[name] = (statistics.median(k1 + k2), statistics.median(p1 + p2))
    serve, k1 = call["serve b8 512x512 K5"], call["trainer b64 128x128 K1"]
    log(f"chain b8 512x512 K5 (serving micro-batch): kernel {serve[0]:.4f} "
        f"ms call, {dev['serve b8 512x512 K5']:.4f} ms device, plain "
        f"{serve[1]:.4f} ms call; b64 128x128 K1 (the FiveK step's forward) "
        f"{k1[0]:.4f} ms call, {dev['trainer b64 128x128 K1']:.4f} ms "
        f"device, plain {k1[1]:.4f} ms call")
    bd, by = chain_bound(slots, 512, 512, False)
    log(f"  bound at b{b} 512x512 K{k}: {bd:.4f} ms ({by})")
    serve_slots = to_card(*cases["serve b8 512x512 K5"])[1]
    k1_slots = to_card(*cases["trainer b64 128x128 K1"])[1]
    return {"max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bd, "bound_by": by,
            "device_ms": dev["bench b128 512x512 K5"],
            "ms_b8_512_serve": serve[0], "plain_ms_b8_512_serve": serve[1],
            "device_ms_b8_512_serve": dev["serve b8 512x512 K5"],
            "bound_ms_b8_512_serve": chain_bound(serve_slots, 512, 512,
                                                 False)[0],
            "ms_b64_128_k1": k1[0], "plain_ms_b64_128_k1": k1[1],
            "device_ms_b64_128_k1": dev["trainer b64 128x128 K1"],
            "bound_ms_b64_128_k1": chain_bound(k1_slots, 128, 128,
                                               False)[0]}


FIVEK_TEST_IMAGE = os.path.join("data_real_h2h", "FiveK", "images",
                                "3458_O.jpg")
EVAL_BUCKETS = {"640x640": (600, 600), "576x1024": (576, 1000)}
PROBE_BATCH = 10           # the variance probe's requests per image


def eval_image(h, w):
    """A real FiveK test input as the eval hands it to the rollout:
    short-side-600 (resized to h x w when that is not its own shape) and
    edge-padded to its 64-px bucket."""
    import cv2

    from t2onet_tpu_torch.evals.bucketing import pad_to_bucket

    img = load_infer_img_short_size_bounded(FIVEK_TEST_IMAGE)
    if img.shape[1:] != (h, w):
        img = cv2.resize(img.transpose(1, 2, 0), (w, h)).transpose(2, 0, 1)
    return pad_to_bucket(np.ascontiguousarray(img))[0][None]


def eval_chain_phase():
    """Phase 4b: B1 at K=1 on b1 buckets, as each eval rollout step runs
    it: a real FiveK image in its 640 x 640 bucket and one in a 576 x 1024
    bucket, each slot in turn; bit-exact against the plain version, then
    device time, call time, the plain version's call time and the bound
    per slot; the variance probe's b10 x 600², and the demo's rollout
    step, b1 at the image's own 600 x 600, each slot."""
    rng = np.random.default_rng(24)
    params = rng.uniform(0.1, 0.6, (1, 1, 24)).astype(np.float32)
    rows, worst = [], 0.0
    for bucket, (h, w) in EVAL_BUCKETS.items():
        img = eval_image(h, w)
        for s in range(9):
            args = to_card(img, np.full((1, 1), s, np.int32), params)
            out = chain.fused_chain(*args)
            torch.cuda.synchronize()
            err = max_err(out, chain.fused_chain_reference(*args))
            worst = max(worst, err)
            if not err <= CHAIN_ATOL:
                fail(f"chain kernel disagrees with its plain version on the "
                     f"eval's b1 {bucket} K1, slot {s}: max abs err {err}")
            dev = statistics.median(device_ms(chain.fused_chain, rotations(
                args, 2 * args[0].numel() * 4)))
            call = statistics.median(time_ms(lambda: chain.fused_chain(
                *args)))
            plain = statistics.median(time_ms(
                lambda: chain.fused_chain_reference(*args), iters=10))
            bd, by = chain_bound(args[1], img.shape[2], img.shape[3], False)
            rows.append({"bucket": bucket, "slot": s, "device_ms": dev,
                         "call_ms": call, "plain_ms": plain, "bound_ms": bd,
                         "bound_by": by})
            op = OP_NAMES[s - 1] if s else "identity"
            log(f"chain vs plain [eval b1 {bucket} K1, slot {s} ({op})]: max "
                f"abs err {err:.3e}; {dev:.4f} ms device, {call:.4f} ms "
                f"call, plain {plain:.4f} ms call; bound {bd:.4f} ms ({by})")
    # the variance probe's batch: one test image under the 10 requests,
    # b10 at its own 600 x 600 (no bucket; 600 is no multiple of the
    # 32-px tile, so the edge tiles are partial), every slot among them
    img = load_infer_img_short_size_bounded(FIVEK_TEST_IMAGE)
    args = to_card(np.repeat(img[None], PROBE_BATCH, 0),
                   (np.arange(PROBE_BATCH) % 9).astype(np.int32)[:, None],
                   rng.uniform(0.1, 0.6, (PROBE_BATCH, 1, 24))
                   .astype(np.float32))
    out = chain.fused_chain(*args)
    torch.cuda.synchronize()
    err = max_err(out, chain.fused_chain_reference(*args))
    worst = max(worst, err)
    if not err <= CHAIN_ATOL:
        fail(f"chain kernel disagrees with its plain version on the "
             f"variance probe's b{PROBE_BATCH} 600x600 K1: max abs err {err}")
    probe = {"shape": f"b{PROBE_BATCH} 600x600 K1", "device_ms":
             statistics.median(device_ms(chain.fused_chain, rotations(
                 args, 2 * args[0].numel() * 4))),
             "call_ms": statistics.median(time_ms(
                 lambda: chain.fused_chain(*args))),
             "plain_ms": statistics.median(time_ms(
                 lambda: chain.fused_chain_reference(*args), iters=10))}
    probe["bound_ms"], probe["bound_by"] = chain_bound(args[1], 600, 600,
                                                       False)
    log(f"chain vs plain [variance probe b{PROBE_BATCH} 600x600 K1, slots "
        f"0-8]: max abs err {err:.3e}; {probe['device_ms']:.4f} ms device, "
        f"{probe['call_ms']:.4f} ms call, plain {probe['plain_ms']:.4f} ms "
        f"call; bound {probe['bound_ms']:.4f} ms ({probe['bound_by']})")
    # the demo's rollout: b1 at the image's own 600 x 600, every slot
    demo_rows = []
    for s in range(9):
        args = to_card(np.ascontiguousarray(img[None]),
                       np.full((1, 1), s, np.int32), params)
        out = chain.fused_chain(*args)
        torch.cuda.synchronize()
        err = max_err(out, chain.fused_chain_reference(*args))
        worst = max(worst, err)
        if not err <= CHAIN_ATOL:
            fail(f"chain kernel disagrees with its plain version on the "
                 f"demo's b1 600x600 K1, slot {s}: max abs err {err}")
        row = {"shape": "b1 600x600 K1", "slot": s,
               "device_ms": statistics.median(device_ms(
                   chain.fused_chain, rotations(args, 2 * img.size * 4))),
               "call_ms": statistics.median(time_ms(
                   lambda: chain.fused_chain(*args))),
               "plain_ms": statistics.median(time_ms(
                   lambda: chain.fused_chain_reference(*args), iters=10))}
        row["bound_ms"], row["bound_by"] = chain_bound(args[1], 600, 600,
                                                       False)
        demo_rows.append(row)
        log(f"chain vs plain [demo b1 600x600 K1, slot {s}]: max abs err "
            f"{err:.3e}; {row['device_ms']:.4f} ms device, "
            f"{row['call_ms']:.4f} ms call, plain {row['plain_ms']:.4f} ms "
            f"call; bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return {"max_abs_err": worst, "rows": rows, "probe": probe,
            "demo_rows": demo_rows}


# -- phase 5 ------------------------------------------------------------------
def step_case(b, h, w, seed):
    """imgs, slots (every slot), params and a +-1 cotangent, with the
    pixels where tie rules bite: exact 0 / 0.5 / 1, gray (three equal
    channels), two equal channels; half the brightness images saturate."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (b, 3, h, w)).astype(np.float32)
    q = max(h // 8, 1)
    for i, v in enumerate((0.0, 0.5, 1.0, 128.0 / 255.0)):
        imgs[:, :, i * q:(i + 1) * q, : w // 3] = v
    imgs[:, 0:2, 4 * q:5 * q, : w // 3] = 200.0 / 255.0
    slots = (np.arange(b) % 9).astype(np.int32)
    rng.shuffle(slots)
    params = rng.uniform(0.1, 0.6, (b, 24)).astype(np.float32)
    params[(slots == 1) & (np.arange(b) % 2 == 0), 0] = 0.9
    g = np.sign(rng.uniform(-1, 1, (b, 3, h, w))).astype(np.float32)
    return imgs, slots, params, g


def param_rel_err(dp, ref):
    """Max over images of |dp - ref| relative to the image's largest
    |ref| entry (a row of zeros must match exactly)."""
    d = (dp - ref).abs().amax(dim=1)
    scale = ref.abs().amax(dim=1)
    if bool((d[scale == 0] > 0).any()):
        return float("inf")
    return float((d / scale.clamp_min(1e-30)).max())


def check_step_bwd(name, args, who):
    """One step backward call (B3, or B4 with a mask in args) against its
    plain version: d_img bit-exact, d_params within STEP_PARAM_RTOL of the
    image's largest entry, and a second call identical bit for bit.
    Returns (d_img error, d_params relative error)."""
    d_img, d_params = step.step_bwd(*args)
    again = step.step_bwd(*args)
    torch.cuda.synchronize()
    r_img, r_params = step.fused_step_bwd_reference(*args)
    ei = max_err(d_img, r_img)
    ep = param_rel_err(d_params, r_params)
    same = torch.equal(d_img, again[0]) and torch.equal(d_params, again[1])
    log(f"{who} vs plain [{name}]: d_img max abs err {ei:.3e}, d_params max "
        f"rel err {ep:.3e}; two calls identical: {same}")
    if not (ei == 0.0 and ei <= STEP_IMG_ATOL and ep <= STEP_PARAM_RTOL):
        fail(f"{who} kernel disagrees with its plain version on {name}: "
             f"d_img {ei} (bit-exact wanted, <= {STEP_IMG_ATOL}), d_params "
             f"{ep} (<= {STEP_PARAM_RTOL})")
    if not same:
        fail(f"{who} gave two different results on the same inputs "
             f"({name})")
    return ei, ep


def step_kernel_phase():
    cases = {
        "trainer b64 128x128": step_case(64, 128, 128, seed=10),
        "b128 512x512": step_case(128, 512, 512, seed=11),
        "2x33x97": step_case(2, 33, 97, seed=12),
        "9x64x1024": step_case(9, 64, 1024, seed=13),
        "9x8x8": step_case(9, 8, 8, seed=14),
    }
    worst_img = worst_param = 0.0
    for name, arrays in cases.items():
        ei, ep = check_step_bwd(name, to_card(*arrays), "step_bwd")
        worst_img, worst_param = max(worst_img, ei), max(worst_param, ep)

    times = {}
    for name in ("trainer b64 128x128", "b128 512x512"):
        args = to_card(*cases[name])
        imgs, slots, params, g = args

        def kern():
            step.step_bwd(imgs, slots, params, g)

        def plain():
            step.fused_step_bwd_reference(imgs, slots, params, g)

        def fwd():
            chain.fused_chain(imgs, slots[:, None].contiguous(),
                              params[:, None].contiguous())

        p1 = time_ms(plain, iters=10)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain, iters=10)
        f = statistics.median(time_ms(fwd))
        k = statistics.median(k1 + k2)
        pl = statistics.median(p1 + p2)
        dv = statistics.median(device_ms(step.step_bwd, rotations(
            args, 2 * imgs.numel() * 4)))
        moved = 3 * imgs.numel() * 4
        bd, by = step_bound(slots, imgs.shape[2], imgs.shape[3], False)
        log(f"step_bwd {name}: kernel {k:.4f} ms call, {dv:.4f} ms device "
            f"({moved / dv / 1e6:.1f} GB/s), plain {pl:.4f} ms; B1 at K=1 "
            f"on the same images {f:.4f} ms call; bound {bd:.4f} ms ({by}); "
            f"medians, kernel 2x20 calls, plain 2x10, device 5 graph "
            f"replays of 40 calls")
        times[name] = (k, pl, f, bd, by, dv)
    small, big = times["trainer b64 128x128"], times["b128 512x512"]
    return {"max_abs_err": worst_img, "param_rel_err": worst_param,
            "ms": small[0], "plain_ms": small[1], "device_ms": small[5],
            "ms_b128_512": big[0], "plain_ms_b128_512": big[1],
            "device_ms_b128_512": big[5],
            "chain_k1_ms_b128_512": big[2],
            "bound_ms": small[3], "bound_by": small[4],
            "bound_ms_b128_512": big[3]}


# -- phase 6 ------------------------------------------------------------------
# f32 instructions per pixel (three channels) of one executed step, counted
# from csrc/chain.cu and csrc/step_bwd.cu: each add, multiply, min, max,
# compare or select one (a clip is a max and a min); work done once per
# block and step (curve coefficients, 1 + p) is left out. An IEEE f32
# division (div.rn.f32, no fast math) compiles for sm_90a to DIV_OPS
# instructions on its usual path (cuobjdump -sass of csrc/chain.cu):
# MUFU.RCP, FCHK, 5 FFMA, and a branch round the slow path with its
# BSSY/BSYNC pair.
# Forward by slot, what the mask blend adds to it ((1 - m), then y*m +
# x*(1 - m) per channel), and the backward, whose slots 1-3 hold three
# divisions each.
DIV_OPS = 10
FWD_OPS = {0: 0, 1: 15 + DIV_OPS, 2: 35 + DIV_OPS, 3: 28 + DIV_OPS, 4: 72,
           5: 0, 6: 72, 7: 27, 8: 0}
BWD_OPS = {0: 0, 1: 57 + 3 * DIV_OPS, 2: 107 + 3 * DIV_OPS,
           3: 92 + 3 * DIV_OPS, 4: 160, 5: 0, 6: 160, 7: 60, 8: 0}
MASK_FWD_OPS, MASK_BWD_OPS = 10, 27
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
# un-fused f32 instructions a second on the H100 SXM: 128 lanes x 132 SMs
# x 1.98 GHz. The kernels are built with -fmad=false, so a multiply and an
# add are two instructions, not one FMA (the 67 TFLOP/s of the data sheet
# count an FMA as two operations).
PEAK_F32_S = 33.5e12


def larger(t_bytes, t_ops):
    """(bound_ms, bound_by) from the bytes' and the instructions' times."""
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_steps(row, masked):
    """(steps, planes) of one image's chain, its slots clamped as the
    kernel clamps them: the steps its output depends on and the f32 planes
    of h*w values it must move. Unmasked, a white step sets every pixel to
    1 whatever came before it, so only the steps after the last one count
    and the input is not read: 3 planes written. Otherwise the input is
    read and the output written (6; the mask makes 7)."""
    row = [min(max(int(v), 0), 8) for v in row]
    if not masked and 8 in row:
        return row[len(row) - row[::-1].index(8):], 3
    return row, 7 if masked else 6


def chain_bound(slots, h, w, masked):
    """(bound_ms, bound_by) of a chain call on (B, K) slots: each image's
    planes (chain_steps) moved once over the memory rate, against the f32
    instructions of the steps it needs (FWD_OPS, and MASK_FWD_OPS for each
    executed step of a masked chain) over the instruction rate."""
    n_planes = n_ops = 0
    for row in np.asarray(slots.cpu()).reshape(slots.shape[0], -1):
        steps, planes = chain_steps(row, masked)
        n_planes += planes
        n_ops += sum(FWD_OPS[v] + (MASK_FWD_OPS if masked and v not in (0, 5)
                                   else 0) for v in steps)
    return larger(n_planes * h * w * 4 / PEAK_BYTES_S * 1e3,
                  n_ops * h * w / PEAK_F32_S * 1e3)


def step_planes(slot, masked):
    """f32 planes of h*w values the step backward must move for one image
    of this slot: the identities read g and write d_img (6); unmasked white
    writes zeros (3); masked white and every op read img, g (and the mask)
    and write d_img (9, masked 10)."""
    if slot in (0, 5):
        return 6
    if slot == 8 and not masked:
        return 3
    return 10 if masked else 9


def step_bound(slots, h, w, masked):
    """chain_bound() for the step backward, with each image's bytes by its
    slot (step_planes); the (B, 24) params and d_params are left out."""
    s = [int(v) for v in np.asarray(slots.cpu()).ravel()]
    n_ops = sum(BWD_OPS[v] + (MASK_BWD_OPS if masked and v not in (0, 5)
                              else 0) for v in s) * h * w
    return larger(sum(step_planes(v, masked) for v in s) * h * w * 4
                  / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3)


def slot_phase():
    """B3 and B4 on slot-uniform batches at the trainers' b64 x 128 px,
    every image taking the same slot: device time per slot against its
    bound. Slots 0 and 5 do no pixel arithmetic, so they show the fixed
    part of a call."""
    imgs, _, params, g = step_case(64, 128, 128, seed=10)
    mask = step_mask(64, 128, 128, 30)
    rows = []
    for s in range(9):
        slots = np.full(64, s, np.int32)
        row = {"slot": s}
        for who, extra in (("b3", ()), ("b4", (mask,))):
            args = to_card(imgs, slots, params, g, *extra)
            ms = statistics.median(device_ms(step.step_bwd, rotations(
                args, 2 * args[0].numel() * 4)))
            row[f"{who}_device_ms"] = ms
            row[f"{who}_bound_ms"] = step_bound(args[1], 128, 128,
                                                bool(extra))[0]
        rows.append(row)
        op = OP_NAMES[s - 1] if s else "identity"
        log(f"slot-uniform b64 128x128, slot {s} ({op}): "
            f"B3 {row['b3_device_ms']:.4f} ms device (bound "
            f"{row['b3_bound_ms']:.4f}), B4 {row['b4_device_ms']:.4f} ms "
            f"(bound {row['b4_bound_ms']:.4f})")
    return rows


def chain_slot_phase():
    """Phase 6c: B1 and B2 on slot-uniform chains, every step of every
    image the same slot: B1 and B2 at the trainers' b64 x 128 px x K1, B1
    at b128 x 512 px x K5 (bench_workload's images and params). Device
    and call time per slot against its bound. Slots 0 and 5 show the fixed
    cost of a call, brightness (the cheapest op) what a pointwise step
    adds to it, color and tone the arithmetic, sharpness the halo."""
    imgs, _, params, _ = step_case(64, 128, 128, seed=10)
    mask = step_mask(64, 128, 128, 21)
    big, _, big_params = bench_workload()
    shapes = (("B1", "b64 128x128 K1", imgs, params[:, None], None),
              ("B2", "b64 128x128 K1", imgs, params[:, None], mask),
              ("B1", "b128 512x512 K5", big, big_params, None))
    rows = []
    for s in range(9):
        op = OP_NAMES[s - 1] if s else "identity"
        for who, shape, im, pa, m in shapes:
            slots = np.full(pa.shape[:2], s, np.int32)
            args = to_card(im, slots, np.ascontiguousarray(pa),
                           *(() if m is None else (m,)))
            dev = statistics.median(device_ms(chain.fused_chain, rotations(
                args, 2 * args[0].numel() * 4)))
            call = statistics.median(time_ms(lambda: chain.fused_chain(
                *args)))
            bd, by = chain_bound(args[1], im.shape[2], im.shape[3],
                                 m is not None)
            rows.append({"kernel": who, "shape": shape, "slot": s,
                         "device_ms": dev, "call_ms": call, "bound_ms": bd,
                         "bound_by": by})
            log(f"slot-uniform chain {who} {shape}, slot {s} ({op}): "
                f"{dev:.4f} ms device, {call:.4f} ms call; bound {bd:.4f} "
                f"ms ({by})")
            del args
    return rows


def half_mask(b, h, w, seed):
    """(b, 1, h, w) f32: binary in the left half, fractional in the right."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0, 1, (b, 1, h, w)).astype(np.float32)
    m[..., : w // 2] = (m[..., : w // 2] > 0.5).astype(np.float32)
    return m


def step_mask(b, h, w, seed):
    """half_mask, with step_case's exact 0 / 0.5 / 1 and gray patches
    (columns < w/3) half inside the mask and half outside it."""
    m = half_mask(b, h, w, seed)
    m[..., : w // 6] = 1.0
    m[..., w // 6: w // 3] = 0.0
    return m


def gier_masks(n, size):
    """Up to n real GIER masks: every instance of the RLE mask files in
    data_real_gier, decoded and resized (nearest) to size x size."""
    from t2onet_tpu_torch.data.rle import resize_nearest, rle_decode

    mdir = os.path.join("data_real_gier", "GIER", "masks")
    out = []
    for name in sorted(os.listdir(mdir)):
        with open(os.path.join(mdir, name)) as f:
            for rle in json.load(f):
                out.append(resize_nearest(rle_decode(rle), size, size))
                if len(out) == n:
                    break
        if len(out) == n:
            break
    return np.stack(out)[:, None].astype(np.float32)


def masked_chain_phase():
    """B2 against its plain version and, under an all-ones mask, against
    B1; then timed beside B1."""
    bench = bench_workload()
    k1 = step_k1_case(64, 128, 128, seed=10)
    odd = random_case(2, 33, 97, seed=6)
    real_m = gier_masks(64, 128)
    real = random_case(real_m.shape[0], 128, 128, k=5, seed=15)
    cases = {
        "bench b128 512x512 K5": bench + (half_mask(128, 512, 512, 20),),
        "trainer b64 128x128 K1": k1 + (step_mask(64, 128, 128, 21),),
        "2x33x97 K5": odd + (half_mask(2, 33, 97, 22),),
        "3x320x448 K8": sharp_case(3, 320, 448, 8, seed=8)
        + (half_mask(3, 320, 448, 23),),
        f"real GIER masks b{real_m.shape[0]} 128x128 K5": real + (real_m,),
    }
    worst = 0.0
    for name, arrays in cases.items():
        imgs, slots, params, mask = to_card(*arrays)
        out = chain.fused_chain(imgs, slots, params, mask)
        torch.cuda.synchronize()
        ref = chain.fused_chain_reference(imgs, slots, params, mask)
        err = max_err(out, ref)
        ones = torch.ones_like(mask)
        same = torch.equal(chain.fused_chain(imgs, slots, params, ones),
                           chain.fused_chain(imgs, slots, params))
        log(f"masked chain vs plain [{name}]: max abs err {err:.3e}; "
            f"all-ones mask equals B1: {same}")
        if not err <= CHAIN_ATOL:
            fail(f"masked chain kernel disagrees with its plain version on "
                 f"{name}: max abs err {err}, want {CHAIN_ATOL}")
        if not same:
            fail(f"masked chain under an all-ones mask differs from the "
                 f"unmasked chain on {name}")
        worst = max(worst, err)

    times = {}
    for name in ("bench b128 512x512 K5", "trainer b64 128x128 K1"):
        args = to_card(*cases[name])
        imgs, slots, params, mask = args

        def kern():
            chain.fused_chain(imgs, slots, params, mask)

        def plain():
            chain.fused_chain_reference(imgs, slots, params, mask)

        def unmasked():
            chain.fused_chain(imgs, slots, params)

        p1 = time_ms(plain, iters=10)
        k1_ = time_ms(kern)
        k2_ = time_ms(kern)
        p2 = time_ms(plain, iters=10)
        u = statistics.median(time_ms(unmasked))
        k = statistics.median(k1_ + k2_)
        pl = statistics.median(p1 + p2)
        dv = statistics.median(device_ms(chain.fused_chain, rotations(
            args, 2 * imgs.numel() * 4)))
        b, h, w = imgs.shape[0], imgs.shape[2], imgs.shape[3]
        bd, by = chain_bound(slots, h, w, True)
        log(f"masked chain {name}: kernel {k:.4f} ms call, {dv:.4f} ms "
            f"device ({7 * b * h * w * 4 / dv / 1e6:.1f} GB/s), plain "
            f"{pl:.4f} ms, B1 on the same inputs {u:.4f} ms call; bound "
            f"{bd:.4f} ms ({by}); medians, kernel 2x20 calls, plain 2x10, "
            f"device 5 graph replays of 40 calls")
        times[name] = (k, pl, u, bd, by, dv)
    k, pl, u, bd, by, dv = times["bench b128 512x512 K5"]
    k1t = times["trainer b64 128x128 K1"]
    return {"max_abs_err": worst, "ms": k, "plain_ms": pl, "b1_ms": u,
            "bound_ms": bd, "bound_by": by, "device_ms": dv,
            "ms_b64_128_k1": k1t[0], "plain_ms_b64_128_k1": k1t[1],
            "b1_ms_b64_128_k1": k1t[2], "bound_ms_b64_128_k1": k1t[3],
            "device_ms_b64_128_k1": k1t[5]}


def masked_step_phase():
    """B4 against its plain version and, under an all-ones mask, against
    B3; then timed beside B3."""
    cases = {
        "trainer b64 128x128": step_case(64, 128, 128, seed=10)
        + (step_mask(64, 128, 128, 30),),
        "b128 512x512": step_case(128, 512, 512, seed=11)
        + (step_mask(128, 512, 512, 31),),
        "2x33x97": step_case(2, 33, 97, seed=12) + (step_mask(2, 33, 97, 32),),
        "9x8x8": step_case(9, 8, 8, seed=14) + (step_mask(9, 8, 8, 33),),
    }
    worst_img = worst_param = 0.0
    for name, arrays in cases.items():
        args = to_card(*arrays)
        imgs, slots, params, g, mask = args
        ei, ep = check_step_bwd(name, args, "masked step_bwd")
        o_img, o_params = step.step_bwd(imgs, slots, params, g,
                                        torch.ones_like(mask))
        u_img, u_params = step.step_bwd(imgs, slots, params, g)
        same = torch.equal(o_img, u_img) and torch.equal(o_params, u_params)
        log(f"  all-ones mask equals B3 [{name}]: {same}")
        if not same:
            fail(f"masked step_bwd under an all-ones mask differs from the "
                 f"unmasked one on {name}")
        worst_img, worst_param = max(worst_img, ei), max(worst_param, ep)

    times = {}
    for name in ("trainer b64 128x128", "b128 512x512"):
        args = to_card(*cases[name])
        imgs, slots, params, g, mask = args

        def kern():
            step.step_bwd(imgs, slots, params, g, mask)

        def plain():
            step.fused_step_bwd_reference(imgs, slots, params, g, mask)

        def unmasked():
            step.step_bwd(imgs, slots, params, g)

        p1 = time_ms(plain, iters=10)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain, iters=10)
        u = statistics.median(time_ms(unmasked))
        k = statistics.median(k1 + k2)
        pl = statistics.median(p1 + p2)
        dv = statistics.median(device_ms(step.step_bwd, rotations(
            args, 2 * imgs.numel() * 4)))
        b, h, w = imgs.shape[0], imgs.shape[2], imgs.shape[3]
        bd, by = step_bound(slots, h, w, True)
        log(f"masked step_bwd {name}: kernel {k:.4f} ms call, {dv:.4f} ms "
            f"device ({10 * b * h * w * 4 / dv / 1e6:.1f} GB/s), plain "
            f"{pl:.4f} ms, B3 on the same inputs {u:.4f} ms call; bound "
            f"{bd:.4f} ms ({by}); medians, kernel 2x20 calls, plain 2x10, "
            f"device 5 graph replays of 40 calls")
        times[name] = (k, pl, u, bd, by, dv)
    k, pl, u, bd, by, dv = times["trainer b64 128x128"]
    big = times["b128 512x512"]
    return {"max_abs_err": worst_img, "param_rel_err": worst_param,
            "ms": k, "plain_ms": pl, "b3_ms": u, "bound_ms": bd,
            "bound_by": by, "device_ms": dv, "ms_b128_512": big[0],
            "plain_ms_b128_512": big[1], "b3_ms_b128_512": big[2],
            "bound_ms_b128_512": big[3], "device_ms_b128_512": big[5]}


# -- phase 7 ------------------------------------------------------------------
def make_vocab():
    """918 tokens: the 4 specials, the requests' words, then filler."""
    words = []
    for t in TEXTS:
        words += [w for w in parse_sent(t) if w not in words]
    toks = ["<NONE>", "<START>", "<END>", "<UNK>"] + words
    toks += [f"filler{i}" for i in range(FIVEK_VOCAB_SIZE - len(toks))]
    return {t: i for i, t in enumerate(toks)}


def make_images(n, h, w, seed):
    """cli/serve.py's synthetic requests: a gradient plus noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    y, x = y / max(h - 1, 1), x / max(w - 1, 1)
    base = np.stack([x, y, 0.5 * (x + y)], 0)
    return [np.clip(base + rng.uniform(-0.2, 0.2, (3, h, w))
                    .astype(np.float32), 0, 1) for _ in range(n)]


def serve_phase():
    vocab = make_vocab()
    cfg = ModelConfig()
    t0 = time.perf_counter()
    actor = Actor(cfg, OperatorConfig(), len(vocab),
                  generator=torch.Generator().manual_seed(0))
    knots_near_one(actor)
    actor_cpu = copy.deepcopy(actor)
    n_params = sum(p.numel() for p in actor.parameters())
    log(f"actor: ModelConfig() full width, {n_params} parameters, vocab "
        f"{len(vocab)}, built in {time.perf_counter() - t0:.2f} s")
    kw = dict(decode_size=128, max_batch=8, u8_wire=True,
              encoder_max_len=cfg.encoder_max_len)
    engine = ServingEngine(actor, vocab, device="cuda", **kw)

    imgs = make_images(24, 512, 512, seed=0) + make_images(8, 384, 640, 1)
    reqs = [TEXTS[i % len(TEXTS)] for i in range(len(imgs))]

    reset_launches()
    t0 = time.perf_counter()
    results = engine.edit_batch(imgs, reqs)
    first_s = time.perf_counter() - t0
    launches = chain.LAUNCHES["chain"]
    batches = engine.stats["batches"]
    log(f"serve: {len(results)} requests in {batches} micro-batches, first "
        f"run {first_s:.3f} s; launches {dict(chain.LAUNCHES)}")
    if launches == 0 or launches != batches or batches != 4:
        fail(f"chain kernel launched {launches} times over {batches} "
             f"micro-batches (want 4 and 4)")
    if chain.LAUNCHES["step_bwd"]:
        fail("serving launched the step backward kernel")
    lens = []
    for im, r in zip(imgs, results):
        if r is None:
            fail("a request got no result")
        if r.image.shape != im.shape or not np.isfinite(r.image).all():
            fail(f"bad result image {r.image.shape}")
        if any(op not in OP_NAMES for op in r.ops):
            fail(f"unknown op names {r.ops}")
        if not all(np.isfinite(p).all() for p in r.params):
            fail("non-finite params")
        lens.append(len(r.ops))
    log(f"  buckets {sorted({r.bucket for r in results})}; program lengths "
        f"{sorted(set(lens))}; first programs {[r.ops for r in results[:4]]}")

    cpu = ServingEngine(actor_cpu, vocab, device="cpu", **kw)
    pick = [0, 24]                               # one of each bucket
    ref = cpu.edit_batch([imgs[i] for i in pick], [reqs[i] for i in pick])
    for i, r in zip(pick, ref):
        g = results[i]
        if g.ops != r.ops:
            fail(f"card and CPU decoded different programs: {g.ops} vs "
                 f"{r.ops}")
        for pg, pr in zip(g.params, r.params):
            # params are rounded to 4 places: values 1e-6 apart can round
            # 1e-4 apart
            if np.abs(np.array(pg) - np.array(pr)).max() > 1e-4 + 1e-6:
                fail(f"card and CPU params differ: {pg} vs {pr}")
        lsb = np.abs(g.image - r.image).max() * 255
        log(f"  card vs CPU [{i}]: ops {g.ops}, image max diff {lsb:.3f} LSB")
        if lsb > 1.0 + 1e-3:
            fail(f"card and CPU images differ by {lsb} LSB")

    engine.warmup(buckets=[(512, 512)])
    timed_imgs = make_images(64, 512, 512, seed=3)
    treqs = [TEXTS[i % 4] for i in range(64)]
    before = engine.stats["batches"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.edit_batch(timed_imgs, treqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nb = engine.stats["batches"] - before
    if len(out) != 64 or any(r is None for r in out):
        fail("timed run lost requests")
    log(f"serve 512 px, max_batch 8: {64 / dt:.2f} req/s, "
        f"{dt * 1e3 / nb:.2f} ms per micro-batch ({nb} micro-batches, "
        f"host clock around edit_batch)")
    return launches


# -- phase 8 ------------------------------------------------------------------
TRAIN_ARGV = ["--synthetic", "--device", "cuda", "--batch_size", "64",
              "--img_size", "128", "--num_iters", "8", "--print_every", "2",
              "--checkpoint_every", "8", "--val_batches", "1",
              "--fused_exec", "1", "--run_dir", TRAIN_RUN_DIR]


def train_phase():
    shutil.rmtree(TRAIN_RUN_DIR, ignore_errors=True)
    a = train_fivek.train_parser().parse_args(TRAIN_ARGV)
    initial, _ = common.build_actor(a, len(synthetic_vocab()))
    reset_launches()
    t0 = time.perf_counter()
    state = train_fivek.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    episodes = sum(1 for i in range(1, 9) if i % 2 == 0)
    steps = state.actor.cfg.decoder_max_len
    want = episodes * steps
    log(f"train: 8 iterations in {wall:.2f} s (host clock, data made on "
        f"the fly, validation and checkpoint included); launches "
        f"{launches}, want step_bwd = {want}, chain = {want} + {steps} "
        f"(one validation batch)")
    if state.step != 8:
        fail(f"the trainer stopped at step {state.step}, not 8")
    if launches["step_bwd"] != want or launches["chain"] != want + steps:
        fail(f"launches {launches}: want {want} step_bwd ({episodes} "
             f"episode iterations x {steps} steps) and {want + steps} "
             f"chain (and {steps} for the validation's rollout)")
    losses = logged_losses(os.path.join(TRAIN_RUN_DIR, "metrics.jsonl"))
    log(f"  logged {losses}")
    if not losses or not all(math.isfinite(v) for _, _, v in losses):
        fail(f"non-finite or missing losses: {losses}")
    ckpt = os.path.join(TRAIN_RUN_DIR, "seq2seqL1_model",
                        "checkpoint_iter00000008.pt")
    if not os.path.exists(ckpt):
        fail(f"no checkpoint at {ckpt}")
    before = dict(initial.named_parameters())
    unchanged = [n for n, p in state.actor.named_parameters()
                 if p.requires_grad and torch.equal(p.detach().cpu(),
                                                    before[n].detach())]
    # the inpaint and white heads feed nothing differentiable: their
    # params are zero / ignored, so they get no gradient
    stray = [n for n in unchanged
             if not n.startswith(("executor.inpaint_op",
                                  "executor.white_op"))]
    log(f"  trainable tensors unchanged after 8 steps: {unchanged}")
    if stray:
        fail(f"training left these tensors unchanged: {stray}")
    return state, launches


def timed(fn, n=6, warmup=2):
    """Host-clock ms of n synchronised calls of fn, after `warmup`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def train_timing_phase(state):
    """Each phase's step time on batches already on the card; the
    episode step through the fused kernels and through the bank, in
    turns (fused, bank, bank, fused)."""
    ds = SyntheticFiveK(n=64, img_size=128, seed=5)
    nb = next(ds.batches(64, 1, shuffle=False))
    sup = device_put_batch({k: nb[k] for k in ("x", "y", "img_x", "img_y",
                                               "gt_params")}, "cuda")
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1]}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)

    s_ms = statistics.median(timed(lambda: loop.supervised_step(state, sup)))
    f1 = timed(lambda: loop.episode_step(state, epi, gen, fused_exec=True))
    b1 = timed(lambda: loop.episode_step(state, epi, gen, fused_exec=False))
    b2 = timed(lambda: loop.episode_step(state, epi, gen, fused_exec=False))
    f2 = timed(lambda: loop.episode_step(state, epi, gen, fused_exec=True))
    f_ms, b_ms = statistics.median(f1 + f2), statistics.median(b1 + b2)
    img_s = 2 * 64 / (s_ms + f_ms) * 1e3
    log(f"train step times, b64 128 px, ModelConfig(), TF32 off (host "
        f"clock around each step, synchronised; medians of 6 and 2x6 after "
        f"2 warm-ups): supervised {s_ms:.2f} ms, episode fused {f_ms:.2f} "
        f"ms, episode bank {b_ms:.2f} ms; {img_s:.1f} images/s over one "
        f"supervised and one fused episode step")
    return {"sup_ms": s_ms, "epi_fused_ms": f_ms, "epi_bank_ms": b_ms,
            "img_s": img_s}


# -- phase 9 ------------------------------------------------------------------
def module_grad_gap(card, cpu):
    """(||card - cpu|| / ||cpu|| over a module's gradients, [(error /
    bound, name)] per tensor worst first with bound 5e-2 of its own norm
    plus 1e-6 of the whole)."""
    pairs = [(n, pc.grad.double().cpu(), pp.grad.double().cpu())
             for (n, pc), (_, pp) in zip(card.named_parameters(),
                                         cpu.named_parameters())
             if pc.requires_grad]
    total = math.sqrt(sum(float((gp * gp).sum()) for _, _, gp in pairs))
    diff = math.sqrt(sum(float(((gc - gp) ** 2).sum())
                         for _, gc, gp in pairs))
    per = sorted(((float((gc - gp).norm()) / (0.05 * float(gp.norm())
                                              + 1e-6 * total), n)
                  for n, gc, gp in pairs), reverse=True)
    return diff / total, per


def grad_gap(card_state, cpu_state):
    """`module_grad_gap` of the actors, and the BN running statistics'
    largest gap."""
    stats = max(float((bc.cpu() - bp.cpu()).abs().max())
                for (n, bc), (_, bp) in
                zip(card_state.actor.named_buffers(),
                    cpu_state.actor.named_buffers())
                if "running" in n)
    return module_grad_gap(card_state.actor, cpu_state.actor) + (stats,)


def within_phase9(lc, lp, rel, per, stats):
    """card_vs_cpu_phase's bounds on (loss card, loss CPU, grad_gap)."""
    return (abs(lc - lp) <= 1e-5 * abs(lp) + 1e-7 and rel <= 1e-2
            and per[0][0] <= 1.0 and stats <= 1e-4)


def step_card_vs_cpu(actor, batch, phase, draws=(), per_step_bn=False,
                     probe=None, normals=None, param_noise=0.0):
    """One `phase` step ("supervised", "episode" or "rl") of copies of
    `actor` on the card and on the CPU from the numpy `batch`, the
    episode's and RL's noise fed from `draws` (Gumbel) and `normals`:
    (loss card, loss CPU, grad_gap's three values)."""
    from t2onet_tpu_torch.train import rl

    states = {"card": loop.TrainState(copy.deepcopy(actor).cuda()),
              "cpu": loop.TrainState(copy.deepcopy(actor))}
    losses = {}
    for name, dev in (("card", "cuda"), ("cpu", "cpu")):
        st = states[name]
        it, nit = iter(draws), iter(normals or ())

        def noise(shape, it=it, dev=dev):
            return next(it).to(dev)

        def normal(shape, it=nit, dev=dev):
            return next(it).to(dev)

        if phase == "supervised":
            m = loop.supervised_step(
                st, device_put_batch({k: batch[k] for k in SUP_KEYS}, dev),
                per_step_bn=per_step_bn)
            losses[name] = float(m["loss"])
            continue
        b = device_put_batch({"x": batch["x"], "img_x": batch["img_x"],
                              "gt_img": batch["img_y"][:, -1]}, dev)
        if phase == "episode":
            m = loop.episode_step(st, b, noise_fn=noise, fused_exec=True,
                                  probe_size=probe)
            losses[name] = float(m["L1_loss"])
        else:
            m = rl.rl_step(st, b, noise_fn=noise, normal_fn=normal,
                           param_noise=param_noise)
            losses[name] = float(m["rl_loss"])
    return (losses["card"], losses["cpu"]) + grad_gap(states["card"],
                                                      states["cpu"])


def card_vs_cpu_phase():
    """One sampled episode step of a full-width actor, the same weights
    and Gumbel noise, through the kernels on the card and the plain
    versions on the CPU: the same loss within 1e-5; all gradients together
    within 1e-2 of their norm, and each tensor's within 5e-2 of its own
    norm plus 1e-6 of the whole; BN statistics within 1e-4.

    The gradient bounds are f32 rounding: this step in f32 against f64 on
    the CPU differs by 1.2e-3 of the whole gradient's norm and by up to
    7.3e-3 of one tensor's (measured). Convolutions summed in other orders
    (cuDNN against oneDNN) pass through train-mode BatchNorm over 8 images
    and back through 5 rollout steps. vis_encoder.fc.bias feeds bn1, so
    its true gradient is 0 and both sides hold rounding noise (1e-19 in
    f64, 7e-11 in f32): the 1e-6 floor covers it."""
    vocab = synthetic_vocab()
    cfg = ModelConfig()
    actor = Actor(cfg, OperatorConfig(), len(vocab),
                  generator=torch.Generator().manual_seed(3))
    knots_near_one(actor)
    nb = next(SyntheticFiveK(n=8, img_size=64, seed=9)
              .batches(8, 1, shuffle=False))
    g = torch.Generator().manual_seed(11)
    draws = [bank.gumbel_noise((8, cfg.op_vocab_size), g)
             for _ in range(cfg.decoder_max_len)]
    lc, lp, rel, per, stats = step_card_vs_cpu(actor, nb, "episode", draws)
    log(f"card vs CPU episode step (b8, 64 px, full width, same noise): "
        f"L1 {lc:.7f} vs {lp:.7f}; gradients ||card - cpu|| / ||cpu|| "
        f"{rel:.2e} over all {len(per)} tensors; worst tensors' "
        f"error / bound {[(n, round(r, 4)) for r, n in per[:3]]}; BN running "
        f"stats max diff {stats:.2e}")
    if not within_phase9(lc, lp, rel, per, stats):
        fail("the card's episode step disagrees with the CPU's")
    return lc


# -- phase 10, 11 -------------------------------------------------------------
GIER_RUN_DIR = os.path.join("output", "chip_smoke_gier")
GLOVE_NPY = os.path.join("data_real_gier_acts", "GIER_vocabs_glove_feat_3.npy")
GIER_ARGV = ["--device", "cuda", "--is_load_mask", "1",
             "--data_dir", "data_real_gier",
             "--act_dir", os.path.join("data_real_gier_acts",
                                       "GIER_actions_set_1"),
             "--data_mode", "shapeAlign", "--glove_path", GLOVE_NPY,
             "--batch_size", "64", "--img_size", "128", "--num_iters", "8",
             "--print_every", "2", "--checkpoint_every", "8",
             "--val_batches", "1", "--fused_exec", "1",
             "--run_dir", GIER_RUN_DIR]


def gier_train_phase():
    """The GIER local-edit trainer at ModelConfig() width on the repo's
    real GIER data and planner actions: 8 iterations, 4 of them episode
    iterations of 8 masked rollout steps each."""
    from t2onet_tpu_torch.cli import train_gier
    from t2onet_tpu_torch.data.text import load_embedding

    shutil.rmtree(GIER_RUN_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    state = train_gier.main(GIER_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    cfg = state.actor.cfg
    want = 4 * cfg.decoder_max_len
    log(f"gier train: 8 iterations in {wall:.2f} s (host clock, JPEGs and "
        f"masks decoded on the fly, validation and checkpoint included); "
        f"launches {launches}, want chain_masked = step_bwd_masked = {want}"
        f", chain = {cfg.decoder_max_len} (one validation batch, no "
        f"masks), step_bwd = 0")
    if state.step != 8:
        fail(f"the GIER trainer stopped at step {state.step}, not 8")
    if not (launches["chain_masked"] == launches["step_bwd_masked"] == want
            and launches["chain"] == cfg.decoder_max_len
            and launches["step_bwd"] == 0):
        fail(f"GIER launches {launches}: want {want} of each masked kernel "
             f"(4 episode iterations x {cfg.decoder_max_len} steps), "
             f"{cfg.decoder_max_len} unmasked chains for the validation "
             f"and no unmasked step backward")
    losses = logged_losses(os.path.join(GIER_RUN_DIR, "metrics.jsonl"))
    log(f"  logged {losses}")
    if not losses or not all(math.isfinite(v) for _, _, v in losses):
        fail(f"non-finite or missing GIER losses: {losses}")
    if not os.path.exists(os.path.join(GIER_RUN_DIR, "seq2seqL1_model",
                                       "checkpoint_iter00000008.pt")):
        fail("the GIER trainer wrote no checkpoint at iteration 8")
    a = train_gier.train_parser().parse_args(GIER_ARGV)
    glove = load_embedding(GLOVE_NPY)
    initial, _ = common.build_actor(a, glove.shape[0] + 4, glove)
    before = dict(initial.named_parameters())
    unchanged = [n for n, p in state.actor.named_parameters()
                 if p.requires_grad and torch.equal(p.detach().cpu(),
                                                    before[n].detach())]
    stray = [n for n in unchanged
             if not n.startswith(("executor.inpaint_op",
                                  "executor.white_op"))]
    log(f"  trainable tensors unchanged after 8 steps: {unchanged}")
    if stray:
        fail(f"GIER training left these tensors unchanged: {stray}")
    emb = state.actor.lang_encoder.embedding.weight.detach().cpu()
    if not cfg.fix_input_embedding or not torch.equal(
            emb[4:], torch.from_numpy(glove)):
        fail("the GloVe word rows were not frozen at their values")
    if torch.equal(emb[:4], before["lang_encoder.embedding.weight"][:4]):
        fail("the special tokens' rows did not train")
    log(f"  GloVe rows {tuple(glove.shape)} frozen, special rows trained")
    return state, launches


def profiled_us(fn, calls=2, count_of=None):
    """{name: µs per call} of the device operations (kernels, copies) of
    `calls` calls of fn (torch.profiler, after one warm-up call), plus
    "all" (their sum) and "count" per call; with `count_of`, also
    "count_of": the operations per call whose name holds that text."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, total, count, named = {}, 0.0, 0, 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t > 0:
            out[e.key[:60]] = t / calls
            total += t / calls
            count += e.count / calls
            if count_of is not None and count_of in e.key:
                named += e.count / calls
    out["all"], out["count"] = total, count
    if count_of is not None:
        out["count_of"] = named
    return out


def gier_timing_phase(state):
    """The host's ms per b64 GIER batch (JPEG and mask decode, no cache),
    then each phase's step time on GIER batches already on the card, and
    the masked episode step's device time (profiled_us)."""
    from t2onet_tpu_torch.cli import train_gier

    a = train_gier.train_parser().parse_args(GIER_ARGV)
    ds = common.build_dataset_and_vocab(a, "train", wire_u8=True)[0]
    it = ds.batches(64, 3, shuffle=True, seed=4)
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        nb = next(it)
        host.append((time.perf_counter() - t0) * 1e3)
    sup = device_put_batch({k: nb[k] for k in ("x", "y", "img_x", "img_y",
                                               "gt_params")}, "cuda")
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1],
                            "masks_vocab": nb["masks_vocab"]}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)

    s_ms = statistics.median(timed(lambda: loop.supervised_step(state, sup)))
    e_ms = statistics.median(timed(lambda: loop.episode_step(
        state, epi, gen, fused_exec=True)))
    h_ms = statistics.median(host)
    prof = profiled_us(lambda: loop.episode_step(state, epi, gen,
                                                 fused_exec=True))
    top = sorted(((k, v) for k, v in prof.items()
                  if k not in ("all", "count")), key=lambda kv: -kv[1])
    bwd_us = sum(v for k, v in prof.items() if "step_bwd" in k)
    log(f"gier masked episode step, device (torch.profiler, 2 steps): "
        f"{prof['all'] / 1e3:.2f} ms of device operations, "
        f"{prof['count']:.0f} per step; largest µs "
        f"{[(k, round(v, 1)) for k, v in top[:4]]}; step_bwd<true> "
        f"{bwd_us:.1f} µs")
    log(f"gier step times, b64 128 px, ModelConfig(), decoder_max_len "
        f"{state.actor.cfg.decoder_max_len}, TF32 off (host clock around "
        f"each step, synchronised; medians of 6 after 2 warm-ups): "
        f"supervised {s_ms:.2f} ms, masked episode (fused) {e_ms:.2f} ms; "
        f"host {h_ms:.1f} ms per b64 batch (median of 3: "
        f"{[round(x, 1) for x in host]})")
    return {"sup_ms": s_ms, "epi_masked_ms": e_ms, "host_ms_per_batch": h_ms,
            "epi_masked_device_ms": prof["all"] / 1e3,
            "epi_masked_device_ops": prof["count"],
            "epi_masked_step_bwd_us": bwd_us}


def every_op_masked(masks_vocab):
    """The batch's real local masks shared out, in turn, to every op id
    (3 and up) that has none, so that each executed rollout step blends
    through a real local mask whatever op it draws: a random actor
    rarely draws an item's own local op."""
    mv = masks_vocab.copy()
    local = [mv[i, o] for i in range(mv.shape[0])
             for o in range(mv.shape[1]) if (mv[i, o] < 1).any()]
    j = 0
    for i in range(mv.shape[0]):
        for o in range(3, mv.shape[1]):
            if not (mv[i, o] < 1).any():
                mv[i, o] = local[j % len(local)]
                j += 1
    return mv


def gier_step_case(spread_masks=True):
    """(batch, actor, draws) of one sampled masked episode step: b8 real
    GIER items at 64 px (numpy batch; `every_op_masked` unless
    spread_masks is False), a full-width GIER actor on the CPU (GloVe
    rows frozen, color and tone knots near 1) and 8 steps of Gumbel
    noise."""
    from t2onet_tpu_torch.data.gier import GIERDatasetAct
    from t2onet_tpu_torch.data.text import load_embedding

    glove = load_embedding(GLOVE_NPY)
    ds = GIERDatasetAct(os.path.join("data_real_gier", "GIER"),
                        os.path.join("data_real_gier", "language"),
                        os.path.join("data_real_gier_acts",
                                     "GIER_actions_set_1"), "train",
                        data_mode="shapeAlign", is_load_mask=True,
                        train_img_size=64)
    nb = next(ds.batches(8, 1, shuffle=True, seed=2))
    masks = nb["masks_vocab"]
    batch = {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1],
             "masks_vocab": every_op_masked(masks) if spread_masks else masks}
    cfg = ModelConfig(decoder_max_len=8, fix_input_embedding=True)
    actor = Actor(cfg, OperatorConfig(), glove.shape[0] + 4,
                  generator=torch.Generator().manual_seed(3), word2vec=glove)
    knots_near_one(actor)
    g = torch.Generator().manual_seed(11)
    draws = [-torch.log(-torch.log(torch.rand((8, cfg.op_vocab_size),
                                              generator=g).clamp_min(1e-38)))
             for _ in range(cfg.decoder_max_len)]
    return batch, actor, draws


def gier_card_vs_cpu_phase():
    """One sampled masked episode step of a full-width GIER actor (GloVe
    rows frozen), b8 of real GIER items at 64 px with real masks on every
    op (`every_op_masked`), the same weights and Gumbel noise: B2 and B4
    on the card against the plain versions on the CPU, within phase 9's
    bounds."""
    batch, actor, draws = gier_step_case()
    cfg = actor.cfg
    local = float((batch["masks_vocab"][:, 3:] < 1).mean())
    cpu_state = loop.TrainState(copy.deepcopy(actor))
    card_state = loop.TrainState(actor.cuda())
    before = dict(chain.LAUNCHES)
    losses, ops = {}, {}
    for name, st, dev in (("card", card_state, "cuda"),
                          ("cpu", cpu_state, "cpu")):
        it = iter(draws)
        episode = st.actor.episode

        def keep_ops(*args, episode=episode, name=name, **kw):
            out = episode(*args, **kw)
            ops[name] = out["ops"].cpu()
            return out

        st.actor.episode = keep_ops
        m = loop.episode_step(st, device_put_batch(batch, dev),
                              noise_fn=lambda s, it=it, dev=dev:
                              next(it).to(dev), fused_exec=True)
        del st.actor.episode
        losses[name] = float(m["L1_loss"])
    ran = {k: chain.LAUNCHES[k] - before[k] for k in before}
    # executed steps (op ids 3 and up) whose mask has local values
    drawn = ops["card"]
    mv = torch.from_numpy(batch["masks_vocab"])
    local_step = (mv[torch.arange(drawn.shape[0])[:, None], drawn] < 1) \
        .flatten(2).any(-1)
    executed = drawn >= 3
    blended = int((executed & local_step).sum())
    same_ops = torch.equal(drawn, ops["cpu"])
    lc, lp = losses["card"], losses["cpu"]
    rel, per, stats = grad_gap(card_state, cpu_state)
    log(f"card vs CPU masked episode step (b8 real GIER items, 64 px, "
        f"real local masks on every op, {local:.3f} of the ops' mask "
        f"values below 1, full width, GloVe rows, "
        f"same noise; card launches {ran}; {blended} of "
        f"{int(executed.sum())} executed steps blend through a local "
        f"mask; same ops on both: {same_ops}): L1 {lc:.7f} vs {lp:.7f}; "
        f"gradients ||card - cpu|| / ||cpu|| {rel:.2e} over all "
        f"{len(per)} tensors; worst tensors' error / bound "
        f"{[(n, round(r, 4)) for r, n in per[:3]]}; BN running stats max "
        f"diff {stats:.2e}")
    if ran["chain_masked"] != cfg.decoder_max_len or \
            ran["step_bwd_masked"] != cfg.decoder_max_len:
        fail(f"the card's masked step ran {ran}, not the masked kernels "
             f"{cfg.decoder_max_len} times each")
    if blended == 0:
        fail("no executed rollout step blended through a local mask")
    if not (same_ops and abs(lc - lp) <= 1e-5 * abs(lp) + 1e-7
            and rel <= 1e-2 and per[0][0] <= 1.0 and stats <= 1e-4):
        fail("the card's masked episode step disagrees with the CPU's")
    return lc


# -- phase 12, 13 -------------------------------------------------------------
FIVEK_GLOVE_NPY = os.path.join("data_real_h2h_acts",
                               "FiveK_vocabs_glove_feat_1.npy")
FIVEK_EVAL_ARGV = ["--device", "cuda", "--data_dir", "data_real_h2h",
                   "--glove_path", FIVEK_GLOVE_NPY, "--visualize", "1",
                   "--run_dir", os.path.join("output", "chip_smoke_eval")]
GIER_EVAL_ARGV = ["--device", "cuda", "--data_dir", "data_real_gier",
                  "--glove_path", GLOVE_NPY, "--visualize", "1",
                  "--run_dir", os.path.join("output", "chip_smoke_gier_eval")]
PROBE_IMAGES = 16          # test_variance's default
CPU_PAIRS = 4
CPU_PROBES = 2             # variance probe images rerun on the CPU
EVAL_GAP = 1e-4
VAR_RTOL = 1e-3            # the probe's variance, card against CPU
STAGES = ("load_s", "rollout_s", "metrics_s", "gallery_s")


def write_eval_checkpoint(cli, argv):
    """The parsed flags, and a checkpoint_best.pt in their run dir of the
    full-width actor the eval CLI builds from them (weights from
    --manual_seed, GloVe rows from the .npy), its curve knots near 1 as
    in the serving phase."""
    a = cli.eval_parser().parse_args(argv)
    shutil.rmtree(a.run_dir, ignore_errors=True)
    _, vocab2id, _, w2v = common.build_dataset_and_vocab(a, "test")
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    knots_near_one(actor)
    CheckpointManager(os.path.join(a.run_dir, a.ckpt_name)).save(
        loop.TrainState(actor), 0, val_dist=0.0)
    return a


def eval_phase(name, cli, argv, n_items):
    """`cli.main(argv)` on the card from a fresh checkpoint_best.pt, with
    the launch counters read around it and each pair's and probe image's
    record kept (programs, metrics, host-clock stages); then the first
    CPU_PAIRS pairs' rollouts on the card under torch.profiler (B1's
    device time per pair), and the first CPU_PAIRS pairs and CPU_PROBES
    probe images again on the CPU from the same checkpoint."""
    from t2onet_tpu_torch.cli import test_fivek
    from t2onet_tpu_torch.evals.bucketing import pad_to_bucket
    from t2onet_tpu_torch.train.checkpoint import restore_actor

    a = write_eval_checkpoint(cli, argv)
    steps = a.decoder_max_len
    records, var_records = [], []
    native, variance = test_fivek.test_native_res, test_fivek.test_variance

    def keep_records(*args, **kw):
        return native(*args, records=records, **kw)

    def keep_var_records(*args, **kw):
        return variance(*args, records=var_records, **kw)

    reset_launches()
    test_fivek.test_native_res = keep_records
    test_fivek.test_variance = keep_var_records
    try:
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        test_fivek.test_native_res = native
        test_fivek.test_variance = variance
    launches = dict(chain.LAUNCHES)
    n = len(records)
    want = (n + PROBE_IMAGES) * steps
    log(f"{name} eval: {n} pairs and the variance probe ({PROBE_IMAGES} "
        f"images x 10 requests) in {wall:.2f} s (host clock, set-up "
        f"included); metrics {res}; launches {launches}, want chain = "
        f"({n} + {PROBE_IMAGES}) x {steps} = {want}")
    if n != n_items or len(var_records) != PROBE_IMAGES:
        fail(f"{name} eval rolled out {n} pairs, not {n_items}, and "
             f"{len(var_records)} probe images, not {PROBE_IMAGES}")
    if launches["chain"] != want or any(
            v for k, v in launches.items() if k != "chain"):
        fail(f"{name} eval launches {launches}: want chain = {want} (one per "
             f"rollout step) and no other kernel")
    if not all(math.isfinite(v) for v in res.values()):
        fail(f"{name} eval metrics not finite: {res}")
    web = os.path.join(a.run_dir, "test", "web")
    gallery = sorted(os.listdir(os.path.join(web, "images")))
    if not os.path.exists(os.path.join(web, "index.html")) or \
            "00000_attn.png" not in gallery:
        fail(f"{name} eval wrote no gallery: {gallery[:8]}")

    per = {k: [r[k] * 1e3 for r in records] for k in STAGES}
    pair_ms = [sum(r[k] for k in STAGES) * 1e3 for r in records]
    native_s = sum(pair_ms) / 1e3
    med = {k: statistics.median(v) for k, v in per.items()}
    mean_rest = {k: statistics.mean(v[1:]) for k, v in per.items()}
    log(f"  ms per pair (host clock; medians over {n} pairs, means over "
        f"pairs 2-{n} in brackets): "
        + ", ".join(f"{k[:-2]} {med[k]:.2f} ({mean_rest[k]:.2f})"
                    for k in STAGES)
        + f"; first pair {pair_ms[0]:.2f}; {n / native_s:.3f} pairs/s over "
        f"the native loop ({native_s:.2f} s), the rest of the call "
        f"(set-up, variance probe) {wall - native_s:.2f} s")
    ds, vocab2id, id2op, w2v = common.build_dataset_and_vocab(a, "test")
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    restore_actor(actor, os.path.join(a.run_dir, a.ckpt_name), "best")
    # the first pairs' rollouts on the card, their device operations
    # profiled: B1's device time per pair as the eval runs it
    batches = []
    for i in range(CPU_PAIRS):
        item = ds[i]
        x, img = (item["request_idx"], item["input"]) \
            if isinstance(item, dict) else (item[2], item[0])
        batches.append({
            "x": torch.from_numpy(np.asarray(x).astype(np.int32))[None]
            .cuda(), "img_x": torch.from_numpy(pad_to_bucket(img)[0])[None]
            .cuda()})
    card = copy.deepcopy(actor).cuda().eval()
    prof = profiled_us(lambda: [loop.eval_episode(card, b, fused_exec=True)
                                for b in batches], calls=1,
                       count_of="chain_kernel")
    del card
    top = sorted(((k, v) for k, v in prof.items()
                  if k not in ("all", "count", "count_of")),
                 key=lambda kv: -kv[1])
    chain_us = sum(v for k, v in prof.items() if "chain_kernel" in k)
    bound = statistics.mean(
        sum(chain_bound(torch.tensor([[s]]), *b["img_x"].shape[2:], False)[0]
            for s in chain.vocab_ops_to_slots(torch.tensor([r["ops"]]))[0]
            .tolist())
        for r, b in zip(records, batches))
    b1 = {"launches": prof["count_of"] / CPU_PAIRS,
          "device_ms": chain_us / 1e3 / CPU_PAIRS, "bound_ms": bound,
          "bucket": "x".join(map(str, batches[0]["img_x"].shape[2:]))}
    log(f"  the first {CPU_PAIRS} pairs' rollouts on the card, device "
        f"(torch.profiler): {prof['all'] / 1e3 / CPU_PAIRS:.2f} ms of device "
        f"operations and {prof['count'] / CPU_PAIRS:.0f} operations per "
        f"pair; largest µs per {CPU_PAIRS} pairs "
        f"{[(k, round(v, 1)) for k, v in top[:4]]}")
    log(f"  B1 per pair at b1 {b1['bucket']} K1 (torch.profiler over those "
        f"{CPU_PAIRS} pairs): {b1['launches']:.2f} launches, "
        f"{b1['device_ms']:.4f} ms device, bound {bound:.4f} ms (the pairs' "
        f"programs)")
    if b1["launches"] != steps:
        fail(f"{name} eval: the profiler saw {b1['launches']} chain kernels "
             f"per pair, not {steps}")
    # the first pairs and probe images on the CPU, from the same checkpoint
    cpu, cpu_var = [], []
    actor.eval()
    t0 = time.perf_counter()
    test_fivek.test_native_res(actor, [ds[i] for i in range(CPU_PAIRS)],
                               a, id2op, fused_exec=True, records=cpu)
    test_fivek.test_variance(actor, ds, a, vocab2id, n_images=CPU_PROBES,
                             fused_exec=True, records=cpu_var)
    cpu_s = time.perf_counter() - t0
    keys = ("in_L1", "out_L1", "in_SSIM", "out_SSIM")
    gap = max(abs(g[k] - c[k]) for g, c in zip(records, cpu) for k in keys)
    same = [g["ops"] == c["ops"] for g, c in zip(records, cpu)]
    same_var = [g["ops"] == c["ops"] for g, c in zip(var_records, cpu_var)]
    var_gap = max(abs(g["variance"] - c["variance"])
                  / max(abs(c["variance"]), 1e-30)
                  for g, c in zip(var_records, cpu_var))
    log(f"  card vs CPU, first {CPU_PAIRS} pairs and {CPU_PROBES} probe "
        f"images (the CPU through the fused step's plain version, "
        f"{cpu_s:.2f} s): same programs {same}, probe {same_var}; largest "
        f"metric gap {gap:.3e} (bound {EVAL_GAP}); probe variances card "
        f"{[g['variance'] for g in var_records[:CPU_PROBES]]}, CPU "
        f"{[c['variance'] for c in cpu_var]}, largest relative gap "
        f"{var_gap:.3e} (bound {VAR_RTOL}); programs "
        f"{[c['ops'] for c in cpu]}")
    if not all(same) or not gap <= EVAL_GAP:
        fail(f"{name} eval: the card and the CPU disagree (programs {same}, "
             f"metric gap {gap})")
    if len(cpu_var) != CPU_PROBES or not all(same_var) or \
            not var_gap <= VAR_RTOL:
        fail(f"{name} eval: the card's variance probe disagrees with the "
             f"CPU's (programs {same_var}, relative gap {var_gap})")
    return {"pairs": n, "launches": launches["chain"], "wall_s": wall,
            "metrics": res, "ms_per_pair_median": med,
            "ms_per_pair_mean_after_first": mean_rest,
            "first_pair_ms": pair_ms[0], "pairs_per_s": n / native_s,
            "b1_per_pair": b1, "cpu_gap": gap, "cpu_var_rel_gap": var_gap,
            "rollout_device_ms": prof["all"] / 1e3 / CPU_PAIRS,
            "rollout_device_ops": prof["count"] / CPU_PAIRS}


# -- phase 14, 15 -------------------------------------------------------------
# The card's plans against the JAX planner's committed sets. An L1 fit
# turns last-bit differences into other kink crossings, so equally valid
# arithmetic spreads a fitted distance: on the H100 one FiveK color fit
# (train9) reads 0.0094669 planned in a lockstep batch of 8 and 0.0093636
# alone or in f64, and a GIER plan (4mv0hn) lands 1.24e-4-1.34e-4 from
# JAX's f32 plan in f32 and in f64 alike (scripts/torch_plan_noise.py). The
# distance bound sits above that floor; the others are twice to four
# times the largest gap measured (call 1: scalar 1.2e-2, JPEG 6 levels).
PLAN_DIST_TOL = 2e-4       # each step's distance; final ones at a parting
PLAN_INIT_TOL = 1e-6       # "init distance": the same images, one f64 mean
PLAN_SCALAR_TOL = 5e-2     # scalar ops' fitted parameters
PLAN_PIXEL_TOL = 12        # decoded edit{k}.jpg, 8-bit levels
CURVES = ("color", "tone")
FIVEK_ACTS = os.path.join("data_real_h2h_acts", "actions_set_1")
GIER_ACTS = os.path.join("data_real_gier_acts", "GIER_actions_set_1")
PLAN_PAIRS = 16
# Phase 31: the mesh's plans against the single card's b8 plans, where
# their top beams part: on an H100 80GB HBM3 at 700 W one pair of 16
# parted at its fifth op, final distances 0.022830 and 0.023179
# (3.49e-4); the bound is about three times that.
MESH_PART_TOL = 1e-3


def parting_step(got, want):
    """The first step at which two plans [(op, params, dist), ...] take
    other ops, or the shorter one's length."""
    k = 0
    while k < min(len(got), len(want)) and got[k][0] == want[k][0]:
        k += 1
    return k


def compare_plans(name, items,
                  against="the JAX planner's committed set"):
    """Hold the card's plans to a reference, by default the committed JAX
    set: items are (label, port item dir, reference item dir, json name).

    Where the top beams take the same ops: each step's distance within
    PLAN_DIST_TOL, the scalar ops' parameters within PLAN_SCALAR_TOL and
    the decoded edit JPEGs within PLAN_PIXEL_TOL levels. A curve's knots
    are held through its edit images only: its output divides by the knot
    sum and reads no knot whose segment holds no pixel, so many knot
    vectors give one image (their raw gap is printed). Where the ops
    differ: a near-tie, the two top beams' final distances (the ranking
    by which the beam search chose them) within PLAN_DIST_TOL, printed
    with JAX's beams. Every init distance within PLAN_INIT_TOL."""
    import cv2

    gaps = {"init": 0.0, "dist": 0.0, "scalar": 0.0, "curve_raw": 0.0,
            "pixel": 0}
    ties, broken = [], []
    for label, pdir, jdir, fname in items:
        with open(os.path.join(pdir, fname)) as f:
            g = json.load(f)
        with open(os.path.join(jdir, fname)) as f:
            w = json.load(f)
        gaps["init"] = max(gaps["init"],
                           abs(g["init distance"] - w["init distance"]))
        gs, ws = g["operation sequence"][0], w["operation sequence"][0]
        k = parting_step(gs, ws)
        for a, b in zip(gs[:k], ws[:k]):
            gaps["dist"] = max(gaps["dist"], abs(a[2] - b[2]))
            key = "curve_raw" if a[0] in CURVES else "scalar"
            if a[1]:
                gaps[key] = max(gaps[key], float(np.abs(
                    np.asarray(a[1]) - np.asarray(b[1])).max()))
        if k < max(len(gs), len(ws)):
            final = (gs[-1][2] if gs else g["init distance"],
                     ws[-1][2] if ws else w["init distance"])
            row = (label, k, final, [(a[0], round(a[2], 7)) for a in gs],
                   [[(a[0], round(a[2], 7)) for a in b]
                    for b in w["operation sequence"]])
            tie = abs(final[0] - final[1]) <= PLAN_DIST_TOL
            (ties if tie else broken).append(row)
            continue
        for k in range(len(gs)):
            pa = cv2.imread(os.path.join(pdir, f"edit{k}.jpg"))
            ja = cv2.imread(os.path.join(jdir, f"edit{k}.jpg"))
            if pa is None or ja is None:
                fail(f"{name}: {label} lacks edit{k}.jpg")
            gaps["pixel"] = max(gaps["pixel"], int(np.abs(
                pa.astype(np.int32) - ja.astype(np.int32)).max()))
    log(f"  {name} against {against}, {len(items)} "
        f"pairs: {len(items) - len(ties) - len(broken)} with the same "
        f"top-beam ops; largest gaps: init distance {gaps['init']:.3e} "
        f"(bound {PLAN_INIT_TOL}), step distance {gaps['dist']:.3e} (bound "
        f"{PLAN_DIST_TOL}), scalar parameter {gaps['scalar']:.3e} (bound "
        f"{PLAN_SCALAR_TOL}), curve knot {gaps['curve_raw']:.3e} (raw, held "
        f"through the images), edit JPEG {gaps['pixel']} levels (bound "
        f"{PLAN_PIXEL_TOL})")
    for label, k, final, got, beams in ties + broken:
        log(f"  {label}: the plans part at step {k}, final distances card "
            f"{final[0]:.7f}, reference {final[1]:.7f}: card {got}; the "
            f"reference's beams {beams}")
    if broken:
        fail(f"{name}: {len(broken)} plans differ beyond a near-tie: "
             f"{[r[0] for r in broken]}")
    if not (gaps["init"] <= PLAN_INIT_TOL and gaps["dist"] <= PLAN_DIST_TOL
            and gaps["scalar"] <= PLAN_SCALAR_TOL
            and gaps["pixel"] <= PLAN_PIXEL_TOL):
        fail(f"{name}: the card's plans disagree with {against}: {gaps}")
    return {**gaps, "near_ties": [r[0] for r in ties],
            "same_ops": len(items) - len(ties) - len(broken)}


def fit_step_profile(imgs, tgts, ops, masks=None):
    """Device ms of one lockstep `fit_select_update` at a later step (3
    beams per pair, every candidate allowed), by torch.profiler, its
    host-clock ms (synchronised, median of 3), and the card's idle share
    over the call."""
    from t2onet_tpu_torch.planner import fit

    p = imgs.shape[0]
    buf = imgs[:, None].repeat(1, 3, 1, 1, 1)
    init = torch.from_numpy(fit.init_candidates(ops, 2, key=10)).cuda()
    allow = torch.ones((p, 3, len(ops)), dtype=torch.bool, device="cuda")
    thr = torch.full((p,), float("inf"), device="cuda")

    def call():
        return fit.fit_select_update(buf, tgts, init, allow, thr, ops, 2, 3,
                                     masks=masks)

    prof = profiled_us(call, calls=1)
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(wall)
    return {"device_ms": prof["all"] / 1e3, "device_ops": prof["count"],
            "wall_ms": wall_ms, "idle_share": 1 - prof["all"] / 1e3 / wall_ms}


def timed_batches(generate_module):
    """Wrap generate_module.batch_beam_search to keep each lockstep
    batch's host-clock seconds; returns (list, restore)."""
    times = []
    orig = generate_module.batch_beam_search

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)         # returns numpy: synchronised
        times.append(time.perf_counter() - t0)
        return out

    generate_module.batch_beam_search = timed

    def restore():
        generate_module.batch_beam_search = orig

    return times, restore


def plan_fivek_phase():
    """`cli.plan_fivek` on the card at the committed set's settings
    (b8 lockstep, 128 px, seed 10) for the first 16 FiveK train pairs,
    held to data_real_h2h_acts/actions_set_1; pairs/s, s per lockstep
    batch, one fit step's device ms and the card's idle share."""
    from t2onet_tpu_torch.cli import plan_fivek
    from t2onet_tpu_torch.data.fivek import FiveK
    from t2onet_tpu_torch.planner import fit, generate

    out = os.path.join("output", "chip_smoke_plan_fivek")
    shutil.rmtree(out, ignore_errors=True)
    reset_launches()
    batches, restore = timed_batches(generate)
    try:
        t0 = time.perf_counter()
        n = plan_fivek.main(["--device", "cuda", "--data_dir",
                             "data_real_h2h", "--limit", str(PLAN_PAIRS),
                             "--pair_batch", "8", "--img_size", "128",
                             "--manual_seed", "10", "--out_dir", out])
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = dict(chain.LAUNCHES)
    log(f"plan_fivek: {n} pairs in {wall:.2f} s (host clock, JPEG load and "
        f"writes included): {n / wall:.3f} pairs/s; lockstep batches of 8 "
        f"{[round(s, 3) for s in batches]} s; kernel launches {launches}")
    if n != PLAN_PAIRS or any(launches.values()):
        fail(f"plan_fivek planned {n} pairs with launches {launches}: want "
             f"{PLAN_PAIRS} and none (the planner runs no kernel)")
    res = compare_plans("plan_fivek", [
        (f"train{i}", os.path.join(out, f"train{i}"),
         os.path.join(FIVEK_ACTS, f"train{i}"), f"{i:05d}.json")
        for i in range(PLAN_PAIRS)])
    ds = FiveK(os.path.join("data_real_h2h", "FiveK", "images"),
               os.path.join("data_real_h2h", "FiveK", "annotations"),
               "train", 1, 128, eval_img_mode="train_size")
    items = [ds[i] for i in range(8)]
    imgs = torch.from_numpy(np.stack([it[0] for it in items])).cuda()
    tgts = torch.from_numpy(np.stack([it[1] for it in items])).cuda()
    fs = fit_step_profile(imgs, tgts, fit.DEFAULT_PLAN_OPS)
    log(f"  one fit_select_update (b8 pairs x 3 beams x 6 ops x 2 starts, "
        f"128 px, 100 Adam iterations): {fs['device_ms']:.2f} ms of device "
        f"operations in {fs['device_ops']:.0f} (torch.profiler) against "
        f"{fs['wall_ms']:.2f} ms of host clock: the card idle "
        f"{fs['idle_share']:.1%}")
    return {"pairs": n, "wall_s": wall, "pairs_per_s": n / wall,
            "s_per_batch": batches, "launches": sum(launches.values()),
            "fit_step": fs, **res}


def plan_gier_phase():
    """`cli.plan_gier` on the card for the first 16 GIER shapeAlign train
    pairs (masks, all 8 ops, err 1e-3, b8 lockstep, 128 px, seed 10),
    held to data_real_gier_acts/GIER_actions_set_1."""
    from t2onet_tpu_torch.cli import plan_gier
    from t2onet_tpu_torch.data.gier import GIER
    from t2onet_tpu_torch.planner import beam

    out = os.path.join("output", "chip_smoke_plan_gier")
    shutil.rmtree(out, ignore_errors=True)
    reset_launches()
    batches, restore = timed_batches(plan_gier)
    try:
        t0 = time.perf_counter()
        n = plan_gier.main(["--device", "cuda", "--data_dir",
                            "data_real_gier", "--data_mode", "shapeAlign",
                            "--limit", str(PLAN_PAIRS), "--pair_batch", "8",
                            "--img_size", "128", "--manual_seed", "10",
                            "--out_dir", out])
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = dict(chain.LAUNCHES)
    log(f"plan_gier: {n} pairs in {wall:.2f} s (host clock, JPEG and mask "
        f"load and writes included): {n / wall:.3f} pairs/s; lockstep "
        f"batches of 8 {[round(s, 3) for s in batches]} s; kernel launches "
        f"{launches}")
    if n != PLAN_PAIRS or any(launches.values()):
        fail(f"plan_gier planned {n} pairs with launches {launches}: want "
             f"{PLAN_PAIRS} and none")
    gier = GIER(os.path.join("data_real_gier", "GIER"),
                os.path.join("data_real_gier", "language"), "train",
                data_mode="shapeAlign", is_load_mask=True,
                train_img_size=128)
    ids = [gier.op_data[i]["input"].split("_")[0] for i in range(PLAN_PAIRS)]
    res = compare_plans("plan_gier", [
        (d, os.path.join(out, d), os.path.join(GIER_ACTS, d), "acts.json")
        for d in ids])
    items = [gier.get_pair_item(i) for i in range(8)]
    masks = [{int(k) - 3: m[None] for k, m in it["mask_dict"].items()}
             for it in items]
    ops = tuple(range(8))
    fs = fit_step_profile(
        torch.from_numpy(np.stack([it["input"] for it in items])).cuda(),
        torch.from_numpy(np.stack([it["output"] for it in items])).cuda(),
        ops, beam._op_mask_rows(masks, ops, (128, 128), "cuda"))
    log(f"  one fit_select_update (b8 pairs x 3 beams x 8 ops x 2 starts, "
        f"128 px, masks): {fs['device_ms']:.2f} ms of device operations in "
        f"{fs['device_ops']:.0f} against {fs['wall_ms']:.2f} ms of host "
        f"clock: the card idle {fs['idle_share']:.1%}")
    return {"pairs": n, "wall_s": wall, "pairs_per_s": n / wall,
            "s_per_batch": batches, "launches": sum(launches.values()),
            "fit_step": fs, **res}


# -- phase 16 -----------------------------------------------------------------
FIVEK_RUN_DIR = os.path.join("output", "chip_smoke_fivek_real")
FIVEK_TRAIN_ARGV = ["--device", "cuda", "--data_dir", "data_real_h2h",
                    "--act_dir", FIVEK_ACTS, "--glove_path", FIVEK_GLOVE_NPY,
                    "--batch_size", "64", "--img_size", "128",
                    "--num_iters", "8", "--print_every", "2",
                    "--checkpoint_every", "8", "--val_batches", "1",
                    "--fused_exec", "1", "--run_dir", FIVEK_RUN_DIR]


def fivek_real_train_phase():
    """`cli.train_fivek` on the repo's real FiveK train pairs and the JAX
    planner's actions at ModelConfig() widths (GloVe rows frozen), b64,
    128 px, 8 iterations with validation on real FiveK val: B1 and B3
    launched exactly as the steps count them."""
    from t2onet_tpu_torch.data.text import load_embedding

    shutil.rmtree(FIVEK_RUN_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    state = train_fivek.main(FIVEK_TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    steps = state.actor.cfg.decoder_max_len
    want = 4 * steps
    log(f"fivek real train: 8 iterations in {wall:.2f} s (host clock, JPEGs "
        f"decoded on the fly into the item cache, validation and checkpoint "
        f"included); launches {launches}, want step_bwd = {want}, chain = "
        f"{want} + {steps} (one validation batch), no masked kernel")
    if state.step != 8:
        fail(f"the FiveK trainer stopped at step {state.step}, not 8")
    if not (launches["step_bwd"] == want
            and launches["chain"] == want + steps
            and launches["chain_masked"] == launches["step_bwd_masked"] == 0):
        fail(f"FiveK real-data launches {launches}: want {want} step_bwd "
             f"(4 episode iterations x {steps} steps), {want + steps} chain "
             f"and no masked kernel")
    losses = logged_losses(os.path.join(FIVEK_RUN_DIR, "metrics.jsonl"))
    log(f"  logged {losses}")
    if not any(k == "val_L1" for _, k, _ in losses) or \
            not all(math.isfinite(v) for _, _, v in losses):
        fail(f"non-finite or missing FiveK losses: {losses}")
    glove = load_embedding(FIVEK_GLOVE_NPY)
    emb = state.actor.lang_encoder.embedding.weight.detach().cpu()
    if not torch.equal(emb[4:], torch.from_numpy(glove)):
        fail("the FiveK GloVe word rows were not frozen at their values")
    return state, launches


def fivek_real_timing_phase(state):
    """The host's ms per b64 FiveKAct batch with the item cache cold and
    warm (the same 64 items twice), then each phase's step time on that
    real batch already on the card."""
    a = train_fivek.train_parser().parse_args(FIVEK_TRAIN_ARGV)
    ds = common.build_dataset_and_vocab(a, "train", wire_u8=True)[0]
    host = {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        nb = next(ds.batches(64, 1, shuffle=True, seed=11))
        host[name] = (time.perf_counter() - t0) * 1e3
    sup = device_put_batch({k: nb[k] for k in ("x", "y", "img_x", "img_y",
                                               "gt_params")}, "cuda")
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1]}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)

    s_ms = statistics.median(timed(lambda: loop.supervised_step(state, sup)))
    e_ms = statistics.median(timed(lambda: loop.episode_step(
        state, epi, gen, fused_exec=True)))
    log(f"fivek real step times, b64 128 px, ModelConfig(), TF32 off (host "
        f"clock around each step, synchronised; medians of 6 after 2 "
        f"warm-ups): supervised {s_ms:.2f} ms, episode (fused) {e_ms:.2f} "
        f"ms; host ms per b64 FiveKAct batch: cache cold "
        f"{host['cold']:.1f}, warm {host['warm']:.1f}")
    return {"sup_ms": s_ms, "epi_fused_ms": e_ms,
            "host_ms_per_batch_cold": host["cold"],
            "host_ms_per_batch_warm": host["warm"]}


def fivek_real_card_vs_cpu_phase():
    """One supervised and one sampled episode step of a full-width FiveK
    actor (GloVe rows frozen, curve knots near 1) on one real b8 FiveKAct
    batch at 64 px, the same weights and Gumbel noise: the card (B1, B3)
    against the CPU (their plain versions), within phase 9's bounds."""
    from t2onet_tpu_torch.data.fivek import FiveKAct
    from t2onet_tpu_torch.data.text import load_embedding

    glove = load_embedding(FIVEK_GLOVE_NPY)
    ds = FiveKAct(os.path.join("data_real_h2h", "FiveK", "images"),
                  os.path.join("data_real_h2h", "FiveK", "annotations"),
                  FIVEK_ACTS, "train", 1, 64)
    nb = next(ds.batches(8, 1, shuffle=True, seed=2))
    cfg = ModelConfig(fix_input_embedding=True)
    actor = Actor(cfg, OperatorConfig(), glove.shape[0] + 4,
                  generator=torch.Generator().manual_seed(3), word2vec=glove)
    knots_near_one(actor)
    g = torch.Generator().manual_seed(11)
    draws = [bank.gumbel_noise((8, cfg.op_vocab_size), g)
             for _ in range(cfg.decoder_max_len)]
    out = {}
    for phase in ("supervised", "episode"):
        lc, lp, rel, per, stats = step_card_vs_cpu(actor, nb, phase, draws)
        log(f"card vs CPU {phase} step (b8 real FiveK items, 64 px, full "
            f"width, GloVe rows{', same noise' if phase == 'episode' else ''}"
            f"): loss {lc:.7f} vs {lp:.7f}; gradients ||card - cpu|| / "
            f"||cpu|| {rel:.2e}; worst tensors' error / bound "
            f"{[(n, round(r, 4)) for r, n in per[:3]]}; BN running stats "
            f"max diff {stats:.2e}")
        if not within_phase9(lc, lp, rel, per, stats):
            fail(f"the card's real-data FiveK {phase} step disagrees with "
                 f"the CPU's")
        out[phase] = {"loss_card": lc, "loss_cpu": lp, "grad_rel": rel,
                      "worst_tensor": per[0][0], "bn_stats": stats}
    return out


# -- phase 17 -----------------------------------------------------------------
# The actor's other modes through the FiveK trainer at ModelConfig() width,
# b64 x 128 px, synthetic data: f32 (the reference), the ResNet in bf16, the
# episode decoded at a 64 px probe, discrete parameters, per-step BatchNorm.
MODES = (("f32", ()), ("bf16", ("--vis_bf16", "1")),
         ("probe64", ("--episode_probe", "64")),
         ("discrete", ("--discrete_param", "1")),
         ("per_step_bn", ("--per_step_bn",)))
MODE_ITERS = 4
PROFILED_MODES = ("f32", "bf16", "probe64")    # with device time, conv share
MODE_ARGV = ["--synthetic", "--device", "cuda", "--batch_size", "64",
             "--img_size", "128", "--num_iters", str(MODE_ITERS),
             "--print_every", "2", "--checkpoint_every", str(MODE_ITERS),
             "--val_batches", "1", "--fused_exec", "1"]
# bf16 keeps 8 bits of mantissa, a relative step of 3.9e-3 per rounding,
# and every convolution and activation of the ResNet rounds once. Against
# f32 on the card (the same weights, b64 x 128 px): the train-BN features
# within BF16_FEAT_RTOL of their largest magnitude, one supervised step's
# gradients within BF16_GRAD_RTOL of their norm. Card against CPU, both in
# bf16 (cuDNN and oneDNN sum in other orders, so single roundings land one
# bf16 step apart): the loss within BF16_LOSS_RTOL, the gradients within
# BF16_GRAD_RTOL. Measured on an H100 80GB HBM3 at 700 W: features 2.6e-2,
# gradients 4.6e-2 against f32 and 1.05e-1 card against CPU at b8 x 64 px,
# most of it in the BatchNorm biases, whose gradients are sums that
# cancel; losses equal to 8 digits. A wrong cast or gradient path moves
# either by its whole size. A sampled rollout is not compared in bf16:
# its op draws part wherever two candidates' log-probs lie closer than
# bf16's noise.
BF16_FEAT_RTOL = 6e-2
BF16_GRAD_RTOL = 2.5e-1
BF16_LOSS_RTOL = 1e-3
CONV_OPS = ("aten::convolution", "aten::convolution_backward")


def conv_profile(fn, calls=2):
    """fn's device time per call (every kernel and copy, torch.profiler
    over `calls` calls after one warm-up), the part of it under the
    convolutions' ops (CONV_OPS, forward and backward: their kernels
    found through the profiler's op tree), kernels per call, and the
    five kernels (by name) that take most of it: (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = conv = 0.0
    n = 0
    by_name = {}
    for e in prof.events():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = e.cuda_time_total
        if e.device_type == DeviceType.CUDA:
            total += t
            n += 1
            ms, count = by_name.get(e.name[:48], (0.0, 0))
            by_name[e.name[:48]] = (ms + t / calls / 1e3, count + 1 / calls)
        elif e.name in CONV_OPS:
            conv += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_ms": total / calls / 1e3, "conv_ms": conv / calls / 1e3,
            "conv_share": conv / total if total else float("nan"),
            "kernels": n / calls,
            "top": [(k, round(ms, 3), round(c)) for k, (ms, c) in top]}


def mode_batches():
    """One b64 synthetic batch at 128 px on the card, as each phase of the
    trainer ships it (phase 8's)."""
    ds = SyntheticFiveK(n=64, img_size=128, seed=5)
    nb = next(ds.batches(64, 1, shuffle=False))
    sup = device_put_batch({k: nb[k] for k in SUP_KEYS}, "cuda")
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1]}, "cuda")
    return sup, epi


def mode_phase(name, flags, batches):
    """`train_fivek.main` with one mode's flags for MODE_ITERS iterations:
    launches (B1 and B3 5 times per episode iteration, B1 5 more for the
    validation batch, no masked kernel), finite losses, the mode in the
    actor's config; then each phase's step time on `batches`, and for
    PROFILED_MODES each step's device time and convolutions' share
    (conv_profile)."""
    run_dir = os.path.join("output", f"chip_smoke_mode_{name}")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = MODE_ARGV + list(flags) + ["--run_dir", run_dir]
    a = train_fivek.train_parser().parse_args(argv)
    reset_launches()
    t0 = time.perf_counter()
    state = train_fivek.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    cfg = state.actor.cfg
    steps = cfg.decoder_max_len
    want = MODE_ITERS // 2 * steps
    losses = logged_losses(os.path.join(run_dir, "metrics.jsonl"))
    log(f"mode {name} {list(flags)}: {MODE_ITERS} iterations in {wall:.2f} "
        f"s (host clock, data made on the fly, validation and checkpoint "
        f"included); launches {launches}, want step_bwd = {want}, chain = "
        f"{want} + {steps}; logged {losses}")
    if state.step != MODE_ITERS:
        fail(f"mode {name}: the trainer stopped at step {state.step}")
    if not (launches["step_bwd"] == want
            and launches["chain"] == want + steps
            and launches["chain_masked"] == launches["step_bwd_masked"] == 0):
        fail(f"mode {name}: launches {launches}, want {want} step_bwd, "
             f"{want + steps} chain and no masked kernel")
    if (cfg.vis_bf16, cfg.discrete_param) != (bool(a.vis_bf16),
                                              bool(a.discrete_param)):
        fail(f"mode {name}: the actor's config {cfg} lost the flags")
    if not any(k == "val_L1" for _, k, _ in losses) or \
            not all(math.isfinite(v) for _, _, v in losses):
        fail(f"mode {name}: non-finite or missing losses {losses}")
    sup, epi = batches
    gen = torch.Generator(device="cuda").manual_seed(7)
    probe = a.episode_probe or None

    def sup_step():
        return loop.supervised_step(state, sup, per_step_bn=a.per_step_bn)

    def epi_step():
        return loop.episode_step(state, epi, gen, fused_exec=True,
                                 probe_size=probe)

    out = {"launches": launches, "wall_s": wall,
           "sup_ms": statistics.median(timed(sup_step)),
           "epi_ms": statistics.median(timed(epi_step))}
    if name in PROFILED_MODES:
        out.update(sup_profile=conv_profile(sup_step),
                   epi_profile=conv_profile(epi_step))
    log(f"  mode {name} step times, b64 128 px, ModelConfig(), TF32 off "
        f"(host clock, synchronised; medians of 6 after 2 warm-ups): "
        f"supervised {out['sup_ms']:.2f} ms, episode (fused"
        f"{f', probe {probe} px' if probe else ''}) {out['epi_ms']:.2f} ms"
        + (f"; device (torch.profiler, 2 steps): supervised "
           f"{out['sup_profile']}, episode {out['epi_profile']}"
           if name in PROFILED_MODES else ""))
    return out


def bf16_vs_f32_phase(batches):
    """A full-width actor in f32 and the same weights with the ResNet in
    bf16, on the card, on phase 17's b64 batch: the train-BN features
    within BF16_FEAT_RTOL, one supervised step's gradients within
    BF16_GRAD_RTOL (their norm)."""
    vocab = synthetic_vocab()
    cfg = ModelConfig()
    f32 = Actor(cfg, OperatorConfig(), len(vocab),
                generator=torch.Generator().manual_seed(3))
    b16 = Actor(dataclasses.replace(cfg, vis_bf16=True), OperatorConfig(),
                len(vocab), generator=torch.Generator().manual_seed(0))
    b16.load_state_dict(f32.state_dict())
    f32, b16 = f32.cuda(), b16.cuda()
    sup, _ = batches
    # train-mode BN: with the init's running statistics (0, 1) eval-mode
    # activations shrink through the blocks and fc's bias is all that
    # is left of the features
    with torch.no_grad():
        ff = f32.train().vis_encoder(sup["img_x"])
        fb = b16.train().vis_encoder(sup["img_x"])
    if fb.dtype != torch.float32:
        fail(f"the bf16 encoder returned {fb.dtype}")
    feat = float((fb - ff).abs().max() / ff.abs().max())
    sf, sb = loop.TrainState(f32), loop.TrainState(b16)
    lf = float(loop.supervised_step(sf, sup)["loss"])
    lb = float(loop.supervised_step(sb, sup)["loss"])
    rel, per, stats = grad_gap(sb, sf)
    log(f"bf16 vs f32 on the card (full width, b64 128 px): train-BN "
        f"features max |bf16 - f32| / max |f32| {feat:.3e} (bound "
        f"{BF16_FEAT_RTOL}); one supervised step: loss {lb:.6f} vs "
        f"{lf:.6f}, gradients ||bf16 - f32|| / ||f32|| {rel:.3e} (bound "
        f"{BF16_GRAD_RTOL}), worst tensors' error / (5e-2 own norm) "
        f"{[(n, round(r, 3)) for r, n in per[:3]]}, BN running stats max "
        f"diff {stats:.3e}")
    if not (feat <= BF16_FEAT_RTOL and rel <= BF16_GRAD_RTOL
            and math.isfinite(lb)):
        fail("the bf16 ResNet strays from the f32 one past bf16's bounds")
    return {"feat_rel": feat, "grad_rel": rel, "loss_bf16": lb,
            "loss_f32": lf, "bn_stats": stats}


def mode_card_vs_cpu_phase(name, flags):
    """One supervised and one sampled episode step (the same Gumbel noise,
    also for discrete bins) of a full-width actor in one mode, b8 at 64
    px (a 32 px probe for probe64), on the card against the CPU: phase
    9's bounds; in bf16 the supervised step alone, within the bf16
    bounds."""
    a = train_fivek.train_parser().parse_args(MODE_ARGV + list(flags))
    cfg = dataclasses.replace(ModelConfig(), vis_bf16=bool(a.vis_bf16),
                              discrete_param=bool(a.discrete_param))
    actor = knots_near_one(Actor(cfg, OperatorConfig(),
                                 len(synthetic_vocab()),
                                 generator=torch.Generator().manual_seed(3)))
    nb = next(SyntheticFiveK(n=8, img_size=64, seed=9)
              .batches(8, 1, shuffle=False))
    g = torch.Generator().manual_seed(11)
    draws = []
    for _ in range(cfg.decoder_max_len):
        draws.append(bank.gumbel_noise((8, cfg.op_vocab_size), g))
        if cfg.discrete_param:
            draws.append(bank.gumbel_noise((8, 8, cfg.discrete_step), g))
    out = {}
    for phase in ("supervised",) if cfg.vis_bf16 else ("supervised",
                                                       "episode"):
        lc, lp, rel, per, stats = step_card_vs_cpu(
            actor, nb, phase, draws, per_step_bn=a.per_step_bn,
            probe=32 if a.episode_probe else None)
        log(f"mode {name} card vs CPU {phase} step (b8, 64 px, full "
            f"width): loss {lc:.7f} vs {lp:.7f}; gradients ||card - cpu|| "
            f"/ ||cpu|| {rel:.2e}; worst tensors' error / bound "
            f"{[(n, round(r, 4)) for r, n in per[:3]]}; BN running stats "
            f"max diff {stats:.2e}")
        if cfg.vis_bf16:
            ok = (abs(lc - lp) <= BF16_LOSS_RTOL * abs(lp)
                  and rel <= BF16_GRAD_RTOL)
        else:
            ok = within_phase9(lc, lp, rel, per, stats)
        if not ok:
            fail(f"mode {name}: the card's {phase} step disagrees with the "
                 f"CPU's")
        out[phase] = {"loss_card": lc, "loss_cpu": lp, "grad_rel": rel,
                      "worst_tensor": per[0][0], "bn_stats": stats}
    return out


# -- phase 18 -----------------------------------------------------------------
GIER_MODES_RUN_DIR = os.path.join("output", "chip_smoke_gier_modes")
GIER_MODES_ARGV = GIER_ARGV + ["--num_iters", "4", "--checkpoint_every", "4",
                               "--vis_bf16", "1", "--episode_probe", "64",
                               "--run_dir", GIER_MODES_RUN_DIR]


def gier_modes_phase():
    """`train_gier --is_load_mask 1 --vis_bf16 1 --episode_probe 64` on the
    real GIER data at full width, 4 iterations: B2 and B4 exactly 8 times
    per episode iteration, no B3, B1 only for the validation batch (8);
    then each phase's step time on a GIER batch on the card."""
    from t2onet_tpu_torch.cli import train_gier

    shutil.rmtree(GIER_MODES_RUN_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    state = train_gier.main(GIER_MODES_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    cfg = state.actor.cfg
    want = 2 * cfg.decoder_max_len
    losses = logged_losses(os.path.join(GIER_MODES_RUN_DIR,
                                        "metrics.jsonl"))
    log(f"gier bf16 + probe 64: 4 iterations in {wall:.2f} s; launches "
        f"{launches}, want chain_masked = step_bwd_masked = {want}, chain = "
        f"{cfg.decoder_max_len} (validation), step_bwd = 0; logged {losses}")
    if state.step != 4 or not cfg.vis_bf16:
        fail(f"the GIER modes run stopped at {state.step} or lost bf16")
    if not (launches["chain_masked"] == launches["step_bwd_masked"] == want
            and launches["chain"] == cfg.decoder_max_len
            and launches["step_bwd"] == 0):
        fail(f"GIER modes launches {launches}")
    if not losses or not all(math.isfinite(v) for _, _, v in losses):
        fail(f"non-finite or missing GIER modes losses: {losses}")
    a = train_gier.train_parser().parse_args(GIER_MODES_ARGV)
    ds = common.build_dataset_and_vocab(a, "train", wire_u8=True)[0]
    nb = next(ds.batches(64, 1, shuffle=True, seed=4))
    sup = device_put_batch({k: nb[k] for k in SUP_KEYS}, "cuda")
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1],
                            "masks_vocab": nb["masks_vocab"]}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    s_ms = statistics.median(timed(lambda: loop.supervised_step(state, sup)))
    e_ms = statistics.median(timed(lambda: loop.episode_step(
        state, epi, gen, fused_exec=True, probe_size=64)))
    log(f"  gier bf16 + probe 64 step times, b64 128 px (medians of 6): "
        f"supervised {s_ms:.2f} ms, masked episode {e_ms:.2f} ms")
    return {"launches": launches, "wall_s": wall, "sup_ms": s_ms,
            "epi_masked_ms": e_ms}


# -- phase 19 -----------------------------------------------------------------
def serve_r50_phase():
    """32 requests at 512 px through ServingEngine(device="cuda") with a
    full-width random depth-50 actor (Bottleneck ResNet): B1 once per
    micro-batch, the first 4 requests' programs equal to the CPU's and
    their images within 1 LSB; then the decode of a b8 micro-batch at 128
    px (host clock, and device time by torch.profiler) beside ResNet-18's,
    and the request rate over the 32 requests."""
    vocab = make_vocab()
    imgs = make_images(32, 512, 512, seed=0)
    reqs = [TEXTS[i % len(TEXTS)] for i in range(len(imgs))]
    kw = dict(decode_size=128, max_batch=8, u8_wire=True,
              encoder_max_len=ModelConfig().encoder_max_len)
    out = {}
    for depth in (50, 18):
        actor = knots_near_one(Actor(
            ModelConfig(resnet_depth=depth), OperatorConfig(), len(vocab),
            generator=torch.Generator().manual_seed(0)))
        actor_cpu = copy.deepcopy(actor) if depth == 50 else None
        engine = ServingEngine(actor, vocab, device="cuda", **kw)
        if depth == 50:
            reset_launches()
            results = engine.edit_batch(imgs, reqs)
            launches = dict(chain.LAUNCHES)
            nb = engine.stats["batches"]
            log(f"serve ResNet-50: {len(results)} requests in {nb} "
                f"micro-batches; launches {launches}; first programs "
                f"{[r.ops for r in results[:4]]}")
            if launches["chain"] != nb or nb != 4 or \
                    launches["step_bwd"] != 0:
                fail(f"ResNet-50 serving launches {launches} over {nb} "
                     f"micro-batches (want 4 chain)")
            if any(r is None or not np.isfinite(r.image).all()
                   for r in results):
                fail("ResNet-50 serving lost or broke a request")
            cpu = ServingEngine(actor_cpu, vocab, device="cpu", **kw)
            ref = cpu.edit_batch(imgs[:4], reqs[:4])
            for g, r in zip(results[:4], ref):
                lsb = np.abs(g.image - r.image).max() * 255
                if g.ops != r.ops or lsb > 1.0 + 1e-3 or any(
                        np.abs(np.array(pg) - np.array(pr)).max() > 1e-4 + 1e-6
                        for pg, pr in zip(g.params, r.params)):
                    fail(f"ResNet-50 card vs CPU: {g.ops} vs {r.ops}, "
                         f"{lsb} LSB")
            log(f"  card vs CPU, first 4 requests: same programs, images "
                f"within 1 LSB")
            out["launches"] = launches
        x = torch.from_numpy(np.stack([engine._tokenize(r)
                                       for r in reqs[:8]])).cuda()
        probe = torch.from_numpy(np.stack(imgs[:8])).cuda()
        probe = torch.nn.functional.interpolate(
            probe, size=(128, 128), mode="bilinear", align_corners=False)

        def decode(actor=engine.actor, x=x, probe=probe):
            with torch.inference_mode():
                return actor.episode(x, probe)

        ms = statistics.median(timed(decode, n=10, warmup=3))
        dev = profiled_us(decode)
        engine.warmup(buckets=[(512, 512)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.edit_batch(imgs, reqs)
        torch.cuda.synchronize()
        rate = len(imgs) / (time.perf_counter() - t0)
        n_params = sum(p.numel() for p in actor.parameters())
        log(f"  ResNet-{depth} actor ({n_params} parameters): decode of a "
            f"b8 micro-batch at 128 px {ms:.2f} ms (host clock, median of "
            f"10), {dev['all'] / 1e3:.2f} ms of device work in "
            f"{dev['count']:.0f} operations; {rate:.2f} req/s over 32 "
            f"requests at 512 px")
        out[f"r{depth}"] = {"decode_ms": ms, "decode_device_ms":
                            dev["all"] / 1e3, "req_s": rate,
                            "params": n_params}
    return out


# -- phase 20 -----------------------------------------------------------------
RL_RUN_DIR = os.path.join("output", "chip_smoke_rl")
RL_ARGV = ["--synthetic", "--device", "cuda", "--batch_size", "64",
           "--img_size", "128", "--warmup", "2", "--num_iters", "6",
           "--param_noise", "0.6", "--print_every", "2",
           "--checkpoint_every", "8", "--val_batches", "1",
           "--run_dir", RL_RUN_DIR]


def rl_phase(batches):
    """`cli.train_rl` at full width, b64 x 128 px: 2 warmup and 6 RL
    iterations with parameter noise 0.6. The RL rollout runs through the
    bank, so the run launches B1 only for its validation batch (5) and no
    other kernel; finite losses and a checkpoint; then the RL step's time
    (host clock and device) on phase 17's batch, and one RL step (b8, 64
    px, the same noise) on the card against the CPU, within phase 9's
    bounds."""
    from t2onet_tpu_torch.cli import train_rl
    from t2onet_tpu_torch.train import rl

    shutil.rmtree(RL_RUN_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    state = train_rl.main(RL_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    steps = state.actor.cfg.decoder_max_len
    losses = logged_losses(os.path.join(RL_RUN_DIR, "rl_metrics.jsonl"),
                           ("loss", "rl_loss", "rl_l1", "rl_pg",
                            "rl_entropy", "val_L1"))
    log(f"rl: 2 warmup + 6 RL iterations in {wall:.2f} s; launches "
        f"{launches}, want chain = {steps} (validation) and no other; "
        f"logged {losses}")
    if state.step != 8:
        fail(f"the RL trainer stopped at step {state.step}")
    if launches != {**{k: 0 for k in launches}, "chain": steps}:
        fail(f"RL launches {launches}: the RL iterations must launch no "
             f"kernel and the validation {steps} chains")
    if not any(k == "rl_pg" for _, k, _ in losses) or \
            not all(math.isfinite(v) for _, _, v in losses):
        fail(f"non-finite or missing RL losses: {losses}")
    if not os.path.exists(os.path.join(RL_RUN_DIR, "seq2seqRL_model",
                                       "checkpoint_iter00000008.pt")):
        fail("the RL trainer wrote no checkpoint at iteration 8")
    _, epi = batches
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rl_step():
        return rl.rl_step(state, epi, gen, param_noise=0.6)

    r_ms = statistics.median(timed(rl_step))
    prof = profiled_us(rl_step)

    actor = knots_near_one(Actor(ModelConfig(), OperatorConfig(),
                                 len(synthetic_vocab()),
                                 generator=torch.Generator().manual_seed(3),
                                 explore_prob=0.0))
    nb = next(SyntheticFiveK(n=8, img_size=64, seed=9)
              .batches(8, 1, shuffle=False))
    g = torch.Generator().manual_seed(11)
    draws = [bank.gumbel_noise((8, 11), g) for _ in range(steps)]
    normals = [torch.randn((8, 8, 24), generator=g) for _ in range(steps)]
    before = dict(chain.LAUNCHES)
    lc, lp, rel, per, stats = step_card_vs_cpu(
        actor, nb, "rl", draws, normals=normals, param_noise=0.6)
    log(f"rl step, b64 128 px, full width, noise 0.6, through the bank: "
        f"{r_ms:.2f} ms (host clock, median of 6), {prof['all'] / 1e3:.2f} "
        f"ms of device work in {prof['count']:.0f} operations; card vs CPU "
        f"(b8, 64 px, same noise): loss {lc:.7f} vs {lp:.7f}, gradients "
        f"{rel:.2e}, worst {[(n, round(r, 4)) for r, n in per[:3]]}, BN "
        f"stats {stats:.2e}")
    if dict(chain.LAUNCHES) != before:
        fail("an RL step launched a kernel")
    if not within_phase9(lc, lp, rel, per, stats):
        fail("the card's RL step disagrees with the CPU's")
    return {"launches": launches, "wall_s": wall, "rl_step_ms": r_ms,
            "rl_step_device_ms": prof["all"] / 1e3,
            "card_vs_cpu": {"loss_card": lc, "loss_cpu": lp,
                            "grad_rel": rel, "worst_tensor": per[0][0],
                            "bn_stats": stats}}


# -- phase 21 -----------------------------------------------------------------
SERVE_THREADS = 8
LSB = 1.0 + 1e-3                 # images: within one 8-bit level


def same_results(name, got, want, lsb=LSB):
    """Fail unless two lists of EditResults give the same ops, params
    within 1e-4 (rounded to 4 places) and images within `lsb` levels;
    the largest image gap in levels."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None:
            fail(f"{name}: request {i} got no result")
        if g.ops != w.ops or len(g.params) != len(w.params) or any(
                np.abs(np.array(pg) - np.array(pw)).max() > 1e-4 + 1e-6
                for pg, pw in zip(g.params, w.params) if pg):
            fail(f"{name}: request {i} decoded {g.ops} {g.params}, want "
                 f"{w.ops} {w.params}")
        if g.image.shape != w.image.shape:
            fail(f"{name}: request {i} image {g.image.shape}, want "
                 f"{w.image.shape}")
        worst = max(worst, float(np.abs(g.image - w.image).max()) * 255)
    if len(got) != len(want) or not worst <= lsb:
        fail(f"{name}: {len(got)} results against {len(want)}, images "
             f"{worst:.3f} levels apart")
    return worst


def submit_all(engine, imgs, reqs, threads=SERVE_THREADS):
    """Submit the requests from `threads` threads (request i from thread
    i % threads); returns the handles in request order once all are
    done, and the host seconds from the first submit to the last done."""
    import threading

    pending = [None] * len(imgs)

    def client(k):
        for i in range(k, len(imgs), threads):
            pending[i] = engine.submit(imgs[i], reqs[i])

    workers = [threading.Thread(target=client, args=(k,))
               for k in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=120)
    if any(t.is_alive() for t in workers) or any(p is None for p in pending):
        fail("a client thread did not submit its requests")
    for p in pending:
        if not p.done.wait(timeout=120):
            fail("the batcher left a request unserved for 120 s")
    return pending, time.perf_counter() - t0


def serve_pipeline_phase():
    """The phase 7 actor behind ServingEngine and a MicroBatcher
    (linger 10 ms, pipeline depth 2): 8 threads submit 64 requests over
    two buckets; the results equal edit_batch's, B1 launches equal the
    micro-batches; the bank executor (use_pallas=False) and decode_native
    engines against the kernel's; device_compute_probe(512); req/s through
    the batcher beside edit_batch's, launch_s and sync_s; one micro-batch's
    device ms and the card's idle share (torch.profiler); a failing flush
    and a failing launch mark their requests and the batcher serves on."""
    from t2onet_tpu_torch.serve import MicroBatcher

    vocab = make_vocab()
    actor = knots_near_one(Actor(ModelConfig(), OperatorConfig(), len(vocab),
                                 generator=torch.Generator().manual_seed(0)))
    kw = dict(decode_size=128, max_batch=8, u8_wire=True,
              encoder_max_len=ModelConfig().encoder_max_len)
    engine = ServingEngine(actor, vocab, device="cuda", **kw)
    engine.warmup(buckets=[(512, 512), (384, 640)])
    imgs = make_images(48, 512, 512, seed=21) + make_images(16, 384, 640, 22)
    reqs = [TEXTS[i % len(TEXTS)] for i in range(len(imgs))]
    want = engine.edit_batch(imgs, reqs)

    def rate_edit_batch():
        st0 = engine.stats_snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.edit_batch(imgs, reqs)
        dt = time.perf_counter() - t0
        st1 = engine.stats_snapshot()
        return (len(imgs) / dt, st1["launch_s"] - st0["launch_s"],
                st1["sync_s"] - st0["sync_s"])

    def rate_batcher(count):
        batcher = MicroBatcher(engine, linger_ms=10, pipeline_depth=2).start()
        st0 = engine.stats_snapshot()
        if count:
            reset_launches()
        try:
            pending, dt = submit_all(engine, imgs, reqs)
        finally:
            batcher.stop()
        launches = dict(chain.LAUNCHES)
        st1 = engine.stats_snapshot()
        batches = st1["batches"] - st0["batches"]
        return (pending, len(imgs) / dt, st1["launch_s"] - st0["launch_s"],
                st1["sync_s"] - st0["sync_s"], batches, launches)

    pending, b_rate, b_launch, b_sync, batches, launches = rate_batcher(True)
    log(f"serve pipeline: {len(imgs)} requests from {SERVE_THREADS} threads "
        f"through MicroBatcher(linger 10 ms, depth 2) in {batches} "
        f"micro-batches; launches {launches}")
    if launches["chain"] != batches or batches < len(imgs) // 8 or any(
            v for k, v in launches.items() if k != "chain"):
        fail(f"the batcher's run launched {launches} over {batches} "
             f"micro-batches: want one chain kernel per micro-batch")
    errs = [p.error for p in pending if p.error is not None]
    if errs:
        fail(f"the batcher failed requests: {errs[:2]}")
    worst = same_results("batcher vs edit_batch", [p.result for p in pending],
                         want)
    log(f"  batcher results against edit_batch's: same programs, params "
        f"within 1e-4, images within {worst:.3f} levels")
    rates = {"batcher": [b_rate], "edit_batch": []}
    split = {"batcher": [(b_launch, b_sync)], "edit_batch": []}
    for _ in range(2):                  # in turns: edit_batch, batcher
        r, ls, ss = rate_edit_batch()
        rates["edit_batch"].append(r)
        split["edit_batch"].append((ls, ss))
        _, r, ls, ss, _, _ = rate_batcher(False)
        rates["batcher"].append(r)
        split["batcher"].append((ls, ss))
    log(f"  req/s over {len(imgs)} requests (48 at 512x512, 16 at 384x640; "
        f"host clock): batcher {[round(r, 2) for r in rates['batcher']]}, "
        f"edit_batch {[round(r, 2) for r in rates['edit_batch']]}; "
        f"(launch_s, sync_s) batcher "
        f"{[(round(a, 3), round(b, 3)) for a, b in split['batcher']]}, "
        f"edit_batch "
        f"{[(round(a, 3), round(b, 3)) for a, b in split['edit_batch']]}")

    # the bank executor and decode_native against the kernel engine
    sub, sub_reqs = imgs[:8] + imgs[48:56], reqs[:8] + reqs[48:56]
    bank_eng = ServingEngine(actor, vocab, device="cuda", use_pallas=False,
                             **kw)
    gap_bank = same_results("use_pallas=False vs the kernel",
                            bank_eng.edit_batch(sub, sub_reqs),
                            [want[i] for i in list(range(8))
                             + list(range(48, 56))])
    native = ServingEngine(actor, vocab, device="cuda", decode_native=True,
                           **kw)
    native_bank = ServingEngine(actor, vocab, device="cuda",
                                decode_native=True, use_pallas=False, **kw)
    nat = native.edit_batch(sub, sub_reqs)
    gap_native = same_results("decode_native: use_pallas=False vs the "
                              "kernel", native_bank.edit_batch(sub, sub_reqs),
                              nat)
    log(f"  use_pallas=False against the kernel engine (16 requests, both "
        f"buckets): same programs, images within {gap_bank:.3f} levels; "
        f"decode_native the same way: within {gap_native:.3f} levels; "
        f"decode_native programs {[r.ops for r in nat[:2]]}, the probe's "
        f"{[r.ops for r in want[:2]]}")

    engine.warmup(buckets=[(512, 512)])
    probe = engine.device_compute_probe(512)
    log(f"  device_compute_probe(512): {probe}")
    one_imgs, one_reqs = imgs[:8], reqs[:8]

    def one():
        engine.edit_batch(one_imgs, one_reqs)

    wall = statistics.median(timed(one, n=10, warmup=2))
    prof = profiled_us(one, calls=3)
    dev_ms = prof["all"] / 1e3
    log(f"  one b8 512x512 micro-batch through edit_batch: {wall:.2f} ms host "
        f"clock (median of 10), {dev_ms:.2f} ms of device work in "
        f"{prof['count']:.0f} operations (torch.profiler): the card idle "
        f"{1 - dev_ms / wall:.1%}")

    # failures: a flush whose batch raises; a launch that raises once
    def boom(pending):
        raise RuntimeError("injected failure")

    engine._process = boom
    bad = engine.submit(imgs[0], reqs[0])
    if engine.flush() != 1 or not bad.done.is_set() or bad.result is not None \
            or not isinstance(bad.error, RuntimeError):
        fail("a failed flush did not mark its request")
    del engine._process
    calls = []
    real_launch = engine.launch

    def launch_once_failing(todo):
        calls.append(len(todo))
        if len(calls) == 1:
            raise RuntimeError("injected failure")
        return real_launch(todo)

    engine.launch = launch_once_failing
    batcher = MicroBatcher(engine, linger_ms=10, pipeline_depth=2).start()
    try:
        first = engine.submit(imgs[0], reqs[0])
        first.done.wait(timeout=120)
        later, _ = submit_all(engine, imgs[:16], reqs[:16])
    finally:
        batcher.stop()
        del engine.launch
    if not isinstance(first.error, RuntimeError) or any(
            p.error is not None for p in later):
        fail(f"the batcher did not survive a failed launch: {first.error}, "
             f"{[p.error for p in later if p.error is not None][:2]}")
    same_results("batcher after a failure", [p.result for p in later],
                 want[:16])
    log("  a failed flush and a failed launch marked their requests with "
        ".error; the batcher then served 16 more requests as edit_batch")
    return {"launches": launches, "micro_batches": batches,
            "req_s_batcher": rates["batcher"],
            "req_s_edit_batch": rates["edit_batch"],
            "launch_sync_s_batcher": split["batcher"],
            "launch_sync_s_edit_batch": split["edit_batch"],
            "device_compute_probe": probe, "micro_batch_ms": wall,
            "micro_batch_device_ms": dev_ms,
            "micro_batch_idle": 1 - dev_ms / wall,
            "bank_levels": gap_bank, "native_bank_levels": gap_native}


# -- phase 22 -----------------------------------------------------------------
SERVE_RUN_DIR = os.path.join("output", "chip_smoke_serve")
SERVE_ARGV = ["--device", "cuda", "--synthetic", "--run_dir", SERVE_RUN_DIR]
HTTP_CLIENTS = 16


def http_phase():
    """`cli.serve`'s engine and server on 127.0.0.1 behind its batcher:
    16 concurrent POST /edit with 512 px PNGs, each 200 with a PNG of the
    input's shape, /healthz counting them, 404 and 400; then
    `cli.serve --bench 64 --img_size 512` and its JSON line."""
    import base64
    import contextlib
    import io
    import threading
    import urllib.error
    import urllib.request

    from PIL import Image

    from t2onet_tpu_torch.cli import serve as serve_cli

    shutil.rmtree(SERVE_RUN_DIR, ignore_errors=True)
    a = serve_cli.build_parser().parse_args(SERVE_ARGV)
    engine = serve_cli.build_engine(a)
    engine.warmup(buckets=[(512, 512)])
    server, batcher = serve_cli.make_server(engine, 0, a.linger_ms,
                                            a.pipeline_depth)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def call(path, body=None):
        req = urllib.request.Request(base + path, data=body,
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    imgs = make_images(HTTP_CLIENTS, 512, 512, seed=23)
    bodies = []
    for i, im in enumerate(imgs):
        buf = io.BytesIO()
        Image.fromarray((im.transpose(1, 2, 0) * 255).astype(np.uint8)).save(
            buf, format="PNG")
        bodies.append(json.dumps({"request": TEXTS[i % len(TEXTS)],
                                  "image_b64": base64.b64encode(
                                      buf.getvalue()).decode()}).encode())
    replies = [None] * HTTP_CLIENTS
    st0 = engine.stats_snapshot()
    reset_launches()
    try:
        def client(i):
            replies[i] = call("/edit", bodies[i])

        workers = [threading.Thread(target=client, args=(i,))
                   for i in range(HTTP_CLIENTS)]
        t0 = time.perf_counter()
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=180)
        wall = time.perf_counter() - t0
        launches = dict(chain.LAUNCHES)
        health = call("/healthz")
        codes = (call("/nope")[0], call("/edit", b"not json")[0])
    finally:
        server.shutdown()
        batcher.stop()
        server.server_close()
        thread.join(timeout=30)
    st1 = engine.stats_snapshot()
    batches = st1["batches"] - st0["batches"]
    shapes = []
    for i, rep in enumerate(replies):
        if rep is None or rep[0] != 200:
            fail(f"POST /edit {i} answered {rep}")
        png = Image.open(io.BytesIO(base64.b64decode(rep[1]["image_b64"])))
        shapes.append(png.size)
        if png.size != (512, 512) or any(op not in OP_NAMES
                                         for op in rep[1]["ops"]):
            fail(f"POST /edit {i}: a {png.size} PNG, ops {rep[1]['ops']}")
    log(f"http: {HTTP_CLIENTS} concurrent POST /edit (512 px PNGs) in "
        f"{wall:.3f} s, all 200 with 512x512 PNGs; {batches} micro-batches, "
        f"launches {launches}; /healthz {health}; /nope and a bad body "
        f"answered {codes}")
    if health[0] != 200 or health[1]["stats"]["requests"] \
            - st0["requests"] != HTTP_CLIENTS or codes != (404, 400):
        fail(f"/healthz {health} or the error codes {codes} are wrong")
    if launches["chain"] != batches or any(v for k, v in launches.items()
                                           if k != "chain"):
        fail(f"the HTTP run launched {launches} over {batches} micro-batches")
    if thread.is_alive():
        fail("the HTTP server thread did not stop")
    del engine

    out = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(out):
        engine = serve_cli.main(SERVE_ARGV + ["--bench", "64", "--img_size",
                                              "512"])
    bench_launches = dict(chain.LAUNCHES)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"cli.serve --bench 64 --img_size 512: {json.dumps(line)}")
    # the warm-up and the 64 requests, then device_compute_probe: one warm
    # call and 3 x 10 timed ones
    want = engine.stats["batches"] + 31
    log(f"  launches {bench_launches}, want chain = {want} (micro-batches "
        f"and the probe's 31 calls)")
    if bench_launches["chain"] != want or line["value"] <= 0:
        fail(f"cli.serve --bench launched {bench_launches}, want chain = "
             f"{want}")
    return {"launches": launches, "micro_batches": batches, "wall_s": wall,
            "bench": line, "bench_launches": bench_launches}


# -- phase 23 -----------------------------------------------------------------
INPAINT_RUN_DIR = os.path.join("output", "chip_smoke_inpaint")
INPAINT_CKPT = os.path.join(INPAINT_RUN_DIR, "inpaint_model")
INPAINT_ITERS = 100       # of the CLI's 2,000, cut to keep the whole run short
INPAINT_ARGV = ["--device", "cuda", "--data_dir", "data_real_h2h",
                "--act_dir", FIVEK_ACTS, "--glove_path", FIVEK_GLOVE_NPY,
                "--num_iters", str(INPAINT_ITERS),
                "--print_every", "25", "--run_dir", INPAINT_RUN_DIR]
EDGECONNECT_DIR = os.path.join("output", "chip_smoke_edgeconnect")
# one step's gradients: the card's sit ~2.2e-7 of their norm from the
# CPU's f64 ones and the CPU's f32 ones ~1.2e-4 (oneDNN rounds more), so
# the card is held to f64 between its reading and TF32's ~1e-3, and to
# the CPU's f32 just above the CPU's own rounding
INPAINT_LOSS_RTOL = 1e-5
INPAINT_GRAD_F64_RTOL = 1e-5
INPAINT_GRAD_RTOL = 5e-4
EDGECONNECT_ATOL = 1e-4


def random_edgeconnect_sd(rng, cin, cout, spectral):
    """A random EdgeConnect generator checkpoint in the published layout
    ({'iteration', 'generator'}; 64-channel stem, 8 residual blocks), with
    spectral norm as torch stores it: weight_orig, and u and v, the
    leading singular vectors of the weight flattened over its output
    channels (dim 0 of a conv, dim 1 of a ConvTranspose2d)."""
    sd = {}

    def add(name, w, transpose=False):
        w = torch.from_numpy(w)
        n_out = w.shape[1] if transpose else w.shape[0]
        if spectral:
            wm = (w.transpose(0, 1) if transpose else w).reshape(n_out, -1)
            u, _, vh = torch.linalg.svd(wm, full_matrices=False)
            sd[f"{name}.weight_orig"] = w
            sd[f"{name}.weight_u"] = u[:, 0].contiguous()
            sd[f"{name}.weight_v"] = vh[0].contiguous()
        else:
            sd[f"{name}.weight"] = w
        sd[f"{name}.bias"] = torch.from_numpy(
            rng.standard_normal(n_out).astype(np.float32) * 0.05)

    def conv(name, ci, co, k):
        add(name, rng.standard_normal((co, ci, k, k)).astype(np.float32)
            * 0.08)

    conv("encoder.1", cin, 64, 7)
    conv("encoder.4", 64, 128, 4)
    conv("encoder.7", 128, 256, 4)
    for i in range(8):
        conv(f"middle.{i}.conv_block.1", 256, 256, 3)
        conv(f"middle.{i}.conv_block.5", 256, 256, 3)
    for name, ci, co in (("decoder.0", 256, 128), ("decoder.3", 128, 64)):
        add(name, rng.standard_normal((ci, co, 4, 4)).astype(np.float32)
            * 0.08, transpose=True)
    conv("decoder.7", 64, cout, 7)
    return {"iteration": 0, "generator": sd}


def inpaint_phase():
    """`cli.train_inpaint` on data_real_h2h with the CLI's defaults
    (InpaintNet features 32, batch 16, 128 px, lr 2e-4) for 200
    iterations: finite falling loss, a checkpoint, the held-out hole L1
    below the blanked one; the train step's time; one step on the card
    against the CPU from the same weights; the full-width EdgeConnect
    generators from random state_dicts at 256², card against CPU."""
    from t2onet_tpu_torch.cli import train_inpaint
    from t2onet_tpu_torch.models import edgeconnect, inpaint

    shutil.rmtree(INPAINT_RUN_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    net, held = train_inpaint.main(INPAINT_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [v for _, _, v in logged_losses(
        os.path.join(INPAINT_RUN_DIR, "inpaint.jsonl"), ("inpaint_loss",))]
    log(f"train_inpaint: {INPAINT_ITERS} iterations on data_real_h2h in "
        f"{wall:.2f} s (host clock, data, checkpoint and the held-out "
        f"evaluation at 600x600 included); logged losses "
        f"{[round(v, 4) for v in losses]}; held-out {held}; launches "
        f"{dict(chain.LAUNCHES)}")
    if not losses or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        fail(f"the filler's loss is not finite and falling: {losses}")
    if not held["hole_l1"] < held["hole_l1_blank"]:
        fail(f"the filler does not beat the blanked hole: {held}")
    if not os.path.exists(os.path.join(INPAINT_CKPT, "params.pt")):
        fail("train_inpaint wrote no checkpoint")
    if any(chain.LAUNCHES.values()):
        fail("train_inpaint launched a chain or step kernel")

    # the train step's time, and one step card against CPU
    a = train_inpaint.parse_args(INPAINT_ARGV)
    ds = common.build_dataset_and_vocab(a, "train")[0]
    img_np = next(ds.batches(a.batch_size, 1, shuffle=False))["img_x"]
    mask_np = inpaint.random_freeform_masks(np.random.default_rng(5),
                                            *img_np.shape[:1],
                                            *img_np.shape[2:])
    img, mask = to_card(np.asarray(img_np, np.float32), mask_np)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(23)
        fresh = inpaint.InpaintNet(features=a.features)
    nets = {"card": copy.deepcopy(fresh).cuda(), "cpu": copy.deepcopy(fresh)}
    steps = {k: inpaint.make_train_step(n, torch.optim.Adam(
        n.parameters(), lr=a.learning_rate)) for k, n in nets.items()}
    step_ms = statistics.median(timed(lambda: steps["card"](img, mask)))
    prof = profiled_us(lambda: steps["card"](img, mask))
    # the step's gradients on the card, on the CPU and on the CPU in f64
    nets = {"card": copy.deepcopy(fresh).cuda(), "cpu": copy.deepcopy(fresh),
            "f64": copy.deepcopy(fresh).double()}
    loss, grads = {}, {}
    for k, n in nets.items():
        x, m = ((img, mask) if k == "card" else
                (img.cpu(), mask.cpu()) if k == "cpu" else
                (img.cpu().double(), mask.cpu().double()))
        n.train()
        out = inpaint.inpaint_loss(n(x, m), x, m)
        out.backward()
        loss[k] = float(out.detach())
        grads[k] = [(name, p.grad.double().cpu())
                    for name, p in n.named_parameters()]

    def gap(a, b):
        """||a - b|| / ||b|| over all gradients, and the worst tensor's
        gap over 5e-2 of its own norm plus 1e-6 of the whole (phase 9's)"""
        total = math.sqrt(sum(float((gb * gb).sum()) for _, gb in grads[b]))
        rel = math.sqrt(sum(float(((ga - gb) ** 2).sum()) for (_, ga), (
            _, gb) in zip(grads[a], grads[b]))) / total
        per = max(float((ga - gb).norm()) / (0.05 * float(gb.norm())
                                             + 1e-6 * total)
                  for (_, ga), (_, gb) in zip(grads[a], grads[b]))
        return rel, per

    rel = gap("card", "cpu")[0]
    card64, per = gap("card", "f64")
    cpu64 = gap("cpu", "f64")[0]
    log(f"  InpaintNet train step (b{a.batch_size} x {a.img_size}², features "
        f"{a.features}, Adam): {step_ms:.2f} ms host clock (median of 6), "
        f"{prof['all'] / 1e3:.2f} ms of device work in {prof['count']:.0f} "
        f"operations; card vs CPU from the same weights: loss "
        f"{loss['card']:.8f} vs {loss['cpu']:.8f} (f64 {loss['f64']:.8f}); "
        f"against the CPU's f64 gradients: card {card64:.2e} of their norm "
        f"(worst tensor {per:.3f} of its bound), CPU f32 {cpu64:.2e}; card "
        f"against CPU f32 {rel:.2e} (bounds: loss {INPAINT_LOSS_RTOL} "
        f"relative, card vs f64 {INPAINT_GRAD_F64_RTOL}, card vs CPU f32 "
        f"{INPAINT_GRAD_RTOL})")
    if abs(loss["card"] - loss["cpu"]) > INPAINT_LOSS_RTOL * abs(loss["cpu"]) \
            or not card64 <= INPAINT_GRAD_F64_RTOL or not per <= 1.0 \
            or not rel <= INPAINT_GRAD_RTOL:
        fail("the card's InpaintNet step disagrees with the CPU's")

    # EdgeConnect's generators at full width, 256 x 256, card vs CPU
    os.makedirs(EDGECONNECT_DIR, exist_ok=True)
    rng = np.random.default_rng(23)
    gaps, times = {}, {}
    for kind, fname, cin, cout in (
            ("edge", "EdgeModel_gen.pth", 3, 1),
            ("inpaint", "InpaintingModel_gen.pth", 4, 3)):
        sd = random_edgeconnect_sd(rng, cin, cout, spectral=kind == "edge")
        torch.save(sd, os.path.join(EDGECONNECT_DIR, fname))
        x = torch.from_numpy(rng.uniform(0, 1, (1, cin, 256, 256))
                             .astype(np.float32))
        card = edgeconnect.load_generator(sd, kind, "cuda")
        cpu = edgeconnect.load_generator(sd, kind, "cpu")
        with torch.no_grad():
            got = card(x.cuda()).cpu()
            want = cpu(x)

            def fwd(card=card, x=x.cuda()):
                with torch.no_grad():
                    card(x)

            times[kind] = statistics.median(timed(fwd, n=5))
        gaps[kind] = float((got - want).abs().max())
    log(f"  EdgeConnect generators (64-channel stem, 8 residual blocks, "
        f"b1 x 256²): card vs CPU max abs gap {gaps} (bound "
        f"{EDGECONNECT_ATOL}); forward {times} ms (host clock, median of 5)")
    if not all(g <= EDGECONNECT_ATOL for g in gaps.values()):
        fail(f"the card's EdgeConnect generators disagree with the CPU's: "
             f"{gaps}")
    return {"launches": dict(chain.LAUNCHES), "wall_s": wall,
            "losses": losses, "held_out": held, "step_ms": step_ms,
            "step_device_ms": prof["all"] / 1e3,
            "card_vs_cpu": {"loss_card": loss["card"], "loss_cpu": loss["cpu"],
                            "grad_rel": rel, "worst_tensor": per,
                            "card_vs_f64": card64, "cpu_vs_f64": cpu64},
            "edgeconnect_gap": gaps, "edgeconnect_ms": times}


# -- phase 24 -----------------------------------------------------------------
DEMO_DIR = os.path.join("output", "chip_smoke_demo")
DEMO_ARGV = ["--data_dir", "data_real_h2h", "--glove_path", FIVEK_GLOVE_NPY,
             "--run_dir", os.path.join("output", "chip_smoke_eval"),
             "--img", FIVEK_TEST_IMAGE, "--request",
             "increase the brightness and the contrast"]
PROGRAM = [["brightness", [0.2]], ["inpaint", []], ["sharpness", [0.3]]]
PROGRAM_SIZE = 256                 # --short_size of the program runs
# the first shapeAlign train pairs that carry an inpaint mask, planned at
# phase 15's size (the filler's training size); the CPU replans two
PLAN_INPAINT_PAIRS = (9, 10, 12, 13)
PLAN_INPAINT_CPU_PAIRS = (9, 12)
PLAN_INPAINT_SIZE = 128
FILL_ATOL = 1e-4                   # a filler call's output, card vs CPU


def jpeg_levels(a, b):
    import cv2

    x, y = cv2.imread(a), cv2.imread(b)
    if x is None or y is None or x.shape != y.shape:
        fail(f"{a} or {b} is missing or of another shape")
    return int(np.abs(x.astype(np.int32) - y.astype(np.int32)).max())


def demo_outputs(n_steps):
    return ["input.jpg", "output.jpg"] + [f"step{i}.jpg"
                                          for i in range(n_steps)]


def demo_levels(written, d, n_steps):
    """(largest gap between the card's and the CPU's 8-bit images as the
    demo hands them to the JPEG encoder, largest gap between the decoded
    JPEGs) over the demo's files in d/cuda and d/cpu. JPEG's quantization
    turns a one-level difference into several levels of its 8 x 8
    block, so the decoded gap is printed, not bounded."""
    raw = dec = 0
    for f in demo_outputs(n_steps):
        x, y = (written[os.path.join(d, dev, f)] for dev in ("cuda", "cpu"))
        raw = max(raw, int(np.abs(x.astype(np.int32) - y).max()))
        dec = max(dec, jpeg_levels(os.path.join(d, "cuda", f),
                                   os.path.join(d, "cpu", f)))
    return raw, dec


def demo_plan_phase():
    """`cli.demo` decode mode on a real FiveK test image from phase 12's
    checkpoint (B1 once per rollout step at b1 x 600², card against CPU);
    `--program` with a mask and each filler (phase 23's InpaintNet and
    EdgeConnect dir), card against CPU within one level of the 8-bit
    images the demo writes; `cli.plan_gier --inpaint_ckpt` on the 4 first
    shapeAlign train pairs with an inpaint mask at 128 px, each filler
    call of the card's search held to the CPU's filler on its input, and
    2 pairs' plans held to the CPU's as phase 15 holds plans."""
    from PIL import Image

    from t2onet_tpu_torch.cli import demo, plan_gier
    from t2onet_tpu_torch.models import edgeconnect

    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    out = {}
    runs = {}
    written = {}
    save = demo.save_img

    def keep(img, path):
        """save_img, keeping the 8-bit image it encodes"""
        written[path] = (np.clip(np.asarray(img), 0, 1) * 255).astype(
            np.uint8)
        save(img, path)

    demo.save_img = keep
    edge_calls = []
    edge_maps = edgeconnect.edge_maps

    def counted_edge_maps(*args, **kw):
        edge_calls.append(args[0].device.type)
        return edge_maps(*args, **kw)

    edgeconnect.edge_maps = counted_edge_maps
    try:
        for dev in ("cuda", "cpu"):
            reset_launches()
            t0 = time.perf_counter()
            runs[dev] = demo.main(DEMO_ARGV + ["--device", dev, "--out_dir",
                                               os.path.join(DEMO_DIR, dev)])
            if dev == "cuda":
                torch.cuda.synchronize()
                out["demo_s"] = time.perf_counter() - t0
                out["launches"] = dict(chain.LAUNCHES)
        steps = len(os.listdir(os.path.join(DEMO_DIR, "cuda"))) - 3
        want = ModelConfig().decoder_max_len
        log(f"demo: {json.dumps(runs['cuda'])} in {out['demo_s']:.2f} s "
            f"(host clock, set-up included); launches {out['launches']}, "
            f"want chain = {want} (one per rollout step); CPU "
            f"{json.dumps(runs['cpu'])}")
        if out["launches"]["chain"] != want or any(
                v for k, v in out["launches"].items() if k != "chain"):
            fail(f"the demo launched {out['launches']}: want {want} chain")
        if [s["op"] for s in runs["cuda"]] != [s["op"] for s in runs["cpu"]] \
                or any(np.abs(np.array(g["params"]) - np.array(c["params"]))
                       .max(initial=0) > 1e-4 + 1e-6
                       for g, c in zip(runs["cuda"], runs["cpu"])):
            fail("the card's demo program differs from the CPU's")
        raw, dec = demo_levels(written, DEMO_DIR, steps)
        out["demo_levels"] = raw
        log(f"  card vs CPU: the same program, 8-bit images within {raw} "
            f"levels (decoded JPEGs {dec})")
        if raw > 1:
            fail(f"the demo's card and CPU images are {raw} levels apart")

        # --program with a mask and each filler, card against CPU
        mask = np.zeros((PROGRAM_SIZE, PROGRAM_SIZE), np.uint8)
        mask[64:160, 80:200] = 255
        mask_path = os.path.join(DEMO_DIR, "mask.png")
        Image.fromarray(mask).save(mask_path)
        prog = DEMO_ARGV + ["--short_size", str(PROGRAM_SIZE), "--program",
                            json.dumps(PROGRAM), "--mask", mask_path]
        out["program_levels"] = {}
        out["hysteresis_launches"] = {}
        for name, flag in (("inpaint_ckpt", ["--inpaint_ckpt",
                                             INPAINT_CKPT]),
                           ("edgeconnect", ["--edgeconnect_dir",
                                            EDGECONNECT_DIR])):
            for dev in ("cuda", "cpu"):
                reset_launches()
                edge_calls.clear()
                demo.main(prog + flag + ["--device", dev, "--out_dir",
                                         os.path.join(DEMO_DIR, name, dev)])
                if any(chain.LAUNCHES.values()):
                    fail(f"--program launched {dict(chain.LAUNCHES)}")
                # EdgeConnect's edges: one hysteresis launch an edge map
                # call on the card (the bank runs the filler every step),
                # none on the CPU or with the gated filler
                got = hysteresis.LAUNCHES["hysteresis"]
                want = len(edge_calls) if dev == "cuda" else 0
                out["hysteresis_launches"][f"{name}_{dev}"] = got
                log(f"  demo --program, {name} filler on {dev}: "
                    f"{len(edge_calls)} edge map calls, {got} hysteresis "
                    f"launches (want {want})")
                if got != want or (name == "edgeconnect") != bool(
                        edge_calls):
                    fail(f"demo --program with the {name} filler on {dev}: "
                         f"{got} hysteresis launches for {len(edge_calls)} "
                         f"edge map calls")
            d = os.path.join(DEMO_DIR, name)
            raw, dec = demo_levels(written, d, len(PROGRAM))
            hole = [written[os.path.join(d, "cuda", f"step{i}.jpg")]
                    [:, 64:160, 80:200].astype(np.float32) for i in (0, 1)]
            changed = float(np.abs(hole[1] - hole[0]).max())
            out["program_levels"][name] = raw
            log(f"  demo --program {json.dumps(PROGRAM)} --mask, {name} "
                f"filler at {PROGRAM_SIZE}²: card vs CPU 8-bit images within "
                f"{raw} levels (decoded JPEGs {dec}); the fill moved the hole "
                f"by up to {changed:.0f} levels")
            if raw > 1 or changed < 1.0:
                fail(f"demo --program with the {name} filler: {raw} levels "
                     f"card vs CPU, hole moved {changed}")
    finally:
        demo.save_img = save
        edgeconnect.edge_maps = edge_maps

    # the GIER planner with the trained filler: every filler call of the
    # card's search again on the CPU from the same input, and two pairs
    # planned on the CPU, card against CPU
    from t2onet_tpu_torch.models import inpaint

    base = ["--data_dir", "data_real_gier", "--data_mode", "shapeAlign",
            "--img_size", str(PLAN_INPAINT_SIZE), "--manual_seed", "10",
            "--inpaint_ckpt", INPAINT_CKPT, "--limit", "1"]
    dirs = {dev: os.path.join(DEMO_DIR, f"plan_{dev}")
            for dev in ("cuda", "cpu")}
    calls = []                         # (mask, filler input, output)
    factory = plan_gier.filler_factory

    def recording(a, device):
        make = factory(a, device)

        def make_fn(mask):
            fn = make(mask)

            def fn_kept(img):
                res = fn(img)
                calls.append((mask, img.cpu().numpy(), res.cpu().numpy()))
                return res
            return fn_kept
        return make_fn

    out["plan_s"] = {}
    for dev, pairs in (("cuda", PLAN_INPAINT_PAIRS),
                       ("cpu", PLAN_INPAINT_CPU_PAIRS)):
        reset_launches()
        plan_gier.filler_factory = recording if dev == "cuda" else factory
        try:
            t0 = time.perf_counter()
            n = sum(plan_gier.main(base + ["--device", dev, "--start", str(i),
                                           "--out_dir", dirs[dev]])
                    for i in pairs)
            out["plan_s"][dev] = time.perf_counter() - t0
        finally:
            plan_gier.filler_factory = factory
        if dev == "cuda":
            out["plan_launches"] = dict(chain.LAUNCHES)
        if n != len(pairs):
            fail(f"plan_gier --inpaint_ckpt planned {n} pairs on {dev}, "
                 f"not {len(pairs)}")
    net = inpaint.load_inpaint(INPAINT_CKPT, "cpu")
    fill_max = fill_mean = 0.0
    with torch.no_grad():
        for mask, x, got in calls:
            want = inpaint.make_inpaint_fn(net, mask[None])(
                torch.from_numpy(x)).numpy()
            gap = np.abs(got - want)
            fill_max = max(fill_max, float(gap.max()))
            fill_mean = max(fill_mean, float(gap.mean(axis=(1, 2, 3)).max()))
    in_top = in_beams = 0
    for d in os.listdir(dirs["cuda"]):
        with open(os.path.join(dirs["cuda"], d, "acts.json")) as f:
            beams = json.load(f)["operation sequence"]
        in_top += sum(s[0] == "inpaint" for s in beams[0])
        in_beams += sum(s[0] == "inpaint" for b in beams for s in b)
    log(f"plan_gier --inpaint_ckpt on {len(PLAN_INPAINT_PAIRS)} GIER pairs "
        f"with an inpaint mask at {PLAN_INPAINT_SIZE} px: card "
        f"{out['plan_s']['cuda']:.2f} s, CPU {out['plan_s']['cpu']:.2f} s "
        f"for {len(PLAN_INPAINT_CPU_PAIRS)} of them (host clock); launches "
        f"{out['plan_launches']}; inpaint steps in the card's top beams "
        f"{in_top}, in all its beams {in_beams}; {len(calls)} filler calls "
        f"({sum(len(c[1]) for c in calls)} images) again on the CPU from the "
        f"same inputs: max abs gap {fill_max:.3e} (bound {FILL_ATOL}), the "
        f"worst image's mean abs gap, which bounds its distance's gap, "
        f"{fill_mean:.3e}")
    if any(out["plan_launches"].values()):
        fail(f"the planner launched {out['plan_launches']}")
    if not calls or not fill_max <= FILL_ATOL:
        fail(f"the card's filler in the planner: {len(calls)} calls, "
             f"{fill_max} from the CPU's")
    out["plan"] = compare_plans("plan_gier --inpaint_ckpt", [
        (d, os.path.join(dirs["cuda"], d), os.path.join(dirs["cpu"], d),
         "acts.json") for d in sorted(os.listdir(dirs["cpu"]))],
        against="the CPU's plans")
    out.update(plan_inpaint_steps=in_top, plan_inpaint_in_beams=in_beams,
               filler_calls=len(calls), filler_max_abs=fill_max,
               filler_mean_abs=fill_mean)
    return out


# -- phases 25-28: the GAN half ---------------------------------------------
GAN_RUN_DIR = os.path.join("output", "chip_smoke_gan")
GAN_ARGV = ["--device", "cuda", "--data_dir", "data_real_h2h",
            "--act_dir", FIVEK_ACTS, "--glove_path", FIVEK_GLOVE_NPY,
            "--batch_size", "64", "--img_size", "128", "--num_iters", "8",
            "--print_every", "2", "--checkpoint_every", "8",
            "--fused_exec", "1", "--run_dir", GAN_RUN_DIR]
GAN_VAL_BATCHES = 4        # train_gan validates on 4 batches, as JAX's
GAN_F64_RTOL = 1e-5        # the GAN half, card f32 against CPU f64
# each D tensor against its own norm: cuDNN's f32 algorithms for the
# half-resolution scale (FFT among them) put 1.8e-5 on a small tensor
GAN_F64_TENSOR_RTOL = 1e-4
# G's gradient to the image crosses feature matching's L1 kinks, where
# f32 and f64 take other signs: 3.3e-4 apart on the CPU's own f32
GAN_IMG_GRAD_RTOL = 1e-3


def gan_half(bundle, batch, hid, device, dtype):
    """The GAN half alone on a fixed fake image, in `dtype` on `device`:
    (G loss, D loss, G's gradient to the fake image, {name: D and
    condition encoder gradient}), the gradients as f64 CPU tensors."""
    from t2onet_tpu_torch.models.gan import Seq2SeqGANLosses

    bnd = copy.deepcopy(bundle).to(device, dtype).train()
    src, fake, gt = (torch.from_numpy(np.asarray(batch[k])).to(device, dtype)
                     for k in ("img_x", "fake", "gt_img"))
    hid = hid.to(device, dtype)
    losses = Seq2SeqGANLosses()
    fake.requires_grad_(True)
    with torch.no_grad():
        cond = bnd.cond_encoder(hid)
    bnd.requires_grad_(False)
    ld = losses(bnd.netD, src, fake, gt, cond, parts="g")
    g_loss = ld["G_GAN"] + ld["G_GAN_Feat"]
    g_loss.backward()
    bnd.requires_grad_(True)
    ld2 = losses(bnd.netD, src, fake.detach(), gt, bnd.cond_encoder(hid),
                 parts="d")
    d_loss = 0.5 * (ld2["D_fake"] + ld2["D_real"])
    d_loss.backward()
    return (g_loss.item(), d_loss.item(), fake.grad.double().cpu(),
            {n: p.grad.double().cpu() for n, p in bnd.named_parameters()})


def gan_card_vs_cpu():
    """One GAN iteration of a full-width actor and discriminator on one
    real b8 FiveKAct batch at 64 px, the same weights and Gumbel noise,
    the card (B1, B3) against the CPU (their plain versions): the six
    losses within 1e-5, the actor's, D's and the condition encoder's
    gradients within phase 9's bounds (they follow the sampled rollout).
    Then the GAN half alone on a fixed fake: the card's f32 G and D
    losses and the D and condition-encoder gradients within GAN_F64_RTOL
    of the CPU's f64 (of their whole norm; each tensor within
    GAN_F64_TENSOR_RTOL of its own plus 1e-6 of the whole; TF32, ~1e-3,
    fails both), G's gradient to the image within GAN_IMG_GRAD_RTOL."""
    from t2onet_tpu_torch.cli import train_gan
    from t2onet_tpu_torch.data.fivek import FiveKAct
    from t2onet_tpu_torch.data.text import load_embedding
    from t2onet_tpu_torch.models.common import init_torch_defaults
    from t2onet_tpu_torch.models.gan import DiscBundle, Seq2SeqGANLosses

    glove = load_embedding(FIVEK_GLOVE_NPY)
    ds = FiveKAct(os.path.join("data_real_h2h", "FiveK", "images"),
                  os.path.join("data_real_h2h", "FiveK", "annotations"),
                  FIVEK_ACTS, "train", 1, 64)
    nb = next(ds.batches(8, 1, shuffle=True, seed=2))
    cfg = ModelConfig(fix_input_embedding=True)
    actor = Actor(cfg, OperatorConfig(), glove.shape[0] + 4,
                  generator=torch.Generator().manual_seed(3), word2vec=glove)
    knots_near_one(actor)
    bundle = DiscBundle(cfg.n_layers * 2 * cfg.hidden_size)
    init_torch_defaults(bundle, torch.Generator().manual_seed(17))
    g = torch.Generator().manual_seed(11)
    draws = [bank.gumbel_noise((8, cfg.op_vocab_size), g)
             for _ in range(cfg.decoder_max_len)]
    # the GAN half's fixed fake: another item's input (a planner step
    # image sits so near the ground truth that feature matching's L1
    # kinks decide G's image gradient)
    batch = {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1],
             "fake": nb["img_x"][::-1].copy()}
    runs = {}
    for name, dev in (("card", "cuda"), ("cpu", "cpu")):
        st = loop.TrainState(copy.deepcopy(actor).to(dev))
        gs = train_gan.GANState(copy.deepcopy(bundle).to(dev), st.params)
        it = iter(draws)
        m = train_gan.gan_step(
            st, gs, device_put_batch({k: batch[k] for k in
                                      ("x", "img_x", "gt_img")}, dev),
            Seq2SeqGANLosses(), fused_exec=True,
            noise_fn=lambda shape, it=it, dev=dev: next(it).to(dev))
        runs[name] = (st, gs, {k: float(v) for k, v in m.items()})
    (cs, cg, cm), (ps, pg, pm) = runs["card"], runs["cpu"]
    loss_gap = max(abs(cm[k] - pm[k]) / (abs(pm[k]) + 1e-7) for k in pm)
    rel, per, stats = grad_gap(cs, ps)
    d_rel, d_per = module_grad_gap(cg.bundle, pg.bundle)
    log(f"card vs CPU GAN iteration (b8 real FiveK items, 64 px, full "
        f"width, same noise): losses card {cm}, CPU {pm}, largest relative "
        f"gap {loss_gap:.2e}; actor gradients ||card - cpu|| / ||cpu|| "
        f"{rel:.2e}, worst {[(n, round(r, 4)) for r, n in per[:2]]}, BN "
        f"stats {stats:.2e}; D and condition encoder {d_rel:.2e}, worst "
        f"{[(n, round(r, 4)) for r, n in d_per[:2]]}")
    if not (loss_gap <= 1e-5 and rel <= 1e-2 and per[0][0] <= 1.0
            and stats <= 1e-4 and d_rel <= 1e-2 and d_per[0][0] <= 1.0):
        fail("the card's GAN iteration disagrees with the CPU's")
    with torch.no_grad():
        hid = actor.lang_encoder(torch.from_numpy(
            np.asarray(nb["x"]).astype(np.int64)))[1][0]
    card = gan_half(bundle, batch, hid, "cuda", torch.float32)
    ref = gan_half(bundle, batch, hid, "cpu", torch.float64)
    loss64 = max(abs(card[i] - ref[i]) / abs(ref[i]) for i in (0, 1))
    img64 = float((card[2] - ref[2]).norm() / ref[2].norm())
    total = math.sqrt(sum(float((v * v).sum()) for v in ref[3].values()))
    d64 = math.sqrt(sum(float(((card[3][n] - v) ** 2).sum())
                        for n, v in ref[3].items())) / total
    per64 = sorted(((float((card[3][n] - v).norm())
                     / (GAN_F64_TENSOR_RTOL * float(v.norm())
                        + 1e-6 * total), n)
                    for n, v in ref[3].items()), reverse=True)
    log(f"  the GAN half on a fixed fake (another item's input), "
        f"card f32 against CPU f64: G loss {card[0]:.7f} vs {ref[0]:.7f}, "
        f"D loss {card[1]:.7f} vs {ref[1]:.7f} (relative gap {loss64:.2e}); "
        f"G's gradient to the image {img64:.2e} (bound {GAN_IMG_GRAD_RTOL}); "
        f"D and condition encoder "
        f"{d64:.2e}, worst tensors' error / bound "
        f"{[(n, round(r, 4)) for r, n in per64[:3]]} (bounds "
        f"{GAN_F64_RTOL} of the whole; {GAN_F64_TENSOR_RTOL} of each norm "
        f"plus 1e-6 of the whole)")
    if not (loss64 <= GAN_F64_RTOL and img64 <= GAN_IMG_GRAD_RTOL
            and d64 <= GAN_F64_RTOL and per64[0][0] <= 1.0):
        fail(f"the card's GAN half is not within {GAN_F64_RTOL} of the "
             f"CPU's f64")
    return {"losses_card": cm, "losses_cpu": pm, "loss_rel_gap": loss_gap,
            "actor_grad_rel": rel, "actor_worst": per[0][0],
            "bn_stats": stats, "disc_grad_rel": d_rel,
            "disc_worst": d_per[0][0], "f64_loss_rel": loss64,
            "f64_fake_grad_rel": img64, "f64_disc_grad_rel": d64,
            "f64_disc_worst": per64[0][0]}


def gan_phase():
    """`cli.train_gan` on the repo's real FiveK train pairs and their
    committed actions at ModelConfig() width, b64, 128 px, 8 iterations (4
    GAN), a checkpoint with its disc/ and gan_opt/ twins: B1 and B3
    launched as the GAN iterations and the validation count them; a GAN
    iteration's host clock and device time; card against CPU."""
    from t2onet_tpu_torch.cli import train_gan
    from t2onet_tpu_torch.models.gan import Seq2SeqGANLosses

    shutil.rmtree(GAN_RUN_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    state, gan = train_gan.main(GAN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    steps = state.actor.cfg.decoder_max_len
    want = 4 * steps
    log(f"train_gan: 8 iterations (4 GAN) in {wall:.2f} s (host clock, "
        f"JPEG decode, validation and checkpoints included); launches "
        f"{launches}, want step_bwd = {want}, chain = {want} + "
        f"{GAN_VAL_BATCHES} x {steps} (validation)")
    if state.step != 8:
        fail(f"the GAN trainer stopped at step {state.step}, not 8")
    if not (launches["step_bwd"] == want
            and launches["chain"] == want + GAN_VAL_BATCHES * steps
            and launches["chain_masked"] == launches["step_bwd_masked"] == 0):
        fail(f"train_gan launches {launches}")
    losses = logged_losses(os.path.join(GAN_RUN_DIR, "metrics.jsonl"),
                           keys=("op_loss", "param_loss", "G_loss", "D_loss",
                                 "val_L1"))
    log(f"  logged {losses}")
    keys = {k for _, k, _ in losses}
    if not {"G_loss", "D_loss", "val_L1"} <= keys or \
            not all(math.isfinite(v) for _, _, v in losses):
        fail(f"non-finite or missing GAN losses: {losses}")
    ckpt_dir = os.path.join(GAN_RUN_DIR, "seq2seqGAN_model")
    for sub in ("", "disc", "gan_opt"):
        if not os.path.exists(os.path.join(ckpt_dir, sub,
                                           "checkpoint_iter00000008.pt")):
            fail(f"train_gan wrote no checkpoint in {ckpt_dir}/{sub}")
    # a GAN iteration on a real batch already on the card
    a = train_gan.train_parser().parse_args(GAN_ARGV)
    ds = common.build_dataset_and_vocab(a, "train", wire_u8=True)[0]
    nb = next(ds.batches(64, 1, shuffle=True, seed=11))
    batch = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                              "gt_img": nb["img_y"][:, -1]}, "cuda")
    losses_fn = Seq2SeqGANLosses(n_layers=a.n_layers_D, num_D=a.num_D)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def iteration():
        return train_gan.gan_step(state, gan, batch, losses_fn,
                                  generator=gen, fused_exec=True)

    reset_launches()
    host = timed(iteration)
    per_it = {k: v / 8 for k, v in chain.LAUNCHES.items() if v}
    prof = [profiled_us(iteration, calls=1) for _ in range(3)]
    dev_ms = statistics.median(p["all"] for p in prof) / 1e3
    dev_ops = statistics.median(p["count"] for p in prof)
    top = sorted(((k, v) for k, v in prof[0].items()
                  if k not in ("all", "count")),
                 key=lambda kv: -kv[1])
    host_ms = statistics.median(host)
    log(f"  a GAN iteration, b64 128 px, ModelConfig(), ndf 64 x 2 scales, "
        f"TF32 off: host clock {host_ms:.2f} ms (median of 6 after 2 "
        f"warm-ups, synchronised), device {dev_ms:.2f} ms in "
        f"{dev_ops:.0f} operations (torch.profiler, median of 3 after a "
        f"warm-up): the card idle {1 - dev_ms / host_ms:.1%}; launches per "
        f"iteration {per_it}; largest µs "
        f"{[(k, round(v, 1)) for k, v in top[:4]]}")
    if per_it != {"chain": steps, "step_bwd": steps}:
        fail(f"a GAN iteration launched {per_it}, not {steps} of B1 and B3")
    cvc = gan_card_vs_cpu()
    return {"launches": launches, "wall_s": wall, "iter_host_ms": host_ms,
            "iter_host_ms_all": host, "iter_device_ms": dev_ms,
            "iter_device_ops": dev_ops, "launches_per_iter": per_it,
            "card_vs_cpu": cvc}


GAN_PLAN_PAIRS = 8
GAN_PLAN_CPU_PAIRS = 2
# one beam, one restart, 10 Adam steps: the CPU's replan of a pair (the
# discriminator at 128 px, ~0.25 s a fit step on 8 cores) stays ~15 s
GAN_PLAN_ARGV = ["--data_dir", "data_real_h2h", "--glove_path",
                 FIVEK_GLOVE_NPY, "--img_size", "128", "--manual_seed", "10",
                 "--dist_type", "seq2seqGAN-disc", "--disc_run_dir",
                 GAN_RUN_DIR, "--beam_size", "1", "--n_starts", "1",
                 "--n_iters", "10"]


def gan_plan_phase():
    """`cli.plan_fivek --dist_type seq2seqGAN-disc --disc_run_dir` on the
    gan phase's run (its best checkpoint and disc/ twin, eval mode) over
    the first FiveK train pairs at 128 px on the card, no kernel
    launched; the first 2 replanned on the CPU, held as phase 14 holds
    plans."""
    from t2onet_tpu_torch.cli import plan_fivek

    if not os.path.isdir(os.path.join(GAN_RUN_DIR, "seq2seqGAN_model")):
        fail("gan_plan reads the gan phase's run: run gan first")
    out = os.path.join("output", "chip_smoke_gan_plan")
    cpu_out = out + "_cpu"
    for d in (out, cpu_out):
        shutil.rmtree(d, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    n = plan_fivek.main(["--device", "cuda", "--limit", str(GAN_PLAN_PAIRS),
                         "--out_dir", out] + GAN_PLAN_ARGV)
    wall = time.perf_counter() - t0
    launches = dict(chain.LAUNCHES)
    t1 = time.perf_counter()
    plan_fivek.main(["--device", "cpu", "--limit", str(GAN_PLAN_CPU_PAIRS),
                     "--out_dir", cpu_out] + GAN_PLAN_ARGV)
    cpu_s = time.perf_counter() - t1
    log(f"plan_fivek --dist_type seq2seqGAN-disc: {n} pairs in {wall:.2f} s "
        f"on the card ({n / wall:.3f} pairs/s; beam 1, 1 start, 10 Adam "
        f"steps, 128 px), launches {launches}; {GAN_PLAN_CPU_PAIRS} pairs "
        f"on the CPU in {cpu_s:.2f} s")
    if n != GAN_PLAN_PAIRS or any(launches.values()):
        fail(f"the disc planner planned {n} pairs with launches {launches}: "
             f"want {GAN_PLAN_PAIRS} and none")
    res = compare_plans("gan_plan", [
        (f"train{i}", os.path.join(out, f"train{i}"),
         os.path.join(cpu_out, f"train{i}"), f"{i:05d}.json")
        for i in range(GAN_PLAN_CPU_PAIRS)], against="the CPU's plans")
    plans = {}
    for i in range(GAN_PLAN_PAIRS):
        with open(os.path.join(out, f"train{i}", f"{i:05d}.json")) as f:
            plans[f"train{i}"] = [(s[0], round(s[2], 6)) for s in
                                  json.load(f)["operation sequence"][0]]
    log(f"  the card's top beams (op, disc distance): {plans}")
    return {"pairs": n, "wall_s": wall, "pairs_per_s": n / wall,
            "cpu_s": cpu_s, "launches": launches, "plans": plans, **res}


FID_DIR = os.path.join("output", "chip_smoke_fid")
FID_PTH = os.path.join(FID_DIR, "inception_random.pth")
FID_CPU_IMAGES = 4
FID_FEAT_RTOL = 1e-4       # each image's 2048 features, of their norm


def fid_phase():
    """`cli.test_fivek --fid_inception_ckpt` (a random InceptionV3 written
    by `make_random_inception_pth`) on phase 12's 50 FiveK test pairs
    from phase 12's checkpoint, no variance probe: B1 once per rollout
    step and no other kernel, finite in_FID and out_FID, the features'
    share of a pair; the card's features of 4 test images against the
    CPU's."""
    from t2onet_tpu_torch.cli import test_fivek
    from t2onet_tpu_torch.evals.inception import (load_fid_inception,
                                                  make_random_inception_pth)

    os.makedirs(FID_DIR, exist_ok=True)
    make_random_inception_pth(FID_PTH, seed=0)
    a = write_eval_checkpoint(test_fivek, FIVEK_EVAL_ARGV)
    argv = FIVEK_EVAL_ARGV + ["--visualize", "0", "--skip_variance",
                              "--fid_inception_ckpt", FID_PTH]
    records = []
    native = test_fivek.test_native_res

    def keep_records(*args, **kw):
        return native(*args, records=records, **kw)

    reset_launches()
    test_fivek.test_native_res = keep_records
    try:
        t0 = time.perf_counter()
        res = test_fivek.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        test_fivek.test_native_res = native
    launches = dict(chain.LAUNCHES)
    n = len(records)
    want = n * a.decoder_max_len
    feat = [r["features_s"] * 1e3 for r in records]
    pair = [sum(r[k] for k in STAGES) * 1e3 for r in records]
    share = sum(feat) / sum(pair)
    log(f"fid: test_fivek on {n} pairs with a random InceptionV3 in "
        f"{wall:.2f} s (host clock; the two Frechet distances, 2048-d "
        f"sqrtm on the host, included): in_FID {res.get('in_FID')}, out_FID "
        f"{res.get('out_FID')}; launches {launches}, want chain = {want}; "
        f"features (3 images a pair, resized to 299) median "
        f"{statistics.median(feat):.2f} ms of a pair's "
        f"{statistics.median(pair):.2f} ms, {share:.1%} of the native loop")
    if n != 50 or launches["chain"] != want or any(
            v for k, v in launches.items() if k != "chain"):
        fail(f"fid eval: {n} pairs, launches {launches}")
    if not all(math.isfinite(res.get(k, float("nan")))
               for k in ("in_FID", "out_FID", "in_L1", "out_L1")):
        fail(f"fid eval metrics not finite or missing: {res}")
    ds = common.build_dataset_and_vocab(a, "test")[0]
    imgs = [ds[i][0][None] for i in range(FID_CPU_IMAGES)]
    card = load_fid_inception(FID_PTH, "cuda")
    cpu = load_fid_inception(FID_PTH, "cpu")
    gaps = [float(np.linalg.norm(card(im) - cpu(im))
                  / np.linalg.norm(cpu(im))) for im in imgs]
    ms = statistics.median(timed(lambda: card(imgs[0]), n=10, warmup=3))
    log(f"  features of {FID_CPU_IMAGES} test images ({imgs[0].shape[2:]} "
        f"and the like, resized to 299), card against CPU: relative gaps "
        f"{[f'{g:.2e}' for g in gaps]} (bound {FID_FEAT_RTOL}); {ms:.2f} ms "
        f"an image on the card (host clock, upload and readback included)")
    if not max(gaps) <= FID_FEAT_RTOL:
        fail(f"the card's Inception features disagree with the CPU's: {gaps}")
    return {"pairs": n, "launches": launches, "wall_s": wall,
            "metrics": res, "features_ms_median": statistics.median(feat),
            "pair_ms_median": statistics.median(pair),
            "features_share": share, "card_vs_cpu_rel": gaps,
            "features_ms_per_image": ms}


P2P_ATOL = 1e-4            # tanh outputs, card against CPU


def pix2pixhd_phase():
    """`define_generator('global')` and `('local')` at the widths of
    pix2pixHD's 2048x1024 recipe (`train.pix2pixhd.G_OPTIONS`: the local
    G ngf 32 around a 64-ngf global G of 4 downsamples and 9 blocks, 3
    local blocks), the global G alone on one 1024x512 image (the scale it
    sees inside the local G), the local G on one 2048x1024 image, seeded
    torch-default weights: the card against the CPU within P2P_ATOL, and
    ms a forward on the card."""
    from t2onet_tpu_torch.models.common import init_torch_defaults
    from t2onet_tpu_torch.models.pix2pixhd import define_generator
    from t2onet_tpu_torch.train.pix2pixhd import G_OPTIONS

    o = G_OPTIONS
    cases = {"global": (dict(ngf=o["ngf"] * 2, n_downsampling=o[
                 "n_downsample_global"], n_blocks=o["n_blocks_global"]),
                 (512, 1024)),
             "local": (dict(o), (1024, 2048))}
    out = {}
    for kind, (kw, (h, w)) in cases.items():
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            -1, 1, (1, 3, h, w)).astype(np.float32))
        xc = x.cuda()
        net = define_generator(kind, **kw)
        init_torch_defaults(net, torch.Generator().manual_seed(5))
        net.eval()
        card = copy.deepcopy(net).cuda()
        with torch.no_grad():
            err = float((card(xc).cpu() - net(x)).abs().max())

            def fwd():
                return card(xc)

            ms = statistics.median(timed(fwd, n=10, warmup=3))
        n_params = sum(p.numel() for p in net.parameters())
        log(f"pix2pixhd {kind}: {n_params / 1e6:.2f}M params, {w}x{h}, card "
            f"vs CPU max abs {err:.2e} (bound {P2P_ATOL}); {ms:.2f} ms a "
            f"forward (host clock, synchronised, median of 10)")
        if not err <= P2P_ATOL:
            fail(f"pix2pixhd {kind}: the card disagrees with the CPU ({err})")
        out[kind] = {"max_abs_err": err, "ms": ms, "params": n_params,
                     "size": [h, w]}
        del card
    return out


# -- phases 29-31: data parallelism -------------------------------------------
DP_RUN_DIR = os.path.join("output", "chip_smoke_dp")
DP_ARGV = ["--synthetic", "--device", "cuda", "--batch_size", "64",
           "--img_size", "128", "--num_iters", "4", "--print_every", "2",
           "--checkpoint_every", "4", "--val_batches", "1", "--fused_exec",
           "1"]


def nccl_one_rank(fn):
    """fn() in this process as rank 0 of a world of 1 on NCCL, joined
    from torchrun's environment (set here, then restored)."""
    from t2onet_tpu_torch.parallel.workers import free_port

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bn_allreduce_cost(actor, batch):
    """What the cross-rank BatchNorm would cost an episode step: the
    train-mode BatchNorm calls of one step (forward hooks), and the host
    clock of one NCCL all-reduce of the size each call packs (2C + 1
    floats) at world size 1, synchronised, median of 200."""
    import torch.distributed as dist

    from t2onet_tpu_torch.models.common import _FlaxBatchNorm

    sizes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: sizes.append(2 * m.num_features + 1))
        for m in actor.modules() if isinstance(m, _FlaxBatchNorm)]
    try:
        st = loop.TrainState(actor)
        loop.episode_step(st, batch, torch.Generator(device="cuda")
                          .manual_seed(1), fused_exec=True)
    finally:
        for h in hooks:
            h.remove()
    t = torch.zeros(max(sizes), device="cuda")
    ms = []
    for i in range(220):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(t[:sizes[i % len(sizes)]])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    per = statistics.median(ms[20:])
    return {"bn_calls_per_episode_step": len(sizes), "allreduce_ms": per,
            "per_step_ms": per * len(sizes)}


def dp_nccl_phase():
    """29 (a): `cli.train_fivek --data_parallel 1` in this process as rank 0
    of a world of 1 on NCCL, against the same run in one process without
    a group, both with cuDNN's deterministic algorithms: the final
    weights bit for bit, B1 = B3 = 5 an episode
    iteration and 5 B1 for the validation batch; an episode step's host
    and device ms under the group and without it; what the cross-rank
    BatchNorm's all-reduces would add to that step."""
    import torch.distributed as dist

    runs, launches = {}, {}
    # cuDNN's weight-gradient algorithms sum in a nondeterministic order:
    # two runs compare bit for bit only with the deterministic ones
    torch.backends.cudnn.deterministic = True
    for name in ("group", "alone"):
        run_dir = os.path.join(DP_RUN_DIR, name)
        shutil.rmtree(run_dir, ignore_errors=True)
        argv = DP_ARGV + ["--data_parallel", "1", "--run_dir", run_dir]
        reset_launches()
        t0 = time.perf_counter()
        try:
            runs[name] = (nccl_one_rank(lambda: train_fivek.main(argv))
                          if name == "group" else train_fivek.main(argv))
        finally:
            if name == "alone":
                torch.backends.cudnn.deterministic = False
        torch.cuda.synchronize()
        launches[name] = dict(chain.LAUNCHES)
        log(f"dp: train_fivek --data_parallel 1 ({name}: "
            f"{'rank 0 of 1 on NCCL' if name == 'group' else 'no group'}) "
            f"4 iterations in {time.perf_counter() - t0:.2f} s; launches "
            f"{launches[name]}")
    steps = runs["group"].actor.cfg.decoder_max_len
    want = {"chain": 2 * steps + steps, "step_bwd": 2 * steps,
            "chain_masked": 0, "step_bwd_masked": 0}
    for name in runs:
        if launches[name] != want:
            fail(f"dp {name}: launches {launches[name]}, want {want}")
    sd_g = runs["group"].actor.state_dict()
    sd_a = runs["alone"].actor.state_dict()
    differ = [k for k in sd_a if not torch.equal(sd_g[k], sd_a[k])]
    log(f"  final weights, group of 1 vs no group: {len(sd_a) - len(differ)}"
        f" of {len(sd_a)} tensors equal bit for bit")
    if differ:
        fail(f"dp: the NCCL world of 1 moved these weights otherwise: "
             f"{differ[:5]}")

    ds = SyntheticFiveK(n=64, img_size=128, seed=5)
    nb = next(ds.batches(64, 1, shuffle=False))
    epi = device_put_batch({"x": nb["x"], "img_x": nb["img_x"],
                            "gt_img": nb["img_y"][:, -1]}, "cuda")
    st = runs["alone"]
    gen = torch.Generator(device="cuda").manual_seed(7)

    def step():
        loop.episode_step(st, epi, gen, fused_exec=True)

    def measure():
        return (statistics.median(timed(step)),
                profiled_us(step)["all"] / 1e3)

    def under_group():
        from t2onet_tpu_torch.parallel import mesh

        mesh.init_data_parallel("cuda")
        try:
            out = measure()
            cost = bn_allreduce_cost(st.actor, epi)
        finally:
            mesh.close_data_parallel()
        return out, cost

    a1 = measure()
    (g1, cost) = nccl_one_rank(under_group)
    a2 = measure()
    if dist.is_initialized():
        fail("dp: the NCCL group outlived its run")
    res = {"weights_equal": True, "launches": launches["group"],
           "episode_host_ms_group": g1[0], "episode_device_ms_group": g1[1],
           "episode_host_ms_alone": [a1[0], a2[0]],
           "episode_device_ms_alone": [a1[1], a2[1]], **cost}
    log(f"  episode step b64 128 px, full width, fused: host {g1[0]:.2f} ms,"
        f" device {g1[1]:.2f} ms under the NCCL group of 1; host "
        f"{a1[0]:.2f} / {a2[0]:.2f} ms, device {a1[1]:.2f} / {a2[1]:.2f} ms "
        f"without (before / after); the cross-rank BatchNorm would make "
        f"{cost['bn_calls_per_episode_step']} all-reduces a step, "
        f"{cost['allreduce_ms']:.4f} ms each on NCCL at world size 1 (host "
        f"clock, synchronised): {cost['per_step_ms']:.2f} ms a step")
    return res


def fivek_step_cases(g):
    """A supervised and a fused FiveK episode step at full width on a
    synthetic b64 x 128² batch, the noise drawn from generator g and fed
    (phases 29 (b), 35)."""
    cfg = ModelConfig()
    vocab = synthetic_vocab()
    actor = Actor(cfg, OperatorConfig(), len(vocab),
                  generator=torch.Generator().manual_seed(3))
    knots_near_one(actor)
    sd = {k: v.clone() for k, v in actor.state_dict().items()}
    nb = next(SyntheticFiveK(n=64, img_size=128, seed=9)
              .batches(64, 1, shuffle=False))
    base = dict(cfg=dataclasses.asdict(cfg), vocab_size=len(vocab),
                state_dict=sd, full="rank0")
    cases = [dict(base, name="supervised", kind="supervised",
                  batch={k: nb[k] for k in SUP_KEYS}),
             dict(base, name="episode", kind="episode", fused=True,
                  batch={"x": nb["x"], "img_x": nb["img_x"],
                         "gt_img": nb["img_y"][:, -1]},
                  gumbel=[bank.gumbel_noise((64, cfg.op_vocab_size), g)
                          .numpy() for _ in range(cfg.decoder_max_len)])]
    return cases


def dp_step_cases():
    """29 (b)'s one-step cases at full width, 128 px, global b64, the same
    noise fed: `fivek_step_cases`, and a fused masked GIER episode step on
    the real GIER data."""
    from t2onet_tpu_torch.data.gier import GIERDatasetAct
    from t2onet_tpu_torch.data.text import load_embedding

    g = torch.Generator().manual_seed(11)
    cases = fivek_step_cases(g)
    glove = load_embedding(GLOVE_NPY)
    ds = GIERDatasetAct(os.path.join("data_real_gier", "GIER"),
                        os.path.join("data_real_gier", "language"),
                        os.path.join("data_real_gier_acts",
                                     "GIER_actions_set_1"), "train",
                        data_mode="shapeAlign", is_load_mask=True,
                        train_img_size=128)
    gb = next(ds.batches(64, 1, shuffle=True, seed=2))
    gcfg = ModelConfig(decoder_max_len=8, fix_input_embedding=True)
    gactor = Actor(gcfg, OperatorConfig(), glove.shape[0] + 4,
                   generator=torch.Generator().manual_seed(3), word2vec=glove)
    knots_near_one(gactor)
    cases.append(dict(
        name="gier_episode", kind="episode", fused=True, full="rank0",
        cfg=dataclasses.asdict(gcfg), vocab_size=glove.shape[0] + 4,
        state_dict={k: v.clone() for k, v in gactor.state_dict().items()},
        batch={"x": gb["x"], "img_x": gb["img_x"],
               "gt_img": gb["img_y"][:, -1],
               "masks_vocab": every_op_masked(gb["masks_vocab"])},
        gumbel=[bank.gumbel_noise((64, gcfg.op_vocab_size), g).numpy()
                for _ in range(gcfg.decoder_max_len)]))
    return cases


def dict_grad_gap(got, want):
    """module_grad_gap over {name: grad} dicts."""
    total = math.sqrt(sum(float((w.double() ** 2).sum())
                          for w in want.values()))
    diff = math.sqrt(sum(float(((got[k].double() - w.double()) ** 2).sum())
                         for k, w in want.items()))
    per = sorted(((float((got[k].double() - w.double()).norm())
                   / (0.05 * float(w.double().norm()) + 1e-6 * total), k)
                  for k, w in want.items()), reverse=True)
    return diff / total, per


def weight_gaps(got, want):
    """(largest gap of the updated weights anywhere, largest where the
    gradient stands clear: |g| above ten times its tensor's largest
    gradient gap between the two runs, and above 1e-6). Adam's first step
    moves a weight by lr · g / (|g| + eps): at most lr anywhere, and
    where the two gradients agree in sign and stand well above eps, by
    the same amount to within rounding."""
    anywhere = clear = 0.0
    for k, g in want["grads"].items():
        d = (got["state_dict"][k].double()
             - want["state_dict"][k].double()).abs()
        g = g.double()
        noise = float((got["grads"][k].double() - g).abs().max())
        mask = g.abs() > max(10 * noise, 1e-6)
        anywhere = max(anywhere, float(d.max()))
        if mask.any():
            clear = max(clear, float(d[mask].max()))
    return anywhere, clear


def dp_gloo_phase():
    """29 (b): two ranks share cuda:0 over gloo (`parallel.workers`, the
    kernels built cold by both ranks at once into a fresh directory),
    each on 32 rows of a global b64: one supervised, one FiveK episode
    and one GIER masked episode step, each held to the same step in one
    process on the card within phase 9's bounds (loss 1e-5; gradients
    1e-2 of their norm, each tensor 5e-2 of its own plus 1e-6 of the
    whole; BatchNorm statistics 1e-4), updated weights within 1e-6 where
    the gradient stands clear of noise and within 2 lr anywhere
    (`weight_gaps`), rank 1's weights equal to rank 0's bit for bit; B1 5 + B3 5, then B2 8 + B4 8 a
    rank."""
    from t2onet_tpu_torch.parallel import workers

    cases = dp_step_cases()
    job_dir = os.path.join(DP_RUN_DIR, "gloo")
    build_dir = os.path.abspath(os.path.join(DP_RUN_DIR, "cold_build"))
    shutil.rmtree(job_dir, ignore_errors=True)
    shutil.rmtree(build_dir, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = workers.run_ranks(
        {"kind": "steps", "device": "cuda:0", "backend": "gloo",
         "cases": cases}, 2, job_dir, timeout=600,
        env={"T2ONET_TORCH_BUILD_DIR": build_dir})
    wall = time.perf_counter() - t0
    built = sorted(os.listdir(build_dir))
    log(f"dp: 2 gloo ranks on cuda:0, 3 steps each, in {wall:.2f} s (two "
        f"processes, cold kernel builds included: {built})")
    if sorted(built) != sorted(f for f in built if f.endswith(".so")) \
            or len(built) != len(build.sources()):
        fail(f"dp: the two ranks' cold builds left {built}")
    want_launch = {"supervised": {},
                   "episode": {"chain": 5, "step_bwd": 5},
                   "gier_episode": {"chain_masked": 8,
                                    "step_bwd_masked": 8}}
    out, worst = {}, []
    for c in cases:
        name = c["name"]
        r0, r1 = ranks[0][name], ranks[1][name]
        one = run_one_case(c)
        if r0["digest"] != r1["digest"]:
            fail(f"dp {name}: the two ranks' weights differ")
        for r in (r0, r1):
            got = {k: v for k, v in r["launches"].items() if v}
            if got != want_launch[name]:
                fail(f"dp {name}: a rank launched {r['launches']}, want "
                     f"{want_launch[name]}")
        key = "loss" if name == "supervised" else "L1_loss"
        lc, lp = r0["metrics"][key], one["metrics"][key]
        rel, per = dict_grad_gap(r0["actor"]["grads"], one["actor"]["grads"])
        stats = max(float((r0["actor"]["state_dict"][k]
                           - one["actor"]["state_dict"][k]).abs().max())
                    for k in one["actor"]["state_dict"] if "running" in k)
        dw, dw_clear = weight_gaps(r0["actor"], one["actor"])
        log(f"  {name}: loss {lc:.7f} (2 ranks) vs {lp:.7f} (one process); "
            f"gradients {rel:.2e} of their norm (bound 1e-2), worst tensors' "
            f"error / bound {[(n, round(e, 4)) for e, n in per[:2]]}; BN "
            f"stats {stats:.2e} (bound 1e-4); updated weights {dw_clear:.2e} "
            f"apart where the gradient stands clear (bound 1e-6), {dw:.2e} "
            f"anywhere (Adam's bound 2 lr = 2e-3); launches a rank "
            f"{r0['launches']}")
        if (not within_phase9(lc, lp, rel, per, stats) or dw > 2e-3
                or dw_clear > 1e-6):
            fail(f"dp {name}: two ranks disagree with one process")
        worst.append((per[0][0], name, per[0][1]))
        out[name] = {"loss_ranks": lc, "loss_one": lp, "grad_rel": rel,
                     "worst": per[0], "stats": stats, "weights": dw,
                     "launches_per_rank": r0["launches"]}
    w = max(worst)
    log(f"  the worst reading against its bound: {w[0]:.4f} ({w[1]}, {w[2]})")
    launches = {k: sum(r[c["name"]]["launches"][k] for r in ranks
                       for c in cases) for k in chain.LAUNCHES}
    return {"steps": out, "wall_s": wall, "launches": launches}


def run_one_case(case):
    from t2onet_tpu_torch.parallel import workers

    c = dict(case, full=True)
    return workers.run_step_case(c, torch.device("cuda"))


def dp_phase():
    return {"nccl": dp_nccl_phase(), "gloo": dp_gloo_phase()}


def mesh_devices():
    """[cuda:0, cuda:0] plus every further visible card."""
    return ["cuda:0", "cuda:0"] + [f"cuda:{i}" for i in
                                   range(1, torch.cuda.device_count())]


def mesh_serve_phase():
    """30: `fused_chain_sharded` over the mesh against `fused_chain` at
    bench's b128 x 512 x 512 x K5, unmasked and masked: bit-exact, one
    launch a shard; phase 7's actor behind ServingEngine(mesh=),
    max_batch 8, 32 requests over two buckets: the programs of the
    single-device engine, images within one level, one B1 a shard a
    micro-batch; req/s over 64 requests at 512 px beside the single
    engine's, in turns."""
    from t2onet_tpu_torch.ops.chain import fused_chain_sharded
    from t2onet_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(devices=mesh_devices())
    imgs, slots, params = to_card(*bench_workload())
    mask = to_card(half_mask(128, 512, 512, 5))[0]
    res = {"mesh": [str(d) for d in m.devices]}
    launches = {}
    for name, mk in (("chain", None), ("chain_masked", mask)):
        want = chain.fused_chain(imgs, slots, params, mask=mk)
        reset_launches()
        got = fused_chain_sharded(imgs, slots, params, m, mask=mk)
        torch.cuda.synchronize()
        launches[name] = chain.LAUNCHES[name]
        err = max_err(got, want)
        ms = statistics.median(time_ms(
            lambda: fused_chain_sharded(imgs, slots, params, m, mask=mk)))
        one_ms = statistics.median(time_ms(
            lambda: chain.fused_chain(imgs, slots, params, mask=mk)))
        log(f"mesh_serve: fused_chain_sharded ({name}) over {m}: max abs "
            f"err {err} against fused_chain, {launches[name]} launches; "
            f"call {ms:.4f} ms vs {one_ms:.4f} ms unsharded")
        if err != CHAIN_ATOL or launches[name] != m.size:
            fail(f"mesh_serve: the sharded {name} erred {err} with "
                 f"{launches[name]} launches (want 0 and {m.size})")
        res[name] = {"max_abs_err": err, "launches": launches[name],
                     "ms": ms, "ms_unsharded": one_ms}

    vocab = make_vocab()
    cfg = ModelConfig()
    actor = Actor(cfg, OperatorConfig(), len(vocab),
                  generator=torch.Generator().manual_seed(0))
    knots_near_one(actor)
    kw = dict(decode_size=128, max_batch=8, u8_wire=True,
              encoder_max_len=cfg.encoder_max_len)
    single = ServingEngine(copy.deepcopy(actor), vocab, device="cuda", **kw)
    meshed = ServingEngine(actor, vocab, mesh=m, **kw)
    imgs = make_images(24, 512, 512, seed=0) + make_images(8, 384, 640, 1)
    reqs = [TEXTS[i % len(TEXTS)] for i in range(len(imgs))]
    want = single.edit_batch(imgs, reqs)
    reset_launches()
    got = meshed.edit_batch(imgs, reqs)
    serve_launches = dict(chain.LAUNCHES)
    batches = meshed.stats["batches"]
    log(f"mesh_serve: 32 requests over {m} in {batches} micro-batches; "
        f"launches {serve_launches} (want {batches * m.size} chain)")
    if serve_launches["chain"] != batches * m.size or batches != 4:
        fail(f"mesh_serve: {serve_launches} over {batches} micro-batches")
    lsb = 0.0
    for g, w in zip(got, want):
        if g.ops != w.ops:
            fail(f"mesh_serve: the mesh decoded {g.ops}, one card {w.ops}")
        lsb = max(lsb, float(np.abs(g.image - w.image).max()) * 255)
    log(f"  the same {len(got)} programs; images within {lsb:.3f} levels")
    if lsb > LSB:
        fail(f"mesh_serve: images {lsb} levels apart")
    for e in (single, meshed):
        e.warmup(buckets=[(512, 512)])
    timed_imgs = make_images(64, 512, 512, seed=3)
    treqs = [TEXTS[i % 4] for i in range(64)]
    rates = {"single": [], "mesh": []}
    for name in ("single", "mesh", "mesh", "single"):
        e = single if name == "single" else meshed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.edit_batch(timed_imgs, treqs)
        torch.cuda.synchronize()
        rates[name].append(64 / (time.perf_counter() - t0))
    log(f"  req/s at 512 px, max_batch 8 (host clock around edit_batch of "
        f"64, in turns): mesh {[round(r, 2) for r in rates['mesh']]}, one "
        f"card {[round(r, 2) for r in rates['single']]}")
    res.update(serve_launches=serve_launches["chain"], images_lsb=lsb,
               req_s=rates, launches=launches)
    return res


def mesh_plan_phase():
    """31: batch_beam_search over [cuda:0, cuda:0] on phase 14's 16 FiveK
    pairs at b8 lockstep: each shard's plans equal, ops and distances bit
    for bit, the single card's plans of that shard's pairs alone (the
    same shapes, so the same arithmetic). Against the single card's b8
    plans the fits' reductions sum in another order at another batch
    size, and 100 Adam steps carry that into near-ties, as phase 14
    finds against JAX: where the top-beam ops agree, each step's
    distance within PLAN_DIST_TOL (up to the parting, where they part)
    and where they part, the final distances within MESH_PART_TOL. No
    kernel. Then `cli.plan_fleet --workers 2`
    on 8 pairs and `--verify_only`."""
    from t2onet_tpu_torch.data.fivek import FiveK
    from t2onet_tpu_torch.parallel.mesh import make_mesh, pad_rows, shard_rows
    from t2onet_tpu_torch.planner.beam import batch_beam_search

    ds = FiveK(os.path.join("data_real_h2h", "FiveK", "images"),
               os.path.join("data_real_h2h", "FiveK", "annotations"),
               "train", 1, 128, eval_img_mode="train_size")
    items = [ds[i] for i in range(PLAN_PAIRS)]
    m = make_mesh(devices=mesh_devices())
    walls = {"single": 0.0, "mesh": 0.0}
    same_ops, b8_gap, partings = 0, 0.0, []
    reset_launches()
    for b0 in range(0, PLAN_PAIRS, 8):
        x = np.stack([it[0] for it in items[b0:b0 + 8]])
        y = np.stack([it[1] for it in items[b0:b0 + 8]])
        plans = {}
        for name, kw in (("single", {"device": "cuda"}), ("mesh", {"mesh": m})):
            t0 = time.perf_counter()
            plans[name] = [a for a, _ in batch_beam_search(
                x, y, seed=10 + b0, replay_beams=1, **kw)]
            walls[name] += time.perf_counter() - t0
        xp, yp = pad_rows(x, m.size), pad_rows(y, m.size)
        shards = []
        for r, d in zip(shard_rows(len(xp), m), m.devices):
            shards += [a for a, _ in batch_beam_search(
                xp[r], yp[r], seed=10 + b0, replay_beams=1, device=d)]
        for i, (got, alone, b8) in enumerate(zip(plans["mesh"], shards,
                                                 plans["single"])):
            if got != alone:
                fail(f"mesh_plan: pair {b0 + i}: the mesh planned {got[0]}, "
                     f"its shard alone {alone[0]}")
            k = parting_step(got[0], b8[0])
            b8_gap = max([b8_gap] + [abs(a[2] - b[2]) for a, b
                                     in zip(got[0][:k], b8[0][:k])])
            if k < max(len(got[0]), len(b8[0])):
                partings.append((b0 + i, k, got[0][-1][2] if got[0]
                                 else math.inf, b8[0][-1][2] if b8[0]
                                 else math.inf))
            else:
                same_ops += 1
    launches = sum(chain.LAUNCHES.values())
    log(f"mesh_plan: {PLAN_PAIRS} pairs in 2 lockstep batches of 8 over {m}:"
        f" every plan equal to its shard's planned alone; against the "
        f"single card's b8 plans {same_ops} of {PLAN_PAIRS} with the same "
        f"top-beam ops, step distances before any parting up to "
        f"{b8_gap:.3e} apart (bound "
        f"{PLAN_DIST_TOL}); {PLAN_PAIRS / walls['mesh']:.3f} pairs/s vs "
        f"{PLAN_PAIRS / walls['single']:.3f} on one card; launches "
        f"{launches}")
    for pair, k, d_mesh, d_b8 in partings:
        log(f"  pair {pair}: the mesh and b8 plans part at step {k}, final "
            f"distances {d_mesh:.7f} vs {d_b8:.7f} (bound {MESH_PART_TOL})")
    if b8_gap > PLAN_DIST_TOL:
        fail(f"mesh_plan: step distances {b8_gap:.3e} from the b8 plans")
    far = [p for p in partings if abs(p[2] - p[3]) > MESH_PART_TOL]
    if far:
        fail(f"mesh_plan: plans part beyond a near-tie: {far}")
    if launches:
        fail(f"mesh_plan: the planner launched {launches} kernels")
    out = os.path.join("output", "chip_smoke_fleet")
    shutil.rmtree(out, ignore_errors=True)
    fleet = ["--data_dir", "data_real_h2h", "--total", "8", "--img_size",
             "128", "--out_dir", out]
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m",
                        "t2onet_tpu_torch.cli.plan_fleet", "--workers", "2",
                        "--pair_batch", "4"] + fleet,
                       capture_output=True, text=True, timeout=600)
    fleet_s = time.perf_counter() - t0
    log(f"  plan_fleet --workers 2 on 8 pairs: rc {p.returncode} in "
        f"{fleet_s:.2f} s: {p.stdout.strip().splitlines()[-1:]}")
    if p.returncode != 0:
        fail(f"plan_fleet failed: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    v = subprocess.run([sys.executable, "-m",
                        "t2onet_tpu_torch.cli.plan_fleet", "--verify_only"]
                       + fleet, capture_output=True, text=True, timeout=120)
    log(f"  plan_fleet --verify_only: rc {v.returncode}: {v.stdout.strip()}")
    if v.returncode != 0:
        fail("plan_fleet --verify_only found missing pairs")
    return {"same_ops_as_b8": same_ops, "step_dist_gap_b8": b8_gap,
            "partings_b8": partings,
            "pairs_per_s_mesh": PLAN_PAIRS / walls["mesh"],
            "pairs_per_s_single": PLAN_PAIRS / walls["single"],
            "launches": launches, "fleet_s": fleet_s,
            "fleet": json.loads(p.stdout.strip().splitlines()[-1])}


# -- phases 32-35 -------------------------------------------------------------
# Phase 32's bounds, stated before its first run on the card from the
# CPU's f32-vs-f64 gaps at 512² (largest: forward 3.8e-7, image gradient
# 1.6e-6 anywhere and 1.2e-7 of its norm, a parameter's gradient 1.5e-6
# of itself), with room for the card's own rounding (fused multiply-adds)
EXTRA_FWD_ATOL = 1e-5          # card f32 against CPU f64, any element
EXTRA_GRAD_ATOL = 1e-4         # the image's gradient, any element
EXTRA_GRAD_REL = 1e-5          # the image's gradient, of its norm
EXTRA_PARAM_RTOL = 1e-4        # each parameter gradient, of itself
# The first run of this phase on an H100 80GB HBM3 at 700 W read the
# round trip's image gradient 2.92e-2 from f64 at one element (1.65e-5 of
# the norm): a pixel whose hue the card's f32 and the CPU's f64 floor
# into neighbouring sextants. Such pixels are
# left out of that gradient's gaps (`sextant_flips`) and counted; the
# r == g > b patches (hue exactly 1/6) are 512 of them at most
SEXTANT_FLIPS_MAX = 1024
REVERSE_PARAM_ATOL = 1e-4      # a reverse fit's parameters, card vs CPU
EXTRA_OPS = {"exposure": 1, "bnw": 1, "blur": 1, "hue": 1,
             "whitebalance": 3}
SWEEP_DIR = os.path.join("output", "chip_smoke_sweep")
SWEEP_ATOL = 1e-5              # a sweep's image, card against CPU, f32


def interior_images(b, size, seed):
    """b random images in [0.02, 0.98] with gray and r == g > b patches
    (HSV's ties) and no pixel at a clamp's edge, where f32 and f64 may
    take the clamp on different sides."""
    img = np.random.default_rng(seed).uniform(
        0.02, 0.98, (b, 3, size, size)).astype(np.float32)
    img[:, :, 0:8, 0:8] = 0.5
    img[:, 0:2, 8:16, 0:8] = 0.8
    img[:, 2, 8:16, 0:8] = 0.3
    return img


def card_vs_f64(fn, args, cot, skip=None):
    """fn and its VJP with cotangent `cot` on the card in f32 and on the
    CPU in f64: (forward max gap, [(grad max gap, grad gap / norm,
    largest gap of an entry relative to itself)] per argument). `skip`
    (bool, the first argument's shape) leaves entries out of the first
    argument's gradient gaps."""
    outs = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        ts = [torch.tensor(a, dtype=dtype, device=dev, requires_grad=True)
              for a in args]
        out = fn(*ts)
        g = torch.autograd.grad(out, ts, torch.as_tensor(cot, dtype=dtype,
                                                         device=dev))
        outs[dev] = (out.detach().double().cpu(),
                     [x.double().cpu() for x in g])
    (oc, gc), (op, gp) = outs["cuda"], outs["cpu"]
    if skip is not None:
        gc[0], gp[0] = gc[0][~skip], gp[0][~skip]
    grads = [(float((a - b).abs().max()),
              float((a - b).norm() / b.norm()),
              float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()))
             for a, b in zip(gc, gp)]
    return float((oc - op).abs().max()), grads


def sextant_flips(img):
    """(B, 3, H, W) bool: the pixels whose hue the card's f32 puts in
    another sextant than the CPU's f64 (floor of h·6 on either side of an
    integer). The branchless round trip is continuous there, but its
    gradient is not: the two sides' formulas differ in the hue's
    gradient, in JAX's form too."""
    from t2onet_tpu_torch.ops import color

    def sextant(x):
        h = color.rgb_to_hsv(x)[0]
        return torch.floor(torch.remainder(h, 1.0) * 6.0).cpu()

    t = torch.from_numpy(img)
    flips = sextant(t.cuda()) != sextant(t.double())
    return flips.expand(-1, 3, -1, -1)


def reverse_cases():
    """(name, img, edited, forward param, forward op) of the reverse
    fits of tests/test_torch_ops_extra.py, the edits made on the CPU."""
    from t2onet_tpu_torch.cli.op_sweep import procedural_image
    from t2onet_tpu_torch.ops import reverse

    img7 = np.clip(np.random.default_rng(7).uniform(
        0.2, 0.8, (1, 3, 16, 16)), 0, 1).astype(np.float32)
    img0 = np.random.default_rng(0).uniform(
        0.05, 0.4, (1, 3, 24, 24)).astype(np.float32)
    smooth = procedural_image(16)
    out = []
    for name, img, p, op in (("brightness", img7, 0.3, "brightness"),
                             ("plateau", img0, 1.5, "brightness"),
                             ("contrast", img7, 0.4, "contrast"),
                             ("sharpness", smooth, 0.5, "sharpness"),
                             ("blur", smooth, 0.6, "blur")):
        edited = reverse.apply_operator(img, None, [p], op,
                                        device="cpu").numpy()
        out.append((name, img, edited, [p], op))
    return out


def ops_extra_phase():
    """32: the HSV round trip and the five extra operators at b8 x 512²,
    card f32 against CPU f64, forward and VJPs; the reverse fits on the
    card against the CPU; `cli.op_sweep` on the card: the CPU's file list
    and images."""
    from t2onet_tpu_torch.cli import op_sweep
    from t2onet_tpu_torch.ops import color
    from t2onet_tpu_torch.ops import operators as O
    from t2onet_tpu_torch.ops import reverse

    reset_launches()
    b, size = 8, 512
    img = interior_images(b, size, seed=12)
    rng = np.random.default_rng(13)
    cot = rng.normal(size=img.shape).astype(np.float32)
    out, bad = {}, []
    t0 = time.perf_counter()
    flips = sextant_flips(img)
    fwd, grads = card_vs_f64(lambda i: color.hsv_to_rgb(
        *color.rgb_to_hsv(i)), [img], cot, skip=flips)
    out["hsv_round_trip"] = {"fwd": fwd, "img_grad": grads[0],
                             "sextant_flips": int(flips[:, 0].sum())}
    if fwd > EXTRA_FWD_ATOL or grads[0][0] > EXTRA_GRAD_ATOL \
            or grads[0][1] > EXTRA_GRAD_REL:
        bad.append("hsv_round_trip")
    for name, k in EXTRA_OPS.items():
        lo, hi = (0.5, 1.5) if name == "whitebalance" else (-0.8, 1.2)
        p = rng.uniform(lo, hi, (b, k)).astype(np.float32)
        fwd, grads = card_vs_f64(
            lambda i, q, name=name: O.mask_blend(O.OP_FNS[name](i, q), i),
            [img, p], cot)
        out[name] = {"fwd": fwd, "img_grad": grads[0],
                     "param_grad_rel": grads[1][2]}
        if fwd > EXTRA_FWD_ATOL or grads[0][0] > EXTRA_GRAD_ATOL \
                or grads[0][1] > EXTRA_GRAD_REL \
                or grads[1][2] > EXTRA_PARAM_RTOL:
            bad.append(name)
    log(f"ops_extra: b{b} x {size}², card f32 against CPU f64 in "
        f"{time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"{n} fwd {v['fwd']:.2e}, image grad max "
                    f"{v['img_grad'][0]:.2e} / norm {v['img_grad'][1]:.2e}"
                    + (f", param grad {v['param_grad_rel']:.2e}"
                       if "param_grad_rel" in v else "")
                    for n, v in out.items())
        + f" (bounds fwd {EXTRA_FWD_ATOL}, image grad {EXTRA_GRAD_ATOL} / "
        f"{EXTRA_GRAD_REL} of its norm, param grad {EXTRA_PARAM_RTOL}); the "
        f"round trip's gradient without the "
        f"{out['hsv_round_trip']['sextant_flips']} of {b * size * size} "
        f"pixels whose sextant the card's f32 and the CPU's f64 floor to "
        f"either side (`sextant_flips`, at most {SEXTANT_FLIPS_MAX})")
    if out["hsv_round_trip"]["sextant_flips"] > SEXTANT_FLIPS_MAX:
        bad.append("sextant flips")
    if bad:
        fail(f"ops_extra: {bad} disagree with the CPU's f64")

    fits = {}
    for name, im, edited, p, op in reverse_cases():
        rev, p0 = reverse.rev_ops_dict[op], reverse.get_rev_param0(p, op)
        t0 = time.perf_counter()
        card, ok_card = reverse.get_param_naive(edited, im, None, p0, rev,
                                                device="cuda")
        card_s = time.perf_counter() - t0
        cpu, ok_cpu = reverse.get_param_naive(edited, im, None, p0, rev,
                                              device="cpu")
        gap = max(abs(a - c) for a, c in zip(card, cpu))
        fits[name] = {"card": card, "cpu": cpu, "ok": ok_card, "gap": gap,
                      "card_s": card_s}
        if ok_card != ok_cpu or gap > REVERSE_PARAM_ATOL:
            fail(f"ops_extra: the {name} reverse fit on the card ({card}, "
                 f"{ok_card}) is not the CPU's ({cpu}, {ok_cpu})")
        if ok_card:
            got, _ = reverse.get_reverse(torch.from_numpy(im).cuda(),
                                         torch.from_numpy(edited).cuda(),
                                         None, p, op)
            if got != card:
                fail(f"ops_extra: get_reverse gave {got}, its fit {card}")
    log("  reverse fits (300 Adam steps, 4 starts), card vs CPU: "
        + "; ".join(f"{n} {v['card'][0]:.6f} vs {v['cpu'][0]:.6f} "
                    f"(ok {v['ok']}, gap {v['gap']:.2e}, "
                    f"{v['card_s']:.2f} s)" for n, v in fits.items())
        + f" (bound {REVERSE_PARAM_ATOL}, same success flag)")

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    src = os.path.join("data_real_h2h", "FiveK", "images", "0017_A.jpg")
    t0 = time.perf_counter()
    written = op_sweep.main(["--device", "cuda", "--img", src, "--img_size",
                             "512", "--out_dir", SWEEP_DIR])
    sweep_s = time.perf_counter() - t0
    from t2onet_tpu_torch.data.fivek import load_train_img

    want = op_sweep.sweep(torch.from_numpy(load_train_img(src, 512)[None]))
    got_rel = [os.path.relpath(p, SWEEP_DIR) for p, _ in written]
    gap = max(float(np.abs(a - w).max())
              for (_, a), (_, w) in zip(written, want))
    on_disk = sorted(os.path.relpath(os.path.join(d, f), SWEEP_DIR)
                     for d, _, fs in os.walk(SWEEP_DIR) for f in fs)
    log(f"  op_sweep on the card at 512² ({sweep_s:.2f} s, JPEGs written): "
        f"{len(written)} images in {len(set(os.path.dirname(r) for r in got_rel))}"
        f" directories, largest gap to the CPU's arrays {gap:.2e} (bound "
        f"{SWEEP_ATOL}); launches {dict(chain.LAUNCHES)}")
    if got_rel != [r for r, _ in want] or on_disk != sorted(got_rel) \
            or not gap <= SWEEP_ATOL:
        fail(f"ops_extra: the card's sweep is not the CPU's (files "
             f"{len(got_rel)} vs {len(want)}, gap {gap})")
    if any(chain.LAUNCHES.values()):
        fail(f"ops_extra launched a kernel: {dict(chain.LAUNCHES)}")
    return {"card_vs_f64": out, "reverse": fits, "sweep_files": len(written),
            "sweep_gap": gap, "sweep_s": sweep_s}


CONVERT_DIR = os.path.join("output", "chip_smoke_convert")
CONVERT_PAIRS = 8
CONVERT_IMG_ATOL = 1e-5      # converted vs in-memory: the fold rounds once
CONVERT_ARGV = ["--data_dir", "data_real_h2h", "--glove_path",
                FIVEK_GLOVE_NPY]


def convert_phase():
    """33: a full-width ModelConfig() actor's state_dict, its second LSTM
    biases nonzero, written as a reference model.pth; `python -m
    t2onet_tpu_torch convert --kind actor`, then `test_fivek` from that
    run directory on the first 8 FiveK test pairs (B1 5 a pair, nothing
    else): the programs of the actor in memory on the same inputs, images
    within CONVERT_IMG_ATOL; `--kind gan` with the reference
    discriminator (ndf 64, 3 layers, 2 scales): disc/ equal to it."""
    from t2onet_tpu_torch import __main__ as dispatcher
    from t2onet_tpu_torch.cli import test_fivek
    from t2onet_tpu_torch.cli.train_gan import build_disc
    from t2onet_tpu_torch.models.common import init_torch_defaults
    from t2onet_tpu_torch.train.checkpoint import StateCheckpointer

    shutil.rmtree(CONVERT_DIR, ignore_errors=True)
    os.makedirs(CONVERT_DIR)
    a = test_fivek.eval_parser().parse_args(CONVERT_ARGV)
    vocab2id, _, w2v = common.build_vocab_only(a)
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    knots_near_one(actor)
    g = torch.Generator().manual_seed(21)
    with torch.no_grad():
        for n, p in actor.named_parameters():
            if ".rnn.bias_hh_" in n:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    pth = os.path.join(CONVERT_DIR, "model.pth")
    torch.save(actor.state_dict(), pth)
    run = os.path.join(CONVERT_DIR, "run")
    t0 = time.perf_counter()
    rc = dispatcher.main(["convert", "--kind", "actor", "--torch_ckpt", pth,
                          "--run_dir", run] + CONVERT_ARGV)
    convert_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"convert: the dispatcher returned {rc}")

    records, rollouts = [], []
    native, episode = test_fivek.test_native_res, test_fivek.eval_episode

    def first_pairs(actor_, ds, *args, **kw):
        return native(actor_, [ds[i] for i in range(CONVERT_PAIRS)], *args,
                      records=records, **kw)

    def kept(actor_, batch, fused_exec=False):
        pred, out = episode(actor_, batch, fused_exec=fused_exec)
        rollouts.append((batch, pred, out["ops"]))
        return pred, out

    reset_launches()
    test_fivek.test_native_res, test_fivek.eval_episode = first_pairs, kept
    try:
        t0 = time.perf_counter()
        res = test_fivek.main(CONVERT_ARGV + ["--run_dir", run,
                                              "--skip_variance"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        test_fivek.test_native_res, test_fivek.eval_episode = native, episode
    launches = dict(chain.LAUNCHES)
    want = CONVERT_PAIRS * a.decoder_max_len
    mem = actor.cuda().eval()
    same, gap = [], 0.0
    for batch, pred, ops in rollouts:
        p2, o2 = loop.eval_episode(mem, batch, fused_exec=True)
        same.append(torch.equal(ops, o2["ops"]))
        gap = max(gap, float((pred - p2).abs().max()))
    log(f"convert: reference model.pth (full width, second LSTM biases "
        f"nonzero) -> run dir in {convert_s:.2f} s; test_fivek on "
        f"{len(records)} FiveK test pairs in {eval_s:.2f} s, metrics {res}, "
        f"launches {launches} (want chain {want}); against the actor in "
        f"memory: programs equal {same}, largest image gap {gap:.2e} "
        f"(bound {CONVERT_IMG_ATOL})")
    if len(records) != CONVERT_PAIRS or launches["chain"] != want or any(
            v for k, v in launches.items() if k != "chain"):
        fail(f"convert: test_fivek rolled out {len(records)} pairs with "
             f"launches {launches}, want {CONVERT_PAIRS} pairs and chain "
             f"{want} alone")
    if not all(same) or not gap <= CONVERT_IMG_ATOL:
        fail("convert: the converted run's rollouts are not the actor's")

    ns = types.SimpleNamespace(n_layers=a.n_layers,
                               hidden_size=a.hidden_size, n_layers_D=3,
                               num_D=2, manual_seed=5)
    bundle = build_disc(ns, "cpu")
    init_torch_defaults(bundle, torch.Generator().manual_seed(22))
    gan_sd = {f"actor.{k}": v.cpu() for k, v in actor.state_dict().items()}
    gan_sd.update(bundle.state_dict())
    gpth = os.path.join(CONVERT_DIR, "gan_model.pth")
    torch.save(gan_sd, gpth)
    rc = dispatcher.main(["convert", "--kind", "gan", "--torch_ckpt", gpth,
                          "--run_dir", run] + CONVERT_ARGV)
    ckpt = os.path.join(run, "seq2seqGAN_model")
    disc = StateCheckpointer(os.path.join(ckpt, "disc")).restore("best")
    disc_equal = all(torch.equal(disc[k].cpu(), v)
                     for k, v in bundle.state_dict().items())
    g_model = torch.load(os.path.join(ckpt, "checkpoint_best.pt"),
                         map_location="cpu", weights_only=True)["model"]
    l_model = torch.load(os.path.join(run, "seq2seqL1_model",
                                      "checkpoint_best.pt"),
                         map_location="cpu", weights_only=True)["model"]
    actor_equal = all(torch.equal(g_model[k], v) for k, v in l_model.items())
    log(f"  --kind gan (D ndf 64, 3 layers, 2 scales): disc/ equal to the "
        f"reference discriminator {disc_equal}, actor equal to the L1 "
        f"conversion's {actor_equal}")
    if rc != 0 or not disc_equal or not actor_equal:
        fail("convert: the GAN conversion is not the reference's weights")
    return {"launches": launches, "pairs": len(records), "metrics": res,
            "img_gap": gap, "convert_s": convert_s, "eval_s": eval_s}


SUPERVISOR_DIR = os.path.join("output", "chip_smoke_supervisor")
SUPERVISOR_WRAPPER = '''"""train_fivek that exits 1 once, right after its checkpoint at
iteration 4; a run that finishes writes its launch counts."""
import json, os, sys
sys.path.insert(0, os.getcwd())
from t2onet_tpu_torch.cli import train_fivek
from t2onet_tpu_torch.ops import chain
from t2onet_tpu_torch.train import checkpoint

marker, counts = sys.argv[1], sys.argv[2]
save = checkpoint.CheckpointManager.save


def crash_once(self, state, itr, *args, **kw):
    best = save(self, state, itr, *args, **kw)
    if itr == 4 and not os.path.exists(marker):
        open(marker, "w").write("exited after the checkpoint at 4")
        sys.exit(1)
    return best


checkpoint.CheckpointManager.save = crash_once
state = train_fivek.main(sys.argv[3:])
with open(counts, "w") as f:
    json.dump({"launches": dict(chain.LAUNCHES), "step": state.step,
               "argv": sys.argv[3:]}, f)
'''


def supervisor_phase():
    """34: `cli.train_supervisor` around a full-width `train_fivek
    --synthetic` (b64 x 128², 8 iterations, a checkpoint every 4) that a
    wrapper makes exit 1 right after its checkpoint at iteration 4: the
    restart resumes with --resume, keeps its numbering and finishes
    iteration 8; B1 and B3 counted in the resumed run."""
    shutil.rmtree(SUPERVISOR_DIR, ignore_errors=True)
    os.makedirs(SUPERVISOR_DIR)
    wrapper = os.path.join(SUPERVISOR_DIR, "crash_once.py")
    with open(wrapper, "w") as f:
        f.write(SUPERVISOR_WRAPPER)
    marker = os.path.join(SUPERVISOR_DIR, "crashed")
    counts = os.path.join(SUPERVISOR_DIR, "counts.json")
    run = os.path.join(SUPERVISOR_DIR, "run")
    argv = [a for a in TRAIN_ARGV if a != TRAIN_RUN_DIR] + [run]
    argv[argv.index("--checkpoint_every") + 1] = "4"
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "t2onet_tpu_torch.cli.train_supervisor",
         "--backoff", "0", "--max_restarts", "2", "--", sys.executable,
         wrapper, marker, counts] + argv,
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    with open(os.path.join(SUPERVISOR_DIR, "supervisor.log"), "w") as f:
        f.write(p.stdout + p.stderr)
    launched = [ln for ln in p.stdout.splitlines()
                if ln.startswith("[supervisor] launching")]
    if p.returncode != 0 or not os.path.exists(counts):
        fail(f"supervisor: exit {p.returncode}\n{p.stdout[-3000:]}\n"
             f"{p.stderr[-3000:]}")
    with open(counts) as f:
        done = json.load(f)
    steps = [s for s, k, _ in logged_losses(os.path.join(run,
                                                         "metrics.jsonl"))
             if k != "val_L1"]
    ckpts = sorted(os.listdir(os.path.join(run, "seq2seqL1_model")))
    launches = done["launches"]
    resumed_episodes = sum(1 for i in range(5, 9) if i % 2 == 0)
    want = {"chain": (resumed_episodes + 1) * 5,
            "step_bwd": resumed_episodes * 5}
    log(f"supervisor: {len(launched)} launches in {wall:.2f} s (two "
        f"processes, each from start-up); the resumed run's argv ends "
        f"{done['argv'][-2:]}, final step {done['step']}, logged steps "
        f"{steps}, checkpoints {ckpts}; its launches {launches}, want "
        f"{want} (iterations 5-8: 2 episode iterations x 5 steps, and 5 "
        f"chains for the validation batch)")
    if len(launched) != 2 or done["argv"][-1] != "--resume" \
            or done["step"] != 8 or steps != sorted(steps) \
            or "checkpoint_iter00000008.pt" not in ckpts \
            or "checkpoint_iter00000004.pt" not in ckpts:
        fail("supervisor: the restart did not resume and finish at 8")
    if {k: v for k, v in launches.items() if v} != want:
        fail(f"supervisor: the resumed run launched {launches}, want {want}")
    return {"launches": {k: launches.get(k, 0) for k in chain.LAUNCHES},
            "wall_s": wall, "restarts": len(launched) - 1}


TP_DIR = os.path.join("output", "chip_smoke_tp")


def tp_heads_phase():
    """35: two gloo ranks on cuda:0 as a (1 x 2) grid (`mesh.make_2d_mesh`,
    each rank four of the eight heads), one supervised and one fused
    episode step at full width on phase 29 (b)'s b64 x 128² synthetic
    batch and noise, the kernels from this process's build: each rank
    against the same step in one process within phase 9's bounds, B1 5 +
    B3 5 a rank, each rank's Adam holding moments for its own four heads
    and the replicated rest; then `python -m t2onet_tpu_torch help`."""
    from t2onet_tpu_torch.parallel import workers

    cases = [dict(c, full=True) for c in fivek_step_cases(
        torch.Generator().manual_seed(11))]
    shutil.rmtree(TP_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ranks = workers.run_ranks(
        {"kind": "steps", "device": "cuda:0", "backend": "gloo",
         "model_par": 2, "cases": cases}, 2, TP_DIR, timeout=600,
        env={"T2ONET_TORCH_BUILD_DIR": build.BUILD_DIR})
    wall = time.perf_counter() - t0
    log(f"tp_heads: 2 gloo ranks on cuda:0 as (1 x 2), 2 steps each, in "
        f"{wall:.2f} s (two processes, kernels from this process's build)")
    want_launch = {"supervised": {}, "episode": {"chain": 5, "step_bwd": 5}}
    out = {}
    for c in cases:
        name = c["name"]
        one = run_one_case(c)
        rest = [n for n in one["moments"] if not n.startswith("executor.")]
        key = "loss" if name == "supervised" else "L1_loss"
        for r, res in enumerate(ranks):
            got = res[name]
            own = list(range(4 * r, 4 * r + 4))
            heads = sorted({OP_NAMES.index(n.split(".")[1][:-3])
                            for n in got["moments"]
                            if n.startswith("executor.")})
            if heads != own or [n for n in got["moments"]
                                if not n.startswith("executor.")] != rest:
                fail(f"tp_heads {name}: rank {r}'s Adam holds heads "
                     f"{heads}, want {own} and the replicated rest")
            if {k: v for k, v in got["launches"].items() if v} \
                    != want_launch[name]:
                fail(f"tp_heads {name}: rank {r} launched "
                     f"{got['launches']}, want {want_launch[name]}")
            grads = got["actor"]["grads"]
            rel, per = dict_grad_gap(grads, {k: one["actor"]["grads"][k]
                                             for k in grads})
            stats = max(float((got["actor"]["state_dict"][k]
                               - one["actor"]["state_dict"][k]).abs().max())
                        for k in one["actor"]["state_dict"] if "running" in k)
            dw, dw_clear = weight_gaps(
                got["actor"], {"grads": {k: one["actor"]["grads"][k]
                                         for k in grads},
                               "state_dict": one["actor"]["state_dict"]})
            lc, lp = got["metrics"][key], one["metrics"][key]
            log(f"  {name}, rank {r} (heads {own}): loss {lc:.7f} vs "
                f"{lp:.7f} (one process); gradients {rel:.2e} of their norm, "
                f"worst tensor's error / bound {per[0][0]:.4f} ({per[0][1]});"
                f" BN stats {stats:.2e}; gathered weights {dw_clear:.2e} "
                f"where the gradient stands clear, {dw:.2e} anywhere; "
                f"launches {got['launches']}")
            if (not within_phase9(lc, lp, rel, per, stats) or dw > 2e-3
                    or dw_clear > 1e-6):
                fail(f"tp_heads {name}: rank {r} disagrees with one process")
        a, b = (ranks[r][name]["actor"]["state_dict"] for r in (0, 1))
        heads_equal = all(torch.equal(a[k], b[k]) for k in a
                          if k.startswith("executor."))
        replica_gap = max(float((a[k].double() - b[k].double()).abs().max())
                          for k in a if not k.startswith("executor."))
        log(f"  {name}: the ranks' gathered heads equal {heads_equal}; the "
            f"replicated rest {replica_gap:.2e} apart at most")
        if not heads_equal:
            fail(f"tp_heads {name}: the gathered heads differ over the ranks")
        out[name] = {"loss_ranks": ranks[0][name]["metrics"][key],
                     "loss_one": one["metrics"][key],
                     "replica_gap": replica_gap,
                     "launches_per_rank": ranks[0][name]["launches"]}
    h = subprocess.run([sys.executable, "-m", "t2onet_tpu_torch", "help"],
                       capture_output=True, text=True, timeout=120)
    listed = [ln.split()[0] for ln in h.stdout.splitlines()
              if ln.startswith("  ")]
    log(f"  python -m t2onet_tpu_torch help: exit {h.returncode}, "
        f"{len(listed)} commands {listed}")
    if h.returncode != 0 or len(listed) != 16:
        fail(f"tp_heads: the dispatcher's help failed: {h.stdout}{h.stderr}")
    launches = {k: sum(r[c["name"]]["launches"][k] for r in ranks
                       for c in cases) for k in chain.LAUNCHES}
    return {"steps": out, "wall_s": wall, "launches": launches,
            "commands": listed}


# -- phase 36 -----------------------------------------------------------------
EDGES_DIR = os.path.join("output", "chip_smoke_edges")
GIER_IMAGES = os.path.join("data_real_gier", "GIER", "images")
EDGES_SIZE, EDGES_BATCH = 256, 8          # EdgeConnect's, the cell's
EDGES_TRAIN_ITERS = 4
EDGES_ARGV = ["--backend", "edgeconnect", "--device", "cuda",
              "--data_dir", "data_real_h2h", "--act_dir", FIVEK_ACTS,
              "--glove_path", FIVEK_GLOVE_NPY,
              "--num_iters", str(EDGES_TRAIN_ITERS), "--print_every", "2",
              "--run_dir", EDGES_DIR]


def edges_phase():
    """The hysteresis kernel (csrc/hysteresis.cu) at the EdgeConnect
    cell's shape, b8 x 256²: on every committed GIER image (resized to 256
    by the trainers' reader, gray on the card) the kernel's edges equal
    the plain flood fill's on the same classes and `edge_maps` equals the
    host's `canny_edges` pixel for pixel (the card test holds it on
    stress classes); one launch a call; the kernel's call and device
    time, the plain version's call time and the bound of the bytes it
    must move; then `train-inpaint --backend edgeconnect` at 256², b8, for
    a few iterations: finite losses, one launch an edge map (each
    iteration's and each held-out batch's), its three checkpoint files
    read back by `load_edgeconnect` and its fill finite."""
    from t2onet_tpu_torch.cli import train_inpaint
    from t2onet_tpu_torch.data.fivek import load_train_img
    from t2onet_tpu_torch.models import edgeconnect
    from t2onet_tpu_torch.train.edgeconnect import CHECKPOINTS

    paths = sorted(os.listdir(GIER_IMAGES))
    imgs = np.stack([load_train_img(os.path.join(GIER_IMAGES, f),
                                    EDGES_SIZE, np.uint8) for f in paths])
    reset_launches()
    calls = off_kernel = off_canny = edge_px = 0
    first = None
    t0 = time.perf_counter()
    for at in range(0, len(imgs), EDGES_BATCH):
        img = torch.from_numpy(imgs[at:at + EDGES_BATCH]).cuda().float() \
            / 255.0
        gray = edgeconnect.image_gray(img)
        cls = edgeconnect.canny_classes(gray)
        got = hysteresis.hysteresis(cls)
        off_kernel += int((got != hysteresis.hysteresis_reference(cls))
                          .sum())
        edges = edgeconnect.edge_maps(gray).cpu().numpy()
        calls += 2
        want = np.stack([edgeconnect.canny_edges(g)
                         for g in gray.cpu().numpy()])
        off_canny += int((edges != want).sum())
        edge_px += int(want.sum())
        if first is None:
            first = (gray, cls)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    launches = hysteresis.LAUNCHES["hysteresis"]
    log(f"edges: {len(imgs)} GIER images at {EDGES_SIZE}² in batches of "
        f"{EDGES_BATCH} ({edge_px} edge pixels): kernel vs flood fill "
        f"{off_kernel} pixels apart, edge_maps vs canny_edges {off_canny}; "
        f"{launches} launches for {calls} calls ({check_s:.1f} s host "
        f"clock)")
    if off_kernel or off_canny or launches != calls:
        fail(f"the hysteresis kernel: {off_kernel} / {off_canny} pixels "
             f"off, {launches} launches for {calls}")

    # timing at b8 x 256² on the first batch's classes
    gray, cls = first
    n_px = cls.numel()
    call = statistics.median(time_ms(lambda: hysteresis.hysteresis(cls)))
    dev = statistics.median(device_ms(hysteresis.hysteresis,
                                      rotations((cls,), n_px)))
    plain = statistics.median(time_ms(
        lambda: hysteresis.hysteresis_reference(cls), warmup=1, iters=5))
    canny = statistics.median(time_ms(lambda: edgeconnect.edge_maps(gray)))
    bound = 2 * n_px / PEAK_BYTES_S * 1e3
    log(f"  hysteresis at b{cls.shape[0]} x {EDGES_SIZE}²: kernel "
        f"{call:.4f} ms call, {dev:.4f} ms device (a graph of 40 calls); "
        f"plain flood fill {plain:.4f} ms call; bound {bound:.6f} ms "
        f"(bytes: a byte of classes read, a byte of edges written a "
        f"pixel); edge_maps (gray to edges) {canny:.4f} ms call")

    # the trainer through its CLI, and its checkpoints read back
    shutil.rmtree(EDGES_DIR, ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    state, held = train_inpaint.main(EDGES_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_launches = hysteresis.LAUNCHES["hysteresis"]
    want = EDGES_TRAIN_ITERS + train_inpaint.N_EVAL
    losses = [v for _, _, v in logged_losses(
        os.path.join(EDGES_DIR, "inpaint.jsonl"), ("edgeconnect_G_loss",))]
    ckpt = os.path.join(EDGES_DIR, "edgeconnect_model")
    hole = np.zeros((EDGES_SIZE, EDGES_SIZE), np.float32)
    hole[64:192, 64:192] = 1.0
    fill = edgeconnect.load_edgeconnect(
        os.path.join(ckpt, CHECKPOINTS[0]), os.path.join(ckpt, CHECKPOINTS[1]),
        hole, device="cuda")
    filled = fill(torch.from_numpy(imgs[:EDGES_BATCH]).cuda().float() / 255.0)
    filled_ok = tuple(filled.shape) == (EDGES_BATCH, 3, EDGES_SIZE,
                                        EDGES_SIZE) and bool(
        torch.isfinite(filled).all())
    log(f"  train-inpaint --backend edgeconnect: {EDGES_TRAIN_ITERS} "
        f"iterations at b{EDGES_BATCH} x {EDGES_SIZE}² in {wall:.2f} s (host "
        f"clock, set-up and the held-out batches included), steps "
        f"{state.stats['steps']}, logged G losses {losses}, held-out {held}; "
        f"{train_launches} hysteresis launches (want {want}: each "
        f"iteration's and each held-out batch's edges); its files "
        f"{sorted(os.listdir(ckpt))} read back by load_edgeconnect, its "
        f"fill of {EDGES_BATCH} GIER images finite: {filled_ok}")
    if state.stats["steps"] != EDGES_TRAIN_ITERS or not losses \
            or not all(math.isfinite(v) for v in losses) \
            or train_launches != want or any(chain.LAUNCHES.values()) \
            or sorted(os.listdir(ckpt)) != sorted(CHECKPOINTS) \
            or not filled_ok:
        fail(f"train-inpaint --backend edgeconnect: steps "
             f"{state.stats['steps']}, losses {losses}, {train_launches} "
             f"hysteresis launches, chain {dict(chain.LAUNCHES)}")
    return {"images": len(imgs), "edge_pixels": edge_px,
            "pixels_off": off_kernel + off_canny,
            "launches": launches, "ms": call, "device_ms": dev,
            "plain_ms": plain, "bound_ms": bound, "edge_maps_ms": canny,
            "train_s": wall, "train_launches": train_launches,
            "train_losses": losses, "held_out": held}


PHASES = {"4b": eval_chain_phase, "serve_pipeline": serve_pipeline_phase,
          "http": http_phase, "inpaint": inpaint_phase,
          "demo_plan": demo_plan_phase, "gan": gan_phase,
          "gan_plan": gan_plan_phase, "fid": fid_phase,
          "pix2pixhd": pix2pixhd_phase, "dp": dp_phase,
          "mesh_serve": mesh_serve_phase, "mesh_plan": mesh_plan_phase,
          "ops_extra": ops_extra_phase, "convert": convert_phase,
          "supervisor": supervisor_phase, "tp_heads": tp_heads_phase,
          "edges": edges_phase}


def run_phases(names):
    """The named phases alone, in PHASES' order, after phases 1-3; their
    results as one JSON line, then the card's name and power limit."""
    unknown = set(names) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}: want some of {list(PHASES)}")
    smi = device_phase()
    build_phase()
    host_packages_phase()
    if "demo_plan" in names:
        from t2onet_tpu_torch.cli import test_fivek

        write_eval_checkpoint(test_fivek, FIVEK_EVAL_ARGV)
    res = {}
    for name, fn in PHASES.items():
        if name in names:
            t0 = time.perf_counter()
            res[name] = fn()
            res[name + "_s"] = time.perf_counter() - t0
            log(f"phase {name}: {res[name + '_s']:.1f} s")
    print(json.dumps(res, default=str))
    print(smi)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            fail(f"usage: chip_smoke.py [--phases {','.join(PHASES)}]")
        return run_phases(argv[1].split(","))
    smi = device_phase()
    build_phase()
    host_packages_phase()
    k = kernel_phase()
    ek = eval_chain_phase()
    sb = step_kernel_phase()
    mc = masked_chain_phase()
    ms = masked_step_phase()
    slots = slot_phase()
    chain_slots = chain_slot_phase()
    serve_launches = serve_phase()
    state, train_launches = train_phase()
    t = train_timing_phase(state)
    card_vs_cpu_phase()
    del state
    gstate, gier_launches = gier_train_phase()
    gt = gier_timing_phase(gstate)
    gier_card_vs_cpu_phase()
    del gstate
    from t2onet_tpu_torch.cli import test_fivek, test_gier

    fe = eval_phase("FiveK", test_fivek, FIVEK_EVAL_ARGV, 50)
    ge = eval_phase("GIER", test_gier, GIER_EVAL_ARGV, 57)
    pf = plan_fivek_phase()
    pg = plan_gier_phase()
    rstate, real_launches = fivek_real_train_phase()
    rt = fivek_real_timing_phase(rstate)
    del rstate
    rc = fivek_real_card_vs_cpu_phase()
    mb = mode_batches()
    modes = {name: mode_phase(name, flags, mb) for name, flags in MODES}
    modes["bf16_vs_f32"] = bf16_vs_f32_phase(mb)
    for name, flags in MODES:
        modes[name]["card_vs_cpu"] = mode_card_vs_cpu_phase(name, flags)
    gm = gier_modes_phase()
    r50 = serve_r50_phase()
    rlr = rl_phase(mb)
    del mb
    sp = serve_pipeline_phase()
    hp = http_phase()
    ip = inpaint_phase()
    dp = demo_plan_phase()
    gn = gan_phase()
    gp = gan_plan_phase()
    fd = fid_phase()
    p2p = pix2pixhd_phase()
    dpr = dp_phase()
    msv = mesh_serve_phase()
    mpl = mesh_plan_phase()
    ox = ops_extra_phase()
    cv = convert_phase()
    sup = supervisor_phase()
    tp = tp_heads_phase()
    ed = edges_phase()
    # the planner runs no kernel: phases 14-15 checked that every count
    # stayed 0 (pf["launches"], pg["launches"])
    plan = {"plan_fivek": pf["launches"], "plan_gier": pg["launches"]}
    # the modes' paths: each mode's FiveK run, GIER in bf16 with a
    # probe, serving the depth-50 actor, the RL trainer
    new = {f"mode_{name}": modes[name]["launches"] for name, _ in MODES}
    new.update(gier_modes=gm["launches"], serve_r50=r50["launches"],
               rl=rlr["launches"])
    # this slice's paths: the batcher, HTTP, the bench CLI, the filler's
    # trainer (no kernel), the demo's rollout, planning with the filler
    # (no kernel)
    new.update(serve_batcher=sp["launches"], serve_http=hp["launches"],
               serve_bench=hp["bench_launches"], train_inpaint=ip["launches"],
               demo=dp["launches"], plan_gier_inpaint=dp["plan_launches"])
    # the GAN half's paths: the GAN trainer (its rollouts and validation),
    # the disc planner (no kernel), the eval with FID
    new.update(train_gan=gn["launches"], plan_fivek_disc=gp["launches"],
               fid_eval=fd["launches"])
    # data parallelism: the trainer as rank 0 of an NCCL world of 1, two
    # gloo ranks' steps on one card (both ranks' launches), the sharded
    # chain, the mesh engine, the mesh planner (no kernel)
    new.update(
        dp_nccl_train=dpr["nccl"]["launches"],
        dp_gloo_two_ranks=dpr["gloo"]["launches"],
        mesh_chain={k: msv["launches"].get(k, 0) for k in chain.LAUNCHES},
        mesh_serve={k: msv["serve_launches"] if k == "chain" else 0
                    for k in chain.LAUNCHES},
        mesh_plan={k: 0 for k in chain.LAUNCHES})
    # the last slice: the converted run's eval, the supervised trainer's
    # resumed run, the tensor-parallel steps (both ranks' launches)
    new.update(convert_eval=cv["launches"], supervisor_train=sup["launches"],
               tp_heads=tp["launches"])
    chain_by_path = {"serve": serve_launches,
                     "train": train_launches["chain"],
                     "gier_train": gier_launches["chain"],
                     "fivek_eval": fe["launches"],
                     "gier_eval": ge["launches"], **plan,
                     "fivek_real_train": real_launches["chain"],
                     **{k: v["chain"] for k, v in new.items()}}
    step_by_path = {"serve": 0, "train": train_launches["step_bwd"],
                    "gier_train": gier_launches["step_bwd"],
                    "fivek_eval": 0, "gier_eval": 0, **plan,
                    "fivek_real_train": real_launches["step_bwd"],
                    **{k: v["step_bwd"] for k, v in new.items()}}
    masked_by_path = {
        kind: {"serve": 0, "train": 0, "gier_train": gier_launches[kind],
               "fivek_eval": 0, "gier_eval": 0, **plan,
               "fivek_real_train": 0,
               **{k: v[kind] for k, v in new.items()}}
        for kind in ("chain_masked", "step_bwd_masked")}
    kernels = {"kernels": [{
        "name": "chain", "route": "cuda",
        "source": "t2onet_tpu_torch/csrc/chain.cu",
        "replaces": "t2onet_tpu/ops/pallas_fused.py:270",
        "launches": sum(chain_by_path.values()),
        "launches_by_path": chain_by_path,
        "max_abs_err": max(k["max_abs_err"], ek["max_abs_err"]),
        "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
        "library_ms": None, "device_ms": k["device_ms"],
        **{key: k[key] for key in k if key.endswith(("_serve", "_k1"))},
        "eval_b1_k1_slots": ek["rows"],
        "eval_b10_600_k1_probe": ek["probe"],
        "eval_b1_640_k1_per_fivek_pair": fe["b1_per_pair"],
        "eval_b1_640_k1_per_gier_pair": ge["b1_per_pair"],
        "demo_b1_600_k1_slots": ek["demo_rows"]}, {
        "name": "chain_masked", "route": "cuda",
        "source": "t2onet_tpu_torch/csrc/chain.cu",
        "replaces": "t2onet_tpu/ops/pallas_fused.py:286",
        "launches": sum(masked_by_path["chain_masked"].values()),
        "launches_by_path": masked_by_path["chain_masked"],
        "max_abs_err": mc["max_abs_err"],
        "ms": mc["ms"], "kernel_ms": mc["ms"], "plain_ms": mc["plain_ms"],
        "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
        "library_ms": None,
        "ms_b64_128_k1": mc["ms_b64_128_k1"],
        "plain_ms_b64_128_k1": mc["plain_ms_b64_128_k1"],
        "bound_ms_b64_128_k1": mc["bound_ms_b64_128_k1"],
        "device_ms": mc["device_ms"],
        "device_ms_b64_128_k1": mc["device_ms_b64_128_k1"]}, {
        "name": "step_bwd", "route": "cuda",
        "source": "t2onet_tpu_torch/csrc/step_bwd.cu",
        "replaces": "t2onet_tpu/ops/pallas_fused.py:402",
        "launches": sum(step_by_path.values()),
        "launches_by_path": step_by_path,
        "max_abs_err": sb["max_abs_err"],
        "d_params_rel_err": sb["param_rel_err"],
        "ms": sb["ms"], "kernel_ms": sb["ms"], "plain_ms": sb["plain_ms"],
        "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
        "library_ms": None,
        "ms_b128_512": sb["ms_b128_512"],
        "plain_ms_b128_512": sb["plain_ms_b128_512"],
        "bound_ms_b128_512": sb["bound_ms_b128_512"],
        "device_ms": sb["device_ms"],
        "device_ms_b128_512": sb["device_ms_b128_512"]}, {
        "name": "step_bwd_masked", "route": "cuda",
        "source": "t2onet_tpu_torch/csrc/step_bwd.cu",
        "replaces": "t2onet_tpu/ops/pallas_fused.py:409",
        "launches": sum(masked_by_path["step_bwd_masked"].values()),
        "launches_by_path": masked_by_path["step_bwd_masked"],
        "max_abs_err": ms["max_abs_err"],
        "d_params_rel_err": ms["param_rel_err"],
        "ms": ms["ms"], "kernel_ms": ms["ms"], "plain_ms": ms["plain_ms"],
        "bound_ms": ms["bound_ms"], "bound_by": ms["bound_by"],
        "library_ms": None,
        "ms_b128_512": ms["ms_b128_512"],
        "plain_ms_b128_512": ms["plain_ms_b128_512"],
        "bound_ms_b128_512": ms["bound_ms_b128_512"],
        "device_ms": ms["device_ms"],
        "device_ms_b128_512": ms["device_ms_b128_512"]}, {
        "name": "hysteresis", "route": "cuda",
        "source": "t2onet_tpu_torch/csrc/hysteresis.cu",
        # no TPU kernel: the JAX package's canny labels on the host
        "replaces": "t2onet_tpu/models/edgeconnect.py:220",
        "launches": ed["launches"] + ed["train_launches"] + sum(
            dp["hysteresis_launches"].values()),
        "launches_by_path": {"edges_b8_256": ed["launches"],
                             "train_inpaint_edgeconnect":
                                 ed["train_launches"],
                             **{f"demo_{k}": v for k, v in
                                dp["hysteresis_launches"].items()}},
        "max_abs_err": ed["pixels_off"],
        "ms": ed["ms"], "kernel_ms": ed["ms"], "plain_ms": ed["plain_ms"],
        "bound_ms": ed["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "device_ms": ed["device_ms"]}],
        "step_bwd_slots_b64_128": slots, "chain_slots": chain_slots,
        "train": t, "gier_train": gt, "fivek_eval": fe, "gier_eval": ge,
        "plan_fivek": pf, "plan_gier": pg,
        "fivek_real_train": {**rt, "card_vs_cpu": rc},
        "modes": modes, "gier_modes": gm, "serve_r50": r50, "rl": rlr,
        "serve_pipeline": sp, "serve_http": {k: v for k, v in hp.items()
                                             if k != "bench"},
        "serve_bench": hp["bench"], "inpaint": ip, "demo_plan": dp,
        "gan": gn, "gan_plan": gp, "fid": fd, "pix2pixhd": p2p,
        "dp": dpr, "mesh_serve": msv, "mesh_plan": mpl,
        "ops_extra": ox, "convert": cv, "supervisor": sup, "tp_heads": tp,
        "edges": ed}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
