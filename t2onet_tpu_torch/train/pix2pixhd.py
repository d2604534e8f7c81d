"""pix2pixHD (Wang et al., "High-Resolution Image Synthesis and Semantic
Manipulation with Conditional GANs", arXiv:1711.11585;
github.com/NVIDIA/pix2pixHD) trained on the port: its LocalEnhancer G,
its multiscale instance-norm PatchGAN D and its VGG19 loss, at its
2048x1024 recipe (`scripts/train_1024p_24G.sh`: `--netG local --ngf 32
--num_D 3`, the other options at their defaults) with RGB input in place
of label maps (`--label_nc 0 --no_instance`, no feature encoder).

Per batch of input and target images (B, 3, H, W) in [0, 1],
`pix2pixhd_step` runs pix2pixHD's iteration (`pix2pixHD_model.forward`
and `train.py`):
- both images normalised to [-1, 1] ((x - 0.5) / 0.5, its transform);
- G's update (`train.p2p.gen`): fake = G(input); D's three passes, on
  (input, fake detached), (input, target) and (input, fake), the last
  through D's weights as they are with no gradient to them (its gradient
  is zeroed before D's step in pix2pixHD); G's loss LSGAN(D(input,
  fake), real) + feature matching (L1 between D's features of the fake
  and of the target pair, every layer but the logits, weight
  4/(n_layers+1) / num_D, times 10) + VGG (L1 of VGG19's relu1_1 ..
  relu5_1 of the fake against the target's, weights 1/32 .. 1, on the
  [-1, 1] images as they are, times 10); G's backward and Adam;
- D's update (`train.p2p.disc`): (LSGAN(D(input, fake detached), fake)
  + LSGAN(D(input, target), real)) * 0.5 over the passes made before G's
  step; D's backward and Adam.
The image pool is off (`--pool_size 0`, the default). Adam: lr 2e-4,
betas (0.5, 0.999) for both; batch 1.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from t2onet_tpu_torch.models.gan import (MultiscaleDiscriminator,
                                         feature_matching_loss, gan_loss)
from t2onet_tpu_torch.models.pix2pixhd import define_generator, weights_init
from t2onet_tpu_torch.models.vgg import Vgg19Features, make_vgg_loss
from t2onet_tpu_torch.train.loop import adam_step
from t2onet_tpu_torch.utils.profiling import span

# scripts/train_1024p_24G.sh over options/base_options.py and
# options/train_options.py
G_OPTIONS = {"ngf": 32, "n_downsample_global": 4, "n_blocks_global": 9,
             "n_local_enhancers": 1, "n_blocks_local": 3}
D_OPTIONS = {"ndf": 64, "n_layers_D": 3, "num_D": 3}
LR = 2e-4
BETAS = (0.5, 0.999)
LAMBDA_FEAT = 10.0
CHECKPOINTS = ("latest_net_G.pth", "latest_net_D.pth")


def build_networks(seed: int):
    """(G, D, the frozen VGG19) of the 1024p recipe (`G_OPTIONS`,
    `D_OPTIONS`) drawn with pix2pixHD's init from `seed`, on the CPU."""
    d = D_OPTIONS
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = (define_generator("local", **G_OPTIONS),
                MultiscaleDiscriminator(6, 0, d["ndf"], d["n_layers_D"],
                                        d["num_D"], norm="instance"),
                Vgg19Features())
        for n in nets:
            weights_init(n)
    return nets


class Pix2PixHDState:
    """G (a LocalEnhancer) and its Adam, D (a `MultiscaleDiscriminator`
    without a sentence code, instance norms) and its Adam, and the frozen
    VGG19 of the VGG loss. `stats["steps"]` counts the iterations taken,
    always on."""

    def __init__(self, gen: nn.Module, disc: MultiscaleDiscriminator,
                 vgg: Vgg19Features):
        self.gen, self.disc = gen, disc
        self.vgg = vgg.eval()
        self.vgg_loss = make_vgg_loss(self.vgg, imagenet_input=False)
        self.g_params = list(gen.parameters())
        self.d_params = list(disc.parameters())
        self.g_opt = torch.optim.Adam(self.g_params, lr=LR, betas=BETAS)
        self.d_opt = torch.optim.Adam(self.d_params, lr=LR, betas=BETAS)
        self.stats = {"steps": 0}


def normalize(img):
    """[0, 1] -> [-1, 1], pix2pixHD's Normalize((0.5,) * 3, (0.5,) * 3)."""
    return (img - 0.5) / 0.5


def pix2pixhd_step(state: Pix2PixHDState, batch):
    """One iteration (the module's docstring). batch: "label" (the input)
    and "image" (the target), (B, 3, H, W) in [0, 1] on the nets' device.
    Returns the losses as tensors on the device: G_loss and its terms
    G_GAN, G_GAN_Feat, G_VGG; D_loss and its terms D_real, D_fake."""
    with span("train.step", kind="pix2pixhd", step=state.stats["steps"] + 1):
        label, real = normalize(batch["label"]), normalize(batch["image"])
        disc = state.disc
        state.gen.train()
        disc.train()
        with span("train.p2p.gen"):
            with span("train.forward"):
                fake = state.gen(label)
                pred_fake_pool = disc(torch.cat([label, fake.detach()], 1))
                pred_real = disc(torch.cat([label, real], 1))
                disc.requires_grad_(False)
                try:
                    pred_fake = disc(torch.cat([label, fake], 1))
                finally:
                    disc.requires_grad_(True)
                terms = {
                    "G_GAN": gan_loss(pred_fake, True),
                    "G_GAN_Feat": feature_matching_loss(
                        pred_fake, pred_real, disc.n_layers, disc.num_D,
                        LAMBDA_FEAT),
                    "G_VGG": state.vgg_loss(fake, real) * LAMBDA_FEAT}
                g_loss = terms["G_GAN"] + terms["G_GAN_Feat"] \
                    + terms["G_VGG"]
            adam_step(state.g_opt, state.g_params, g_loss)
        with span("train.p2p.disc"):
            with span("train.forward"):
                terms["D_fake"] = gan_loss(pred_fake_pool, False)
                terms["D_real"] = gan_loss(pred_real, True)
                d_loss = (terms["D_fake"] + terms["D_real"]) * 0.5
            adam_step(state.d_opt, state.d_params, d_loss)
        state.stats["steps"] += 1
        return {"G_loss": g_loss.detach(), "D_loss": d_loss.detach(),
                **{k: v.detach() for k, v in terms.items()}}


def pair_batches(labels: np.ndarray, images: np.ndarray, rng):
    """Endless batches of one pair, the recipe's batch: the pairs in an
    order drawn from `rng`, epoch after epoch, each flipped horizontally
    with even odds (pix2pixHD's default flip, one draw for both images).
    labels, images: (N, 3, H, W) arrays of one dtype."""
    while True:
        for i in rng.permutation(len(labels)):
            lab, img = labels[i:i + 1], images[i:i + 1]
            if rng.random() < 0.5:
                lab, img = lab[..., ::-1], img[..., ::-1]
            yield {"label": lab, "image": img}


def save_pix2pixhd(out_dir: str, state: Pix2PixHDState) -> None:
    """pix2pixHD's checkpoint files: `latest_net_G.pth` and
    `latest_net_D.pth`, each a state_dict in its names."""
    os.makedirs(out_dir, exist_ok=True)
    for name, net in zip(CHECKPOINTS, (state.gen, state.disc)):
        torch.save({k: v.detach().cpu() for k, v in net.state_dict().items()},
                   os.path.join(out_dir, name))
