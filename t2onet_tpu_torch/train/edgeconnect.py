"""EdgeConnect's inpainting stage (MODEL 3 of github.com/knazeri/edge-connect,
`src/edge_connect.py` and `src/models.py:InpaintingModel`), trained on the
port: the inpaint operator slot's EdgeConnect filler.

Per batch of images (B, 3, H, W) in [0, 1] and masks (B, 1, H, W), 1 =
hole, `edgeconnect_inpaint_step` runs:
- the edges (`train.inpaint.edges`): gray (`image_gray`), canny with
  sigma 2 on the card (`edge_maps`), the edge G in train mode and
  without a gradient on [gray*(1-m)+m, edges*(1-m), m] (one power
  iteration of each spectral-normed layer), and the composed edges
  pred*m + edges*(1-m);
- G's update (`train.inpaint.gen`): the inpaint G on [img*(1-m)+m,
  edges]; D's three power iterations of the iteration (its passes on the
  real images, on the detached fakes and on G's output, in that order);
  G's loss 0.1*BCE(D(out), 1) + L1(out, img)/mean(m) + 0.1*perceptual +
  250*style through D's weights as they are, D taking no gradient; G's
  backward and Adam;
- D's update (`train.inpaint.disc`): (BCE(D(img), 1) + BCE(D(out.detach()),
  0)) / 2 with the first two power iterations' vectors; D's backward and
  Adam.

The numbers are EdgeConnect's: its `backward` steps D and then G, and G's
gradient reaches D's weights before D's step only through the pass that
G's loss takes, so taking G's update first (D's weights unchanged by it)
gives the same values; current PyTorch would refuse the original order
(D's step changes weights that G's backward needs). The losses are
EdgeConnect's `src/loss.py`: the perceptual loss the L1 means of VGG19's
relu1_1..relu5_1 of the output against the target's, weights 1; the
style loss the L1 means of the Gram matrices f fT / (h w ch) of relu2_2,
relu3_4, relu4_4 and relu5_2, of out*m against img*m; the VGG reads the
[0, 1] images as they are and is frozen.

`mask4` draws EdgeConnect's MASK 4 (an external mask or a random block
of half the side, even odds); `save_edgeconnect` writes EdgeConnect's
checkpoint files, which `models.edgeconnect.load_edgeconnect` (and so
`plan_gier --edgeconnect_dir`, `demo --edgeconnect_dir`) read.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from t2onet_tpu_torch.models.edgeconnect import (Discriminator, EdgeGenerator,
                                                 InpaintGenerator, edge_maps,
                                                 image_gray)
from t2onet_tpu_torch.models.vgg import Vgg19Features
from t2onet_tpu_torch.train.loop import adam_step
from t2onet_tpu_torch.utils.profiling import span

# config.yml.example: L1_LOSS_WEIGHT, INPAINT_ADV_LOSS_WEIGHT,
# CONTENT_LOSS_WEIGHT, STYLE_LOSS_WEIGHT; BETA1, BETA2; D2G_LR; SIGMA
LOSS_WEIGHTS = {"l1": 1.0, "adv": 0.1, "content": 0.1, "style": 250.0}
BETAS = (0.0, 0.9)
D2G_LR = 0.1
SIGMA = 2.0
PERCEPTUAL_TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
STYLE_TAPS = ("relu2_2", "relu3_4", "relu4_4", "relu5_2")
VGG_END = 32                      # features.31 is relu5_2, the deepest tap
INIT_GAIN = 0.02                  # BaseNetwork.init_weights('normal', 0.02)
CHECKPOINTS = ("EdgeModel_gen.pth", "InpaintingModel_gen.pth",
               "InpaintingModel_dis.pth")


def init_weights(module: nn.Module, gain: float = INIT_GAIN) -> nn.Module:
    """EdgeConnect's init: every conv's (and transposed conv's) weight,
    `weight_orig` of a spectral-normed one, N(0, gain), biases 0, from
    torch's global generator."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight_orig if hasattr(m, "weight_orig") else m.weight
                w.normal_(0.0, gain)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def build_networks(seed: int):
    """(edge G in its training form, inpaint G, D, the frozen VGG19), each
    drawn with EdgeConnect's init from `seed`, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = (EdgeGenerator(spectral=True), InpaintGenerator(),
                Discriminator(), Vgg19Features(VGG_END))
        for n in nets:
            init_weights(n)
    return nets


class EdgeConnectState:
    """The networks and the two Adams of EdgeConnect's inpainting stage:
    the edge G (spectral-normed, in train mode, never stepped), the
    inpaint G and its Adam (lr, BETAS), D and its Adam (lr * D2G_LR), and
    the frozen VGG19 of the perceptual and style losses. `stats["steps"]`
    counts the iterations taken, always on."""

    def __init__(self, edge_g: EdgeGenerator, inpaint_g: InpaintGenerator,
                 disc: Discriminator, vgg: Vgg19Features, lr: float = 1e-4):
        self.edge_g, self.inpaint_g, self.disc = edge_g, inpaint_g, disc
        self.vgg = vgg.eval().requires_grad_(False)
        edge_g.requires_grad_(False)
        self.g_params = list(inpaint_g.parameters())
        self.d_params = list(disc.parameters())
        self.g_opt = torch.optim.Adam(self.g_params, lr=lr, betas=BETAS)
        self.d_opt = torch.optim.Adam(self.d_params, lr=lr * D2G_LR,
                                      betas=BETAS)
        self.stats = {"steps": 0}


def nsgan_loss(outputs, real: bool):
    """EdgeConnect's AdversarialLoss('nsgan'): BCE of D's sigmoid outputs
    against all-ones (real) or all-zeros."""
    return F.binary_cross_entropy(outputs, torch.full_like(
        outputs, 1.0 if real else 0.0))


def gram(x):
    b, ch, h, w = x.shape
    f = x.reshape(b, ch, h * w)
    return f.bmm(f.transpose(1, 2)) / (h * w * ch)


def perceptual_loss(vgg, x, y):
    fx = vgg.taps(x, PERCEPTUAL_TAPS)
    with torch.no_grad():
        fy = vgg.taps(y, PERCEPTUAL_TAPS)
    loss = 0.0
    for n in PERCEPTUAL_TAPS:
        loss = loss + F.l1_loss(fx[n], fy[n])
    return loss


def style_loss(vgg, x, y):
    fx = vgg.taps(x, STYLE_TAPS)
    with torch.no_grad():
        gy = {n: gram(v) for n, v in vgg.taps(y, STYLE_TAPS).items()}
    loss = 0.0
    for n in STYLE_TAPS:
        loss = loss + F.l1_loss(gram(fx[n]), gy[n])
    return loss


@torch.no_grad()
def composed_edges(state: EdgeConnectState, img, m):
    """The inpaint G's edge channel: the edge G's prediction in the hole,
    canny's edges outside it (B, 1, H, W)."""
    gray = image_gray(img)[:, None]
    edges = edge_maps(gray[:, 0], SIGMA)[:, None]
    pred = state.edge_g(torch.cat([gray * (1 - m) + m, edges * (1 - m), m],
                                  1))
    return pred * m + edges * (1 - m)


def edgeconnect_inpaint_step(state: EdgeConnectState, batch):
    """One iteration of the inpainting stage (the module's docstring).
    batch: "images" (B, 3, H, W) and "masks" (B, 1, H, W) on the nets'
    device. Returns the losses as tensors on the device: G_loss and its
    four weighted terms G_adv, G_l1, G_content, G_style, and D_loss."""
    with span("train.step", kind="inpaint", step=state.stats["steps"] + 1):
        img, m = batch["images"], batch["masks"]
        state.edge_g.train()
        state.inpaint_g.train()
        state.disc.train()
        w = LOSS_WEIGHTS
        with span("train.inpaint.edges"):
            edges = composed_edges(state, img, m)
        with span("train.inpaint.gen"):
            with span("train.forward"):
                out = state.inpaint_g(torch.cat([img * (1 - m) + m, edges],
                                                1))
                # D's passes in EdgeConnect's order: real, fake, G's
                uvs = [state.disc.power_iterations() for _ in range(3)]
                state.disc.requires_grad_(False)
                try:
                    gen_fake, _ = state.disc(out, uvs[2])
                finally:
                    state.disc.requires_grad_(True)
                terms = {
                    "G_adv": nsgan_loss(gen_fake, True) * w["adv"],
                    "G_l1": F.l1_loss(out, img) * w["l1"] / torch.mean(m),
                    "G_content": perceptual_loss(state.vgg, out, img)
                    * w["content"],
                    "G_style": style_loss(state.vgg, out * m, img * m)
                    * w["style"]}
                g_loss = (terms["G_adv"] + terms["G_l1"] + terms["G_content"]
                          + terms["G_style"])
            adam_step(state.g_opt, state.g_params, g_loss)
        with span("train.inpaint.disc"):
            with span("train.forward"):
                real, _ = state.disc(img, uvs[0])
                fake, _ = state.disc(out.detach(), uvs[1])
                d_loss = (nsgan_loss(real, True) + nsgan_loss(fake, False)) / 2
            adam_step(state.d_opt, state.d_params, d_loss)
        state.stats["steps"] += 1
        return {"G_loss": g_loss.detach(), "D_loss": d_loss.detach(),
                **{k: v.detach() for k, v in terms.items()}}


def random_block(rng, size: int) -> np.ndarray:
    """EdgeConnect's create_mask: a block of half the side at a uniform
    place, (size, size) float32, 1 = hole."""
    half = size // 2
    y, x = rng.integers(0, size - half + 1, size=2)
    out = np.zeros((size, size), np.float32)
    out[y:y + half, x:x + half] = 1.0
    return out


def mask4(rng, n: int, size: int, external) -> np.ndarray:
    """EdgeConnect's MASK 4 for n images: for each, even odds of one of
    the `external` masks ((N, size, size) in {0, 1}, drawn uniformly) or
    a random block of half the side. -> (n, 1, size, size) float32."""
    out = np.empty((n, 1, size, size), np.float32)
    for i in range(n):
        if rng.binomial(1, 0.5):
            out[i, 0] = random_block(rng, size)
        else:
            out[i, 0] = external[rng.integers(len(external))]
    return out


def _cpu(sd):
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_edgeconnect(out_dir: str, state: EdgeConnectState,
                     iteration: int) -> None:
    """EdgeConnect's checkpoints in its layout: `EdgeModel_gen.pth` and
    `InpaintingModel_gen.pth` ({'iteration', 'generator'}),
    `InpaintingModel_dis.pth` ({'discriminator'})."""
    os.makedirs(out_dir, exist_ok=True)
    edge, gen, dis = (os.path.join(out_dir, f) for f in CHECKPOINTS)
    torch.save({"iteration": iteration,
                "generator": _cpu(state.edge_g.state_dict())}, edge)
    torch.save({"iteration": iteration,
                "generator": _cpu(state.inpaint_g.state_dict())}, gen)
    torch.save({"discriminator": _cpu(state.disc.state_dict())}, dis)
