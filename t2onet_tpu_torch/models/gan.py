"""T2ONet+D: the text-conditioned multiscale PatchGAN discriminator and
the GAN losses (counterpart of `t2onet_tpu.models.gan`; reference
models/seq2seqGAN/networks.py:69-111, 294-424 and seq2seqGAN.py:71-117).

The generator is the Actor itself: its rollout image at <END>. The same
layers make pix2pixHD's discriminator (`cond_nc=0, norm="instance"`:
no sentence code, no extra stride-1 layer, instance norms), which
`train.pix2pixhd` trains beside the LocalEnhancer. Modules
keep the reference checkpoint's names, so a reference seq2seqGAN
`model.pth` loads by its own keys (`convert.load_torch_gan_checkpoint`):
`netD.scale{i}_layer{j}.{0,1}` (the conv, then the BatchNorm where the
layer has one) and `cond_encoder.fc.{0,1}` (Linear, BatchNorm1d).
`scale{num_D-1}` sees the full-resolution input.

BatchNorm follows the JAX package's trainer: the losses normalise with
the current batch's statistics, and the running averages move once an
iteration, in one train-mode forward on the real pair
(`DiscBundle.update_stats`). So the discriminator's BatchNorms keep
their running averages through an ordinary train-mode forward
(`_GatedBatchNorm`); eval mode uses them, as the planner's distance
does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from t2onet_tpu_torch.models.common import FlaxBatchNorm1d, FlaxBatchNorm2d


class _GatedBatchNorm:
    """A flax-statistics BatchNorm whose train-mode forward moves the
    running averages only inside `updating_stats`."""

    update_running = False

    def forward(self, x):
        if self.training and not self.update_running:
            return self._train_forward(x, update=False)
        return super().forward(x)


class GatedBatchNorm1d(_GatedBatchNorm, FlaxBatchNorm1d):
    pass


class GatedBatchNorm2d(_GatedBatchNorm, FlaxBatchNorm2d):
    pass


@contextlib.contextmanager
def updating_stats(module: nn.Module):
    """Train-mode forwards inside move the running averages of every
    gated BatchNorm of `module` (flax's momentum 0.9)."""
    gated = [m for m in module.modules() if isinstance(m, _GatedBatchNorm)]
    for m in gated:
        m.update_running = True
    try:
        yield
    finally:
        for m in gated:
            m.update_running = False


class ConditionEncoding(nn.Module):
    """Flattened encoder hidden (n_layers x 2H) -> Linear -> BatchNorm1d
    -> leaky ReLU 0.2: the sentence code (networks.py:294-306)."""

    def __init__(self, hidden_dim: int, cond_nc: int = 512):
        super().__init__()
        self.cond_nc = cond_nc
        self.fc = nn.Sequential(nn.Linear(hidden_dim, cond_nc),
                                GatedBatchNorm1d(cond_nc, eps=1e-5),
                                nn.LeakyReLU(0.2))

    def forward(self, hidden):
        """hidden (n_layers, B, 2H), the directions concatenated (the
        encoder's layout) -> (B, cond_nc)."""
        return self.fc(hidden.transpose(0, 1).reshape(hidden.shape[1], -1))


def _layer(cin, cout, stride, norm=None, act=True):
    mods = [nn.Conv2d(cin, cout, 4, stride, padding=2)]
    if norm == "batch":
        mods.append(GatedBatchNorm2d(cout, eps=1e-5))
    elif norm == "instance":
        mods.append(nn.InstanceNorm2d(cout, affine=False, eps=1e-5))
    elif norm is not None:
        raise ValueError(f"unknown norm {norm!r} (want batch | instance)")
    if act:
        mods.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*mods)


def discriminator_layers(input_nc: int = 6, cond_nc: int = 512,
                         ndf: int = 64, n_layers: int = 3,
                         norm: str = "batch") -> List[nn.Module]:
    """The layers of one PatchGAN: 4x4 convs with padding 2, stride 2 for
    the first n_layers, 1-channel logits last; the first and the last
    layer have no norm. With a sentence code (cond_nc > 0) T2ONet+D's
    n_layers + 3 (networks.py:359-424): the code concatenated before
    layer n_layers and an extra nf -> nf layer after it. With cond_nc 0
    pix2pixHD's NLayerDiscriminator (NVIDIA/pix2pixHD
    models/networks.py), n_layers + 2 layers. norm: "batch" (the gated
    BatchNorm) or "instance" (InstanceNorm2d without affine, pix2pixHD's
    --norm instance)."""
    nf = ndf
    layers = [_layer(input_nc, nf, 2)]
    for _ in range(1, n_layers):
        prev, nf = nf, min(nf * 2, 512)
        layers.append(_layer(prev, nf, 2, norm))
    prev, nf = nf, min(nf * 2, 512)
    layers.append(_layer(prev + cond_nc, nf, 1, norm))
    if cond_nc:
        layers.append(_layer(nf, nf, 1, norm))
    layers.append(_layer(nf, 1, 1, act=False))
    return layers


def _patchgan(layers: Sequence[nn.Module], x, cond, n_layers: int,
              use_sigmoid: bool) -> List[torch.Tensor]:
    """Every layer's output, the patch logits last; a sentence code, where
    there is one, is broadcast over the map and concatenated before layer
    n_layers."""
    feats = []
    h = x
    for j, layer in enumerate(layers):
        if j == n_layers and cond is not None:
            b, _, hh, ww = h.shape
            cmap = cond[:, :, None, None].expand(b, cond.shape[1], hh, ww)
            h = torch.cat([h, cmap], dim=1)
        h = layer(h)
        feats.append(h)
    if use_sigmoid:
        feats[-1] = torch.sigmoid(feats[-1])
    return feats


def avg_pool_3s2(x):
    """AvgPool2d(3, stride 2, pad 1, count_include_pad=False)
    (networks.py:327), NCHW."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    """num_D PatchGANs over average-pooled scales (networks.py:309-356).
    forward returns one feature list a scale, the full resolution first.
    cond_nc and norm as `discriminator_layers`."""

    def __init__(self, input_nc: int = 6, cond_nc: int = 512, ndf: int = 64,
                 n_layers: int = 3, num_D: int = 2, use_sigmoid: bool = False,
                 norm: str = "batch"):
        super().__init__()
        self.n_layers = n_layers
        self.num_D = num_D
        self.use_sigmoid = use_sigmoid
        for i in range(num_D):
            layers = discriminator_layers(input_nc, cond_nc, ndf, n_layers,
                                          norm)
            for j, layer in enumerate(layers):
                setattr(self, f"scale{i}_layer{j}", layer)
        self.depth = len(layers)

    def scale_layers(self, i: int) -> List[nn.Module]:
        return [getattr(self, f"scale{i}_layer{j}")
                for j in range(self.depth)]

    def forward(self, x, cond=None) -> List[List[torch.Tensor]]:
        """x (B, input_nc, H, W) source and image; cond (B, cond_nc), or
        None without a sentence code."""
        results = []
        cur = x
        for i in range(self.num_D):
            results.append(_patchgan(self.scale_layers(self.num_D - 1 - i),
                                     cur, cond, self.n_layers,
                                     self.use_sigmoid))
            if i != self.num_D - 1:
                cur = avg_pool_3s2(cur)
        return results


class DiscBundle(nn.Module):
    """The discriminator and the condition encoder under one state_dict,
    in the reference model.pth's names (`netD.*`, `cond_encoder.*`)."""

    def __init__(self, hidden_dim: int, cond_nc: int = 512, ndf: int = 64,
                 n_layers: int = 3, num_D: int = 2):
        super().__init__()
        self.netD = MultiscaleDiscriminator(6, cond_nc, ndf, n_layers, num_D)
        self.cond_encoder = ConditionEncoding(hidden_dim, cond_nc)

    def forward(self, x6, hidden):
        """The multiscale predictions for (x6, the encoder hidden)."""
        return self.netD(x6, self.cond_encoder(hidden))

    @torch.no_grad()
    def update_stats(self, x6, hidden):
        """One train-mode forward that moves every running average once
        (flax momentum 0.9), so that checkpoints carry eval-mode
        statistics for the planner's distance."""
        mode = self.training
        self.train()
        with updating_stats(self):
            self(x6, hidden)
        self.train(mode)


def gan_loss(preds: Sequence[Sequence[torch.Tensor]], target_is_real: bool,
             use_lsgan: bool = True) -> torch.Tensor:
    """LSGAN MSE (or BCE with logits) on the last map of every scale
    (networks.py:101-111)."""
    target = 1.0 if target_is_real else 0.0
    total = 0.0
    for scale in preds:
        pred = scale[-1]
        if use_lsgan:
            total = total + ((pred - target) ** 2).mean()
        else:
            total = total + F.binary_cross_entropy_with_logits(
                pred, torch.full_like(pred, target))
    return total


def feature_matching_loss(pred_fake, pred_real, n_layers: int = 3,
                          num_D: int = 2, lambda_feat: float = 10.0):
    """L1 between the discriminator's features of the fake and of the
    (detached) real pair (seq2seqGAN.py:103-110)."""
    feat_w = 4.0 / (n_layers + 1)
    d_w = 1.0 / num_D
    loss = 0.0
    for i in range(num_D):
        for j in range(len(pred_fake[i]) - 1):
            loss = loss + d_w * feat_w * (
                pred_fake[i][j] - pred_real[i][j].detach()).abs().mean() \
                * lambda_feat
    return loss


class Seq2SeqGANLosses:
    """The loss terms of one GAN iteration (seq2seqGAN.py:71-117)."""

    def __init__(self, n_layers: int = 3, num_D: int = 2,
                 use_lsgan: bool = True, lambda_feat: float = 10.0,
                 use_gan_feat: bool = True,
                 perceptual_fn: Optional[Callable] = None):
        self.n_layers = n_layers
        self.num_D = num_D
        self.use_lsgan = use_lsgan
        self.lambda_feat = lambda_feat
        self.use_gan_feat = use_gan_feat
        self.perceptual_fn = perceptual_fn

    def __call__(self, disc, src_img, fake_img, trg_img, cond,
                 pseudo_real=None, parts: str = "all"):
        """dict(G_GAN, G_GAN_Feat, G_VGG, D_real, D_fake).

        disc(x (B,6,H,W), cond) -> one feature list a scale.
        pseudo_real: an optional planner image taken as a second real
        (the AdaptGAN variant, seq2seqAdaptGAN.py:85-111).
        parts: 'all', 'g' (the G terms only: no detached-fake pass) or
        'd' (the D terms only: no gradient-carrying fake pass); the
        terms left out are zeros."""
        z = src_img.new_zeros(())
        d_fake = d_real = g_gan = g_feat = g_vgg = z
        pred_real = None
        if parts in ("all", "d"):
            pred_fake_pool = disc(torch.cat([src_img, fake_img.detach()], 1),
                                  cond)
            d_fake = gan_loss(pred_fake_pool, False, self.use_lsgan)
        if parts in ("all", "d") or self.use_gan_feat:
            pred_real = disc(torch.cat([src_img, trg_img], 1), cond)
        if parts in ("all", "d"):
            d_real = gan_loss(pred_real, True, self.use_lsgan)
            if pseudo_real is not None:
                pred_pseudo = disc(torch.cat([src_img, pseudo_real], 1),
                                   cond)
                d_real = 0.5 * (d_real + gan_loss(pred_pseudo, True,
                                                  self.use_lsgan))
        if parts in ("all", "g"):
            pred_fake = disc(torch.cat([src_img, fake_img], 1), cond.detach())
            g_gan = gan_loss(pred_fake, True, self.use_lsgan)
            if self.use_gan_feat:
                g_feat = feature_matching_loss(pred_fake, pred_real,
                                               self.n_layers, self.num_D,
                                               self.lambda_feat)
            if self.perceptual_fn is not None:
                g_vgg = self.perceptual_fn(fake_img, trg_img) \
                    * self.lambda_feat
        return {"G_GAN": g_gan, "G_GAN_Feat": g_feat, "G_VGG": g_vgg,
                "D_real": d_real, "D_fake": d_fake}


def disc_dists(disc, img1, img2, cond) -> torch.Tensor:
    """(B,) of 1 - sigmoid(mean patch logit over the scales), the
    planner's candidate distance."""
    preds = disc(torch.cat([img1, img2], 1), cond)
    per = [p[-1].mean(dim=tuple(range(1, p[-1].ndim))) for p in preds]
    return 1.0 - torch.sigmoid(torch.stack(per).mean(dim=0))


def disc_score(disc, img1, img2, cond) -> torch.Tensor:
    """The scalar realism score (reference seq2seqGANDisc.py:71-80,
    beam_search.py:190-193): 1 - sigmoid(mean patch logit)."""
    preds = disc(torch.cat([img1, img2], 1), cond)
    score = torch.stack([p[-1].mean() for p in preds]).mean()
    return 1.0 - torch.sigmoid(score)


def make_disc_planner_score(disc):
    """The planner's score_fn for dist_type 'seq2seqGAN-disc'
    (`planner.fit.fit_op_params_scored*`): a candidate is scored by how
    real the (source, edited) pair looks to the discriminator, not by
    its distance to a target (reference beam_search.py:226-236). As in
    the JAX package, the fit scores the image the edit is applied to.

    :param disc: (x6 (B,6,H,W), cond (B,cond_nc)) -> multiscale preds,
        in eval mode for the planner.
    :return: score_fn(outs (N,C,3,H,W), (I0 (N,3,H,W), cond (N,cond_nc)))
        -> (N, C) distances in [0, 1].
    """
    def score_fn(outs, aux):
        i0, cond = aux
        n, c = outs.shape[:2]
        h, w = outs.shape[-2:]
        i0_b = i0[:, None].expand(n, c, 3, h, w).reshape(n * c, 3, h, w)
        cond_b = cond[:, None].expand(n, c, cond.shape[-1]).reshape(
            n * c, -1)
        return disc_dists(disc, i0_b, outs.reshape(n * c, 3, h, w),
                          cond_b).reshape(n, c)

    return score_fn
