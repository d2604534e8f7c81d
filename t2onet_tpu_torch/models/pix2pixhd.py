"""pix2pixHD's CNN generators: GlobalGenerator, LocalEnhancer and the
instance-feature Encoder (counterpart of `t2onet_tpu.models.pix2pixhd`;
reference models/seq2seqGAN/networks.py:28-41, 130-291).

T2ONet+D does not use them (its generator is the Actor); they complete
the pix2pixHD surface for users who bring pix2pixHD checkpoints or want
a CNN image-to-image baseline, and `train.pix2pixhd` trains the
LocalEnhancer at pix2pixHD's 2048x1024 recipe (`weights_init` is its
init). The modules are the reference's
nn.Sequentials, so a pix2pixHD state_dict loads by its own names
(`model.{idx}`, `model.{idx}.conv_block.{1,5}`, and the enhancer's
`model{n}_1` / `model{n}_2`). Norm is InstanceNorm2d(affine=False),
define_G's only mode: no parameters, per-sample statistics in train and
eval alike.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from t2onet_tpu_torch.models.gan import avg_pool_3s2


def instance_norm(dim: int) -> nn.Module:
    return nn.InstanceNorm2d(dim, affine=False, eps=1e-5)


class ResnetBlock(nn.Module):
    """Reflect-padded 3x3 conv block with a residual (networks.py:216-259):
    conv_block = [pad, conv, norm, relu, pad, conv, norm]."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), instance_norm(dim),
            nn.ReLU(True), nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3),
            instance_norm(dim))

    def forward(self, x):
        return x + self.conv_block(x)


def _down(cin: int, cout: int) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, 3, stride=2, padding=1), instance_norm(cout),
            nn.ReLU(True)]


def _up(cin: int, cout: int) -> List[nn.Module]:
    return [nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                               output_padding=1), instance_norm(cout),
            nn.ReLU(True)]


def _head(cin: int, ngf: int) -> List[nn.Module]:
    return [nn.ReflectionPad2d(3), nn.Conv2d(cin, ngf, 7), instance_norm(ngf),
            nn.ReLU(True)]


def _tail(ngf: int, output_nc: int) -> List[nn.Module]:
    return [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]


def _encoder_decoder(input_nc, output_nc, ngf, n_down, n_blocks):
    """The layers of a GlobalGenerator (and, without blocks, of the
    Encoder): head, n_down stride-2 convs, n_blocks ResnetBlocks, n_down
    transposed convs, the 7x7 tanh tail."""
    layers = _head(input_nc, ngf)
    for i in range(n_down):
        layers += _down(ngf * 2 ** i, ngf * 2 ** (i + 1))
    layers += [ResnetBlock(ngf * 2 ** n_down) for _ in range(n_blocks)]
    for i in range(n_down):
        mult = 2 ** (n_down - i)
        layers += _up(ngf * mult, ngf * mult // 2)
    return layers + _tail(ngf, output_nc)


class GlobalGenerator(nn.Module):
    """The coarse generator (networks.py:185-214): NCHW in, tanh image
    out."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 3, n_blocks: int = 9):
        super().__init__()
        self.model = nn.Sequential(*_encoder_decoder(
            input_nc, output_nc, ngf, n_downsampling, n_blocks))

    def forward(self, x):
        return self.model(x)


class LocalEnhancer(nn.Module):
    """The coarse-to-fine generator (networks.py:130-183): a
    GlobalGenerator without its tail on the input average-pooled
    n_local_enhancers times, and per enhancer a local downsample whose
    output adds the coarser features before its ResnetBlocks and
    upsample."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsample_global: int = 3, n_blocks_global: int = 9,
                 n_local_enhancers: int = 1, n_blocks_local: int = 3):
        super().__init__()
        self.n_local_enhancers = n_local_enhancers
        glob = _encoder_decoder(input_nc, output_nc,
                                ngf * 2 ** n_local_enhancers,
                                n_downsample_global, n_blocks_global)
        self.model = nn.Sequential(*glob[:-3])
        for n in range(1, n_local_enhancers + 1):
            ngf_l = ngf * 2 ** (n_local_enhancers - n)
            down = _head(input_nc, ngf_l) + _down(ngf_l, ngf_l * 2)
            up = [ResnetBlock(ngf_l * 2) for _ in range(n_blocks_local)]
            up += _up(ngf_l * 2, ngf_l)
            if n == n_local_enhancers:
                up += _tail(ngf, output_nc)
            setattr(self, f"model{n}_1", nn.Sequential(*down))
            setattr(self, f"model{n}_2", nn.Sequential(*up))

    def forward(self, x):
        pyramid = [x]
        for _ in range(self.n_local_enhancers):
            pyramid.append(avg_pool_3s2(pyramid[-1]))
        out = self.model(pyramid[-1])
        for n in range(1, self.n_local_enhancers + 1):
            inp = pyramid[self.n_local_enhancers - n]
            out = getattr(self, f"model{n}_2")(
                getattr(self, f"model{n}_1")(inp) + out)
        return out


class Encoder(nn.Module):
    """The instance-feature encoder (networks.py:261-291): conv down and
    up to output_nc feature planes, then each instance's pixels take the
    instance's mean feature, per image and channel. As in the JAX
    package, the `n_instances` smallest distinct ids of an image are
    pooled (ids may be any integers, e.g. class * 1000 + index); pixels
    of further ids read 0."""

    def __init__(self, input_nc: int = 3, output_nc: int = 3, ngf: int = 32,
                 n_downsampling: int = 4, n_instances: int = 32):
        super().__init__()
        self.n_instances = n_instances
        self.model = nn.Sequential(*_encoder_decoder(
            input_nc, output_nc, ngf, n_downsampling, 0))

    def forward(self, x, inst):
        """x (B, C, H, W); inst (B, 1, H, W) or (B, H, W) instance ids."""
        out = self.model(x)
        b, c, h, w = out.shape
        ids = inst.reshape(b, h * w).to(torch.int64)
        pooled = []
        for i in range(b):
            _, slot = torch.unique(ids[i], sorted=True, return_inverse=True)
            keep = slot < self.n_instances
            slot = torch.where(keep, slot, torch.zeros_like(slot))
            feat = out[i].reshape(c, h * w)
            w_keep = keep.to(feat.dtype)
            sums = feat.new_zeros(c, self.n_instances).index_add_(
                1, slot, feat * w_keep)
            counts = feat.new_zeros(self.n_instances).index_add_(
                0, slot, w_keep)
            means = sums / torch.clamp_min(counts, 1.0)
            pooled.append((means[:, slot] * w_keep).reshape(c, h, w))
        return torch.stack(pooled)


INIT_STD = 0.02


def weights_init(module: nn.Module) -> nn.Module:
    """pix2pixHD's weights_init (models/networks.py): every conv's and
    transposed conv's weight N(0, 0.02), every BatchNorm2d's weight
    N(1, 0.02) and bias 0, from torch's global generator; conv biases
    keep torch's default."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.weight.normal_(0.0, INIT_STD)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.normal_(1.0, INIT_STD)
                m.bias.zero_()
    return module


def define_generator(net_g: str = "global", **kw) -> nn.Module:
    """The define_G factory (networks.py:28-41): 'global', 'local' or
    'encoder'."""
    if net_g == "global":
        return GlobalGenerator(**kw)
    if net_g == "local":
        return LocalEnhancer(**kw)
    if net_g == "encoder":
        return Encoder(**kw)
    raise ValueError(f"unknown generator kind {net_g!r} "
                     "(want global | local | encoder)")
