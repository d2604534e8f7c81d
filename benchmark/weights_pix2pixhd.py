"""pix2pixHD's weights, made on the device from the run's seed with
pix2pixHD's init (`weights_init`): every conv's and transposed conv's
weight N(0, 0.02); every bias as torch's default init draws it, uniform
within 1/sqrt(fan_in) (a transposed conv's fan_in is its output channels
times k^2, as torch computes it). VGG19's convs are drawn the same way
(no pretrained weights are in the repository). The draws come from one
`torch.Generator` on the device, seeded with the run's seed plus 13, in
the order of `reference.pix2pixhd`'s specs: G, D, the VGG. The same seed
gives the same weights, and the same dicts feed the system and the
reference."""

from __future__ import annotations

import math

import torch

from benchmark.reference import pix2pixhd as R

STD = 0.02
PARTS = ("gen", "disc", "vgg")


def options(model: dict) -> dict:
    """The reference's options (G's, D's) from the configuration's model."""
    keys = ("ngf", "n_downsample_global", "n_blocks_global",
            "n_local_enhancers", "n_blocks_local", "ndf", "n_layers_D",
            "num_D")
    return {k: model[k] for k in keys}


def specs(part: str, opts: dict):
    if part == "gen":
        return R.generator_specs(opts)
    return R.disc_specs(opts) if part == "disc" else R.vgg_specs()


def make_pix2pixhd_weights(seed: int, device, opts: dict) -> dict:
    """{part: {name: tensor}} for the parts of `PARTS`, f32 on `device`,
    named as the system's state_dicts name them."""
    gen = torch.Generator(device=device).manual_seed(
        (seed + 13) & (2 ** 63 - 1))
    out = {}
    for part in PARTS:
        w = {}
        for name, shape, fan_in in specs(part, opts):
            if fan_in is None:
                w[name] = torch.randn(shape, generator=gen,
                                      device=device) * STD
            else:
                bound = 1.0 / math.sqrt(fan_in)
                w[name] = (torch.rand(shape, generator=gen, device=device)
                           * 2.0 - 1.0) * bound
        out[part] = w
    return out


def copy(weights: dict) -> dict:
    """A deep copy: the reference updates its dicts in place."""
    return {part: {n: t.detach().clone() for n, t in w.items()}
            for part, w in weights.items()}
