"""The discriminator's and the condition encoder's weights, made on the
device from the run's seed as `weights.make_weights` makes the actor's:
one uniform and one normal draw from a `torch.Generator` cut and scaled
by `reference.gan.disc_specs`. The generator's seed is the run's seed
plus 7, as the training CLI seeds its discriminator apart from the
actor."""

from __future__ import annotations

import torch

from benchmark.reference.gan import disc_specs
from benchmark.weights import _numel


def make_disc_weights(gan: dict, hidden_dim: int, seed: int, device) -> dict:
    """{name: tensor} of every parameter and buffer of the discriminator
    bundle on `device`, f32 (BatchNorm's counters int64)."""
    specs = disc_specs(gan, hidden_dim)
    gen = torch.Generator(device=device).manual_seed(
        (seed + 7) & (2 ** 63 - 1))
    n = sum(_numel(shape) for _, shape, init in specs
            if init[0] == "uniform")
    uniform = torch.rand(n, generator=gen, device=device)
    at = 0
    out = {}
    for name, shape, (kind, value) in specs:
        if kind == "uniform":
            k = _numel(shape)
            out[name] = ((uniform[at:at + k] * 2.0 - 1.0) * value).view(shape)
            at += k
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out
