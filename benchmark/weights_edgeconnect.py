"""EdgeConnect's weights, made on the device from the run's seed with
EdgeConnect's init (`BaseNetwork.init_weights('normal', 0.02)`): every
conv's weight (a spectral-normed one's `weight_orig`) N(0, 0.02), every
bias 0, and each spectral-normed layer's u and v a normal draw
normalised, as torch's `spectral_norm` starts them. VGG19's convs are
drawn the same way (no pretrained weights are in the repository). The
draws come from one `torch.Generator` on the device, seeded with the
run's seed plus 11, in the order of `reference.edgeconnect`'s specs:
the edge G, the inpaint G, D, the VGG. The same seed gives the same
weights, and the same dicts feed the system and the reference."""

from __future__ import annotations

import torch

from benchmark.reference import edgeconnect as R

GAIN = 0.02
PARTS = ("edge", "inpaint", "disc", "vgg")


def specs(part: str):
    if part in ("edge", "inpaint"):
        return R.generator_specs(part)
    return R.disc_specs() if part == "disc" else R.vgg_specs()


def make_edgeconnect_weights(seed: int, device) -> dict:
    """{part: {name: tensor}} for the parts of `PARTS`, f32 on `device`,
    named as the system's state_dicts name them (D's `features.0.*`, the
    second name of `conv1.0`, included)."""
    gen = torch.Generator(device=device).manual_seed(
        (seed + 11) & (2 ** 63 - 1))
    out = {}
    for part in PARTS:
        w = {}
        for name, shape, kind in specs(part):
            if kind == "zero":
                w[name] = torch.zeros(shape, device=device)
                continue
            x = torch.randn(shape, generator=gen, device=device)
            w[name] = x * GAIN if kind == "weight" else R._normalize(x)
        out[part] = w
    out["disc"].update({n.replace("conv1.", "features.", 1): v
                        for n, v in list(out["disc"].items())
                        if n.startswith("conv1.")})
    return out


def copy(weights: dict) -> dict:
    """A deep copy: the reference updates its dicts in place."""
    return {part: {n: t.detach().clone() for n, t in w.items()}
            for part, w in weights.items()}
