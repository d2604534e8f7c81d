"""The actor's weights, made on the device from the run's seed.

One uniform and one normal draw from a `torch.Generator` on the device
cover every parameter, which are then cut and scaled as PyTorch's default
initialisation would draw them (`reference.model.param_specs`). The same
seed gives the same weights, and the same dict feeds the system and the
reference.

A serving mix may set `end_logit_bias`, added to the decoder's output
bias of <END> (`serving_weights`): random weights decode <END> first for
every request on some seeds and long programs on others, so that the
seed would change the work and, where every program is empty, leave the
decode and the chain unchecked. A bias far below the logits' spread
makes every program use each of the configuration's ops once, on every
seed.
"""

from __future__ import annotations

import torch

from benchmark.reference.model import END_ID, param_specs


def make_weights(cfg: dict, vocab_size: int, seed: int, device) -> dict:
    """{name: tensor} of every parameter and buffer on `device`, f32
    (BatchNorm's counters int64)."""
    specs = param_specs(cfg, vocab_size)
    gen = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    numel = {kind: sum(_numel(shape) for _, shape, init in specs
                       if init[0] == kind) for kind in ("uniform", "normal")}
    uniform = torch.rand(numel["uniform"], generator=gen, device=device)
    normal = torch.randn(numel["normal"], generator=gen, device=device)
    at = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, (kind, value) in specs:
        n = _numel(shape)
        if kind == "uniform":
            u = uniform[at[kind]:at[kind] + n]
            out[name] = ((u * 2.0 - 1.0) * value).view(shape)
        elif kind == "normal":
            out[name] = normal[at[kind]:at[kind] + n].view(shape) * value
        elif kind == "const":
            out[name] = torch.full(shape, float(value), device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        at[kind] = at.get(kind, 0) + n
    return out


def serving_weights(cfg: dict, vocab_size: int, seed: int, device,
                    mix: dict) -> dict:
    """`make_weights` with the mix's `end_logit_bias` (default 0)."""
    out = make_weights(cfg, vocab_size, seed, device)
    out["decoder.out_linear.bias"][END_ID] += float(
        mix.get("end_logit_bias", 0.0))
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
