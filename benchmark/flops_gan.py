"""T2ONet+D's discriminator FLOPs, counted from shapes as `flops` counts
the actor's: 2 for each multiply-add of every convolution and linear
layer, the element-wise work (BatchNorm, activations, pooling, the
losses) left out.

A GAN iteration runs the discriminator (`reference.gan.widths`) on b
pairs:
- G's update: forwards on the real and the fake pair, then the fake's
  backward for the input gradient of every layer (D is frozen, so no
  weight gradient): three forwards;
- D's update: forwards on the detached fake and the real pair, each
  backward with every weight gradient and the input gradient of every
  layer but the first (the pair needs none; the sentence code does):
  six forwards less two first layers;
- the statistics update: one forward.
The condition encoder's Linear runs forward in each of the three, and
takes its weight gradient in D's update (the hidden state carries no
gradient).
"""

from __future__ import annotations

from benchmark.flops import conv, linear
from benchmark.reference.gan import widths


def _conv_out(x: int, stride: int) -> int:
    """A 4x4 padding-2 convolution's output side."""
    return x // stride + 1


def _pool_out(x: int) -> int:
    """AvgPool2d(3, 2, 1)'s output side."""
    return (x - 1) // 2 + 1


def disc_layers(gan: dict, h: int, w: int):
    """[(scale index in the forward, layer, FLOPs)] of one pair's forward
    through the multiscale discriminator, the full resolution first."""
    out = []
    for i in range(gan["num_D"]):
        hh, ww = h, w
        for j, (cin, cout, stride, _) in enumerate(widths(gan)):
            hh, ww = _conv_out(hh, stride), _conv_out(ww, stride)
            out.append((i, j, conv(cin, cout, 4, hh, ww)))
        h, w = _pool_out(h), _pool_out(w)
    return out


def disc_forward(gan: dict, h: int, w: int) -> int:
    """One (source, image) pair's forward through the discriminator."""
    return sum(f for _, _, f in disc_layers(gan, h, w))


def updates(gan: dict, b: int, h: int, w: int, hidden_dim: int) -> dict:
    """The discriminator's FLOPs in each part of a GAN iteration on b
    pairs: {"g_update", "d_update", "stat_update"}."""
    fwd = disc_forward(gan, h, w)
    first = sum(f for _, j, f in disc_layers(gan, h, w) if j == 0)
    cond = linear(hidden_dim, gan["cond_nc"])
    return {"g_update": b * (3 * fwd + cond),
            "d_update": b * (6 * fwd - 2 * first + 2 * cond),
            "stat_update": b * (fwd + cond)}
