"""EdgeConnect's FLOPs and the hysteresis kernel's bytes, counted from
shapes as `flops` counts the actor's: 2 for each multiply-add of every
convolution, transposed convolution and matrix product; the element-wise
work (instance norm, activations, pads, pooling, canny's arithmetic, the
losses' means) left out.

One iteration of the inpainting stage on b images of h x w:
- the edge G: one forward (no gradient);
- the inpaint G: a forward, and a backward with every layer's weight
  gradient and every layer's input gradient but the first's (its input
  needs none);
- D: G's pass, a forward and every layer's input gradient (G's loss
  reaches the fake through it; D takes no weight gradient); D's update,
  two passes (real, fake) each a forward, every weight gradient and the
  input gradient of every layer but the first;
- VGG19 (frozen): the perceptual pair (the output and the target, to
  relu5_1) and the style pair (both masked, to relu5_2), four forwards,
  and the output's two backwards with every layer's input gradient down
  to the image; the style's Gram matrices f f^T of relu2_2, relu3_4,
  relu4_4 and relu5_2 on both sides, and the output side's two products
  in their backward.
A transposed convolution counts cin * cout * k^2 for each input pixel.
"""

from __future__ import annotations

from benchmark.flops import conv

# (cin, cout, k, stride, transposed) of a generator's convs, the first's
# cin set by the caller; sizes follow the 4x4 stride-2 convs and
# upsamples (a 7x7 or 3x3 conv keeps its padded input's size)
_GEN = ((None, 64, 7, 1, False), (64, 128, 4, 2, False),
        (128, 256, 4, 2, False)) + ((256, 256, 3, 1, False),) * 16 + (
        (256, 128, 4, 2, True), (128, 64, 4, 2, True), (64, None, 7, 1, False))
_DISC = ((3, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 1), (512, 1, 1))
# VGG19's convs up to conv5_2 (cin, cout) and the side divisor of each
_VGG = ((3, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 2),
        (128, 256, 4), (256, 256, 4), (256, 256, 4), (256, 256, 4),
        (256, 512, 8), (512, 512, 8), (512, 512, 8), (512, 512, 8),
        (512, 512, 16), (512, 512, 16))
_PERCEPTUAL_CONVS = 13          # conv5_1 feeds relu5_1
_STYLE_GRAMS = ((128, 2), (256, 4), (512, 8), (512, 16))   # (ch, divisor)


def generator_layers(cin: int, cout: int, h: int, w: int):
    """FLOPs of each conv of one image's generator forward."""
    out = []
    for ci, co, k, stride, transposed in _GEN:
        ci, co = ci or cin, co or cout
        if transposed:
            out.append(conv(ci, co, k, h, w))   # over the input's pixels
            h, w = h * stride, w * stride
        else:
            h, w = h // stride, w // stride
            out.append(conv(ci, co, k, h, w))
    return out


def disc_layers(h: int, w: int):
    """FLOPs of each of D's convs (4x4, padding 1) on one image."""
    out = []
    for cin, cout, stride in _DISC:
        h, w = (h + 2 - 4) // stride + 1, (w + 2 - 4) // stride + 1
        out.append(conv(cin, cout, 4, h, w))
    return out


def vgg_layers(h: int, w: int):
    return [conv(ci, co, 3, h // d, w // d) for ci, co, d in _VGG]


def step(b: int, h: int, w: int) -> dict:
    """One iteration's FLOPs by part: {"edge", "gen", "disc", "vgg"}."""
    edge = sum(generator_layers(3, 1, h, w))
    g = generator_layers(4, 3, h, w)
    d = disc_layers(h, w)
    v = vgg_layers(h, w)
    perceptual, style = sum(v[:_PERCEPTUAL_CONVS]), sum(v)
    grams = sum(2 * ch * ch * (h // s) * (w // s) for ch, s in _STYLE_GRAMS)
    return {"edge": b * edge,
            "gen": b * (3 * sum(g) - g[0]),
            "disc": b * (2 * sum(d) + 2 * (3 * sum(d) - d[0])),
            "vgg": b * (3 * perceptual + 3 * style + 4 * grams)}


def step_flops(b: int, h: int, w: int) -> int:
    return sum(step(b, h, w).values())


def hysteresis_call(b: int, h: int, w: int):
    """(bytes, operations) of one call of the hysteresis kernel: a byte
    of classes read and a byte of edges written a pixel (the labels are
    scratch); no floating-point work."""
    return 2 * b * h * w, 0
