"""pix2pixHD's FLOPs, counted from shapes as `flops` counts the actor's:
2 for each multiply-add of every convolution and transposed convolution;
the element-wise work (instance norm, activations, pads, pooling, the
losses' means) left out. A transposed convolution counts cin * cout * k^2
for each input pixel.

One iteration on b pairs of h x w:
- G (the LocalEnhancer): a forward, and a backward with every layer's
  weight gradient and every layer's input gradient but those of the
  convs on the input (the global generator's first, on the pooled input,
  and each enhancer's first): their inputs need none;
- D, each of its three passes at every scale: the detached fake's and
  the target's, each a forward, every weight gradient and the input
  gradient of every layer but the first; the fake's (G's loss), a
  forward and every layer's input gradient, the first's too (the fake
  needs it), and no weight gradient (D's is not taken there);
- VGG19 (frozen) to relu5_1, 13 convs: the fake's pass, a forward and
  every layer's input gradient; the target's, a forward.
"""

from __future__ import annotations

from benchmark.flops import conv
from benchmark.flops_edgeconnect import vgg_layers

VGG_CONVS = 13                    # conv1_1 .. conv5_1: relu5_1 is the last


def _half(x: int) -> int:
    """The side after a 3x3 stride-2 conv with padding 1, or after the
    3x3 stride-2 average pool with padding 1."""
    return (x - 1) // 2 + 1


def generator_layers(o: dict, h: int, w: int):
    """[(is a conv on the input, FLOPs)] of each conv of one image's G
    forward; o holds ngf, n_downsample_global, n_blocks_global,
    n_local_enhancers, n_blocks_local."""
    n_le, nd = o["n_local_enhancers"], o["n_downsample_global"]
    sizes = [(h, w)]
    for _ in range(n_le):
        sizes.append((_half(sizes[-1][0]), _half(sizes[-1][1])))
    ngf = o["ngf"] * 2 ** n_le
    hh, ww = sizes[-1]
    out = [(True, conv(3, ngf, 7, hh, ww))]
    for i in range(nd):
        hh, ww = _half(hh), _half(ww)
        out.append((False, conv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, hh,
                                ww)))
    width = ngf * 2 ** nd
    out += [(False, conv(width, width, 3, hh, ww))] * (
        2 * o["n_blocks_global"])
    for i in range(nd):
        mult = 2 ** (nd - i)
        out.append((False, conv(ngf * mult, ngf * mult // 2, 3, hh, ww)))
        hh, ww = 2 * hh, 2 * ww
    for n in range(1, n_le + 1):
        ngf_l = o["ngf"] * 2 ** (n_le - n)
        hh, ww = sizes[n_le - n]
        out.append((True, conv(3, ngf_l, 7, hh, ww)))
        h2, w2 = _half(hh), _half(ww)
        out.append((False, conv(ngf_l, 2 * ngf_l, 3, h2, w2)))
        out += [(False, conv(2 * ngf_l, 2 * ngf_l, 3, h2, w2))] * (
            2 * o["n_blocks_local"])
        out.append((False, conv(2 * ngf_l, ngf_l, 3, h2, w2)))
        if n == n_le:
            out.append((False, conv(o["ngf"], 3, 7, hh, ww)))
    return out


def disc_layers(o: dict, h: int, w: int):
    """[(layer index, FLOPs)] of each conv of one pair's pass through the
    multiscale D (4x4, padding 2), every scale; o holds ndf, n_layers_D,
    num_D."""
    nf, n = o["ndf"], o["n_layers_D"]
    widths = [(6, nf, 2)]
    for _ in range(1, n):
        prev, nf = nf, min(nf * 2, 512)
        widths.append((prev, nf, 2))
    prev, nf = nf, min(nf * 2, 512)
    widths += [(prev, nf, 1), (nf, 1, 1)]
    out = []
    for _ in range(o["num_D"]):
        hh, ww = h, w
        for j, (cin, cout, stride) in enumerate(widths):
            hh, ww = hh // stride + 1, ww // stride + 1
            out.append((j, conv(cin, cout, 4, hh, ww)))
        h, w = _half(h), _half(w)
    return out


def step(o: dict, b: int, h: int, w: int) -> dict:
    """One iteration's FLOPs by part: {"gen", "disc", "vgg"}."""
    g = generator_layers(o, h, w)
    g_fwd = sum(f for _, f in g)
    g_first = sum(f for first, f in g if first)
    d = disc_layers(o, h, w)
    d_fwd = sum(f for _, f in d)
    d_first = sum(f for j, f in d if j == 0)
    v_fwd = sum(vgg_layers(h, w)[:VGG_CONVS])
    return {"gen": b * (3 * g_fwd - g_first),
            "disc": b * (2 * (3 * d_fwd - d_first) + 2 * d_fwd),
            "vgg": b * 3 * v_fwd}


def step_flops(o: dict, b: int, h: int, w: int) -> int:
    return sum(step(o, b, h, w).values())
