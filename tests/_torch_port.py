"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
seeded inputs made with numpy, and one random init carried from the JAX
actor into the port's through `t2onet_tpu_torch.convert`."""

import os

import numpy as np

_IMAGES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data_real_h2h", "FiveK", "images")
# FiveK JPEGs holding exact 0 and 255 values (and mid-gray 127/128)
JPEGS = ("2340_B.jpg", "2546_E.jpg", "0092_E.jpg")


def uniform_images(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (b, 3, h, w)).astype(np.float32)


def jpeg_images(h, w, names=JPEGS):
    """(len(names), 3, h, w) f32 crops of real FiveK pixels, / 255."""
    from PIL import Image

    out = []
    for name in names:
        with Image.open(os.path.join(_IMAGES, name)) as im:
            a = np.asarray(im.convert("RGB"), np.float32) / 255.0
        a = np.tile(a, (-(-h // a.shape[0]), -(-w // a.shape[1]), 1))
        out.append(a[:h, :w].transpose(2, 0, 1))
    return np.ascontiguousarray(np.stack(out))


def fixtures(b, h, w, seed=0):
    """Both fixture kinds, by name."""
    return {"uniform": uniform_images(b, h, w, seed),
            "jpeg": jpeg_images(h, w, JPEGS[:b] if b <= 3 else
                                (JPEGS * b)[:b])}


def tie_images(b, h, w):
    """JPEG crops (`jpeg_images`, cycled to b) with patches where JAX's
    and torch's gradient tie rules differ: exact black and white pixels,
    gray pixels (three equal channels) and pixels whose two largest
    channels are equal. Needs h, w >= 8."""
    out = np.concatenate([jpeg_images(h, w)] * (-(-b // 3)))[:b].copy()
    out[:, :, 0:2, 0:2] = 0.0                   # black
    out[:, :, 2:4, 0:2] = 1.0                   # white
    out[:, :, 4:6, 0:2] = 128.0 / 255.0         # gray
    out[:, 0, 6:8, 0:2] = 200.0 / 255.0         # r == g > b
    out[:, 1, 6:8, 0:2] = 200.0 / 255.0
    out[:, 2, 6:8, 0:2] = 40.0 / 255.0
    return out


def _draw(path, shape, rng):
    """A seeded draw at the scale of torch's default init for the leaf."""
    name = path[-1]
    if name == "embedding":
        return rng.normal(0.0, 1.0, shape)
    if name in ("kernel", "w1", "w2"):
        fan_in = int(np.prod(shape[1:-1] if name != "kernel" else shape[:-1]))
    elif name in ("w_ih", "w_hh"):
        fan_in = shape[1] // 4
    else:                                   # biases
        fan_in = 100
    lim = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-lim, lim, shape)


def _fill(tree, stats, path, rng):
    out = {}
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            out[key] = _fill(sub, stats.get(key, {}) if stats else {},
                             path + (key,), rng)
        elif key == "scale":
            out[key] = rng.uniform(0.8, 1.2, sub.shape)
        elif key == "bias" and stats and "mean" in stats:
            out[key] = rng.normal(0.0, 0.1, sub.shape)
        else:
            out[key] = _draw(path + (key,), sub.shape, rng)
    return out


def _bn_stats(stats, rng):
    out = {}
    for key in sorted(stats):
        sub = stats[key]
        if "mean" in sub:
            n = sub["mean"].shape
            out[key] = {"mean": rng.normal(0.0, 0.1, n),
                        "var": rng.uniform(0.5, 1.5, n)}
        else:
            out[key] = _bn_stats(sub, rng)
    return out


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def jax_actor(cfg, vocab_size, x, img, seed=0, knots_near_one=False):
    """A JAX Actor and numpy variables for it: the variable tree is the
    one `Actor.init` makes (traced with eval_shape, which takes about a
    second where running the init takes tens), the values are seeded
    numpy draws at torch-default scales, and every BatchNorm gets a
    non-trivial scale, bias, mean and var so that the weights bridge is
    tested on each. The heads' fc2 columns past each op's parameter count
    are never read and the port has none: they are zero.

    knots_near_one adds 1 to the color and tone heads' fc2 bias, so the
    curve knots sit near 1 as a trained model's do (tone range 0.5-2,
    color 0.9-1.1). Random heads put them near 0, where the curve's
    division by the knot sum magnifies f32 rounding past 1e-5."""
    import jax
    import jax.numpy as jnp

    from t2onet_tpu.config import OperatorConfig
    from t2onet_tpu.models.actor import Actor
    from t2onet_tpu.ops.operators import PARAM_COUNTS

    actor = Actor(cfg=cfg, opcfg=OperatorConfig(), vocab_size=vocab_size)
    shapes = jax.eval_shape(actor.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(x), jnp.asarray(img))
    shapes = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes)
    shapes = {k: dict(v) for k, v in dict(shapes).items()}
    rng = np.random.default_rng(seed)
    stats = _f32(_bn_stats(_unfreeze(shapes["batch_stats"]), rng))
    params = _f32(_fill(_unfreeze(shapes["params"]), stats, (), rng))
    for i, k in enumerate(PARAM_COUNTS):
        params["heads"]["w2"][i, :, k:] = 0.0
        params["heads"]["b2"][i, k:] = 0.0
    if knots_near_one:
        params["heads"]["b2"][3, :24] += 1.0          # color
        params["heads"]["b2"][5, :8] += 1.0           # tone
    return actor, params, stats


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return tree


def port_actor(cfg, vocab_size, params, stats):
    """The port's Actor at the same config, loaded from JAX variables."""
    import dataclasses

    import torch

    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.convert import load_jax_variables
    from t2onet_tpu_torch.models.actor import Actor

    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    actor = Actor(pcfg, OperatorConfig(), vocab_size,
                  generator=torch.Generator().manual_seed(0))
    load_jax_variables(actor, params, stats)
    return actor.eval()
