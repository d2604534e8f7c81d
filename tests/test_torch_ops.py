"""The port's operator math and executor bank (t2onet_tpu_torch.ops)
against the JAX package's, on the same seeded inputs: uniform-random
images and real FiveK JPEG pixels (exact 0, 1 and mid-gray). Budget
1e-5: both sides compute in f32, and the only differences are the
order of sums and the ulp of cos/tanh."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from t2onet_tpu.config import OperatorConfig as JOperatorConfig
from t2onet_tpu.ops import bank as jbank
from t2onet_tpu.ops import color as jcolor
from t2onet_tpu.ops import operators as jops
from t2onet_tpu_torch.config import OperatorConfig
from t2onet_tpu_torch.ops import bank, color, operators as ops
from tests._torch_port import fixtures

torch.set_num_threads(2)

ATOL = 1e-5
B, H, W = 3, 24, 40
KINDS = ("uniform", "jpeg")


@pytest.fixture(scope="module")
def imgs():
    return fixtures(B, H, W, seed=0)


def _params(name, seed=1):
    """Per-op parameters in each op's own range; curve knots keep their
    sum away from 0."""
    rng = np.random.default_rng(seed)
    if name in ("color", "tone"):
        k = 24 if name == "color" else 8
        return rng.uniform(0.5, 2.0, (B, k)).astype(np.float32)
    if name == "sharpness":
        return rng.uniform(0.0, 1.5, (B, 1)).astype(np.float32)
    return rng.uniform(-0.8, 0.8, (B, 1)).astype(np.float32)


_PORT_FN = {"brightness": ops.brightness, "contrast": ops.contrast,
            "saturation": ops.saturation, "color": ops.color_curve,
            "tone": ops.tone_curve, "sharpness": ops.sharpness,
            "white": ops.white, "inpaint": ops.inpaint}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(_PORT_FN))
def test_op_matches_jax(imgs, name, kind):
    img = imgs[kind]
    p = _params(name)
    expect = np.asarray(jops.OP_FNS[name](jnp.asarray(img), jnp.asarray(p)))
    got = _PORT_FN[name](torch.from_numpy(img), torch.from_numpy(p)).numpy()
    assert got.shape == expect.shape
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_mask_blend_matches_jax(imgs, kind):
    img = imgs[kind]
    rng = np.random.default_rng(2)
    out = (img * 1.7 - 0.3).astype(np.float32)           # overshoots [0, 1]
    mask = rng.uniform(0, 1, (B, 1, H, W)).astype(np.float32)
    for m in (None, mask):
        expect = np.asarray(jops.mask_blend(
            jnp.asarray(out), jnp.asarray(img),
            None if m is None else jnp.asarray(m)))
        got = ops.mask_blend(torch.from_numpy(out), torch.from_numpy(img),
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=0)


def test_color_helpers_match_jax(imgs):
    img = imgs["jpeg"]
    np.testing.assert_allclose(
        color.rgb2lum(torch.from_numpy(img)).numpy(),
        np.asarray(jcolor.rgb2lum(jnp.asarray(img))), atol=ATOL, rtol=0)
    x = np.linspace(-3, 3, 41, dtype=np.float32)
    for lo, hi, init in ((-2.0, 2.0, 0.0), (0.5, 2.0, None)):
        np.testing.assert_allclose(
            color.tanh_range(lo, hi, init)(torch.from_numpy(x)).numpy(),
            np.asarray(jcolor.tanh_range(lo, hi, init)(jnp.asarray(x))),
            atol=ATOL, rtol=0)


def _heads(ctx=20, fc=12, seed=3):
    rng = np.random.default_rng(seed)
    w1 = rng.uniform(-0.3, 0.3, (8, ctx, fc)).astype(np.float32)
    b1 = rng.uniform(-0.3, 0.3, (8, fc)).astype(np.float32)
    w2 = rng.uniform(-0.3, 0.3, (8, fc, 24)).astype(np.float32)
    b2 = rng.uniform(-0.3, 0.3, (8, 24)).astype(np.float32)
    context = rng.normal(0, 1, (5, ctx)).astype(np.float32)
    return (w1, b1, w2, b2), context


def test_raw_head_features_and_squash_match_jax():
    heads, context = _heads()
    raw_j = jbank.raw_head_features(
        jbank.HeadParams(*map(jnp.asarray, heads)), jnp.asarray(context))
    raw_t = bank.raw_head_features(*map(torch.from_numpy, heads),
                                   torch.from_numpy(context))
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=ATOL,
                               rtol=0)
    sq_j = jbank.squash_params(raw_j, JOperatorConfig())
    sq_t = bank.squash_params(raw_t, OperatorConfig())
    np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), atol=ATOL,
                               rtol=0)


def _bank_inputs(seed=4):
    """One of each vocab id 0..10 over 11 images (specials and all 8 ops)."""
    rng = np.random.default_rng(seed)
    ids = (np.arange(11) % 11).astype(np.int64)
    per_op = rng.uniform(0.5, 1.5, (11, 8, 24)).astype(np.float32)
    shared = rng.uniform(0.5, 1.5, (11, 24)).astype(np.float32)
    mask = rng.uniform(0, 1, (11, 1, H, W)).astype(np.float32)
    return ids, per_op, shared, mask


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shared_row", (False, True))
def test_execute_bank_matches_jax(imgs, kind, shared_row):
    ids, per_op, shared, mask = _bank_inputs()
    img = np.concatenate([imgs[kind]] * 4)[:11]
    params = shared if shared_row else per_op
    for m in (None, mask):
        out_j, chosen_j = jbank.execute_bank(
            jnp.asarray(img), jnp.asarray(ids.astype(np.int32)),
            jnp.asarray(params), None if m is None else jnp.asarray(m))
        out_t, chosen_t = bank.execute_bank(
            torch.from_numpy(img), torch.from_numpy(ids),
            torch.from_numpy(params),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(chosen_t.numpy(), np.asarray(chosen_j),
                                   atol=0, rtol=0)
        # identity slots (ids < 3) return the input bit for bit
        np.testing.assert_array_equal(out_t.numpy()[:3], img[:3])


def test_select_params_and_onehot_match_jax():
    ids, per_op, _, _ = _bank_inputs()
    np.testing.assert_array_equal(
        bank.vocab_onehot(torch.from_numpy(ids)).numpy(),
        np.asarray(jbank.vocab_onehot(jnp.asarray(ids))))
    np.testing.assert_array_equal(
        bank.select_params(torch.from_numpy(ids),
                           torch.from_numpy(per_op)).numpy(),
        np.asarray(jbank.select_params(jnp.asarray(ids),
                                       jnp.asarray(per_op))))
