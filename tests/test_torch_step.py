"""The port's differentiable step (t2onet_tpu_torch.ops.step.fused_step)
and the gradients of its operator math, against the JAX package's.

JAX runs on the CPU, `fused_step` in Pallas interpret mode as the JAX
package's own tests run it. Losses are sum-reduced L1, so the cotangents
are +-1, and the images hold the pixels where the frameworks' tie rules
differ (exact 0 and 1, gray, two equal channels: `tie_images`).
Tolerances: d_img 1e-6 absolute (the same f32 operations, in the order of
JAX's reverse pass); d_params rtol 1e-5 / atol 1e-5 against the f64
evaluation of the same JAX branch math, and against JAX's own f32
fused_step within atol 5e-5: JAX sums each image's 192 per-pixel terms in
f32, which at 8x8 errs by up to 2.5e-5 against the f64 sum (measured),
while the port sums them in f64."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from t2onet_tpu.ops import operators as jops
from t2onet_tpu.ops import pallas_fused as jpf
from t2onet_tpu_torch.ops import build, chain, operators as ops, step
from tests._torch_port import tie_images, uniform_images

torch.set_num_threads(2)

H = W = 8
SLOTS = np.arange(9, dtype=np.int32)          # one image per slot 0..8


def _inputs(kind):
    imgs = (tie_images(9, H, W) if kind == "ties"
            else uniform_images(9, H, W, seed=3))
    rng = np.random.default_rng(1)
    params = rng.uniform(0.05, 0.5, (9, 24)).astype(np.float32)
    params[1, 0] = 0.8          # brightness saturates: max channels tie at 1
    gt = rng.uniform(0.0, 1.0, imgs.shape).astype(np.float32)
    return imgs, params, gt


@pytest.fixture(scope="module", params=["uniform", "ties"])
def case(request):
    """Inputs plus JAX's fused_step forward and VJP of sum |out - gt|."""
    imgs, params, gt = _inputs(request.param)

    def loss(i, p):
        out = jpf.fused_step(i, jnp.asarray(SLOTS), p)
        return jnp.abs(out - gt).sum(), out

    (_, out), (gi, gp) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(imgs), jnp.asarray(params))
    return imgs, params, gt, np.asarray(out), np.asarray(gi), np.asarray(gp)


def _port_grads(fn, imgs, params, gt):
    ti = torch.from_numpy(imgs).requires_grad_(True)
    tp = torch.from_numpy(params).requires_grad_(True)
    out = fn(ti, torch.from_numpy(SLOTS), tp)
    (out - torch.from_numpy(gt)).abs().sum().backward()
    return out.detach().numpy(), ti.grad.numpy(), tp.grad.numpy()


def _jax_f64_param_grads(imgs, params, g):
    """d_params of clip(branch(img, p), 0, 1) per image, the branch math
    `_bwd_branches` differentiates, evaluated in f64."""
    out = np.zeros((9, 24))
    with jax.enable_x64(True):
        for i, slot in enumerate(SLOTS):
            if slot in (0, 5):
                continue
            branch = jpf._BRANCHES[slot]

            def f(im, p, branch=branch):
                return jnp.clip(branch(im, [p[j] for j in range(24)]),
                                0.0, 1.0)

            _, vjp = jax.vjp(f, jnp.asarray(imgs[i], jnp.float64),
                             jnp.asarray(params[i], jnp.float64))
            out[i] = np.asarray(vjp(jnp.asarray(g[i], jnp.float64))[1])
    return out


def test_fused_step_forward_and_vjp_match_jax(case):
    imgs, params, gt, out_j, gi_j, gp_j = case
    out, gi, gp = _port_grads(step.fused_step, imgs, params, gt)
    np.testing.assert_allclose(out, out_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gi, gi_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gp, gp_j, atol=5e-5, rtol=1e-5)
    exact = _jax_f64_param_grads(imgs, params, np.sign(out - gt))
    np.testing.assert_allclose(gp, exact, atol=1e-5, rtol=1e-5)
    # identity slots and white pass no gradient to their parameters
    assert not gp[[0, 5, 8]].any() and not gp_j[[0, 5, 8]].any()
    np.testing.assert_array_equal(gi[[0, 5]], np.sign(out - gt)[[0, 5]])
    assert not gi[8].any()


def test_chain_reference_autograd_matches_jax(case):
    """Autograd through the plain chain at K=1 (the forward of fused_step)
    has JAX's tie rules too: clip and the curves' min split ties in half,
    where torch.clamp would pass all of the gradient."""
    imgs, params, gt, out_j, gi_j, gp_j = case

    def chain_k1(i, s, p):
        return chain.fused_chain_reference(i, s[:, None], p[:, None])

    out, gi, gp = _port_grads(chain_k1, imgs, params, gt)
    np.testing.assert_allclose(gi, gi_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gp, gp_j, atol=5e-5, rtol=1e-5)


def test_bwd_reference_matches_autograd_of_forward(case):
    """The written-out VJP against torch autograd of the plain forward:
    two independent derivations of the same gradient."""
    imgs, params, gt = case[:3]
    out = step.fused_step(torch.from_numpy(imgs), torch.from_numpy(SLOTS),
                          torch.from_numpy(params)).numpy()
    g = torch.from_numpy(np.sign(out - gt).astype(np.float32))

    ti = torch.from_numpy(imgs).requires_grad_(True)
    tp = torch.from_numpy(params).requires_grad_(True)
    y = chain.fused_chain_reference(ti, torch.from_numpy(SLOTS)[:, None],
                                    tp[:, None])
    ai, ap = torch.autograd.grad(y, (ti, tp), g)
    ri, rp = step.fused_step_bwd_reference(
        torch.from_numpy(imgs), torch.from_numpy(SLOTS),
        torch.from_numpy(params), g)
    np.testing.assert_allclose(ri.numpy(), ai.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rp.numpy(), ap.numpy(), atol=5e-5, rtol=1e-5)


_OPS = {"brightness": (ops.brightness, jops.brightness, 1),
        "contrast": (ops.contrast, jops.contrast, 1),
        "saturation": (ops.saturation, jops.saturation, 1),
        "color": (ops.color_curve, jops.color_curve, 24),
        "tone": (ops.tone_curve, jops.tone_curve, 8),
        "sharpness": (ops.sharpness, jops.sharpness, 1),
        "white": (ops.white, jops.white, 1)}


@pytest.mark.parametrize("name", sorted(_OPS))
def test_operator_grads_match_jax(name):
    """jax.grad of each bank op, then mask_blend's clamp, against
    torch.autograd of the port's, sum-reduced, on tie-heavy JPEG pixels.
    Brightness runs with p > 0 so that saturated channels land on 1.0."""
    port_fn, jax_fn, k = _OPS[name]
    imgs = tie_images(3, 16, 16)
    rng = np.random.default_rng(4)
    p = (rng.uniform(0.5, 2.0, (3, k)) if k > 1
         else rng.uniform(0.2, 0.8, (3, 1))).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, imgs.shape).astype(np.float32)
    mask = (rng.uniform(0, 1, (3, 1, 16, 16)) > 0.3).astype(np.float32)

    def jloss(i, q):
        out = jops.mask_blend(jax_fn(i, q), i, jnp.asarray(mask))
        return jnp.abs(out - gt).sum()

    gi_j, gp_j = jax.grad(jloss, (0, 1))(jnp.asarray(imgs), jnp.asarray(p))
    ti = torch.from_numpy(imgs).requires_grad_(True)
    tp = torch.from_numpy(p).requires_grad_(True)
    out = ops.mask_blend(port_fn(ti, tp), ti, torch.from_numpy(mask))
    gi, gp = torch.autograd.grad((out - torch.from_numpy(gt)).abs().sum(),
                                 (ti, tp), allow_unused=True)
    np.testing.assert_allclose(gi.numpy(), np.asarray(gi_j), atol=1e-5,
                               rtol=1e-5)
    gp = np.zeros_like(p) if gp is None else gp.numpy()
    np.testing.assert_allclose(gp, np.asarray(gp_j), atol=1e-4, rtol=1e-5)


def test_fused_step_autograd_plumbing():
    imgs, params, gt = _inputs("uniform")
    slots = torch.tensor([-3, 1, 2, 3, 4, 5, 6, 7, 12], dtype=torch.int32)
    before = dict(chain.LAUNCHES)
    # imgs needs no gradient: only d_params comes back
    tp = torch.from_numpy(params).requires_grad_(True)
    out = step.fused_step(torch.from_numpy(imgs), slots, tp)
    out.sum().backward()
    assert tp.grad is not None and tp.grad.shape == (9, 24)
    # out-of-range slots clamp into 0..8, as lax.switch clamps
    np.testing.assert_array_equal(out[0].detach().numpy(), imgs[0])
    assert (out[8] == 1.0).all()
    assert not tp.grad[[0, 8]].any()
    # the plain version ran, so no kernel launch was counted
    assert chain.LAUNCHES == before
    with pytest.raises(ValueError):
        step.step_bwd(*(torch.empty(s, device="meta") for s in
                        ((2, 3, 4, 4), (2,), (2, 24), (2, 3, 4, 4))))


def test_kernel_sources_are_all_built_together():
    assert set(build.sources()) == {"chain", "step_bwd", "hysteresis"}
    assert build.NVCC_FLAGS[:2] == ("-gencode", "arch=compute_90a,code=sm_90a")
    assert "-fmad=false" in build.NVCC_FLAGS
    assert not any("fast" in f for f in build.NVCC_FLAGS)
