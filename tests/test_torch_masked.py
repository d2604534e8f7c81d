"""The port's masked chain, masked fused step and masked bank (GIER's
local edits) against the JAX package's.

JAX runs on the CPU, its Pallas `fused_chain` and `fused_step` in
interpret mode as the JAX package's own tests run them. Each executed
step is clip(op(x)*m + x*(1-m), 0, 1); slots 0 and 5 write nothing.
The masks keep the tie patches of `tie_images` (exact 0 / 1, gray, two
equal channels, columns 0-1) half inside the mask (column 0) and half
outside it (column 1), and put mask edges next to every sharpness pixel.
Tolerances: the chain and the bank 1e-5 (test_torch_chain.py's budget);
the step's d_img 1e-6 absolute, d_params 1e-5 against the f64 evaluation
of the same branch math and 5e-5 against JAX's f32 sums
(test_torch_step.py). Under an all-ones mask the masked functions equal
the unmasked ones bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.ops import bank as jbank
from t2onet_tpu.ops import pallas_fused as jpf
from t2onet_tpu_torch.ops import bank, chain, step
from tests._torch_port import tie_images

torch.set_num_threads(2)

H = W = 8
SLOTS = np.arange(9, dtype=np.int32)          # one image per slot 0..8

_jax_chain = jax.jit(functools.partial(jpf.fused_chain, interpret=True))


def _mask(kind, b, h=H, w=W, seed=0):
    """(b, 1, h, w): binary or fractional, column 0 inside the mask and
    column 1 outside it."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.0, 1.0, (b, 1, h, w))
    if kind == "binary":
        m = (m > 0.5).astype(np.float64)
    m[..., 0] = 1.0
    m[..., 1] = 0.0
    return m.astype(np.float32)


def _step_inputs(kind):
    imgs = tie_images(9, H, W)
    rng = np.random.default_rng(1)
    params = rng.uniform(0.05, 0.5, (9, 24)).astype(np.float32)
    params[1, 0] = 0.8          # brightness saturates: max channels tie at 1
    gt = rng.uniform(0.0, 1.0, imgs.shape).astype(np.float32)
    return imgs, params, gt, _mask(kind, 9, seed=2)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def _chain_case(k):
    """9 images; at K=1 one per slot, at K=3 every slot somewhere and two
    images with two sharpness steps."""
    imgs = tie_images(9, H, W)
    rng = np.random.default_rng(k)
    params = rng.uniform(0.1, 0.6, (9, k, 24)).astype(np.float32)
    if k == 1:
        return imgs, SLOTS[:, None].copy(), params
    slots = rng.integers(0, 9, (9, k)).astype(np.int32)
    slots[:, 0] = SLOTS
    slots[0] = [7, 1, 7]
    slots[1] = [8, 7, 7]
    return imgs, slots, params


@pytest.mark.parametrize("kind", ["binary", "fractional"])
@pytest.mark.parametrize("k", [1, 3])
def test_masked_chain_matches_jax_and_bank(k, kind):
    imgs, slots, params = _chain_case(k)
    mask = _mask(kind, 9, seed=k)
    want = np.asarray(_jax_chain(jnp.asarray(imgs), jnp.asarray(slots),
                                 jnp.asarray(params), mask=jnp.asarray(mask)))
    tm = torch.from_numpy(mask)
    got = chain.fused_chain(torch.from_numpy(imgs), torch.from_numpy(slots),
                            torch.from_numpy(params), tm).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the unedited region (m == 0) keeps the input
    out = torch.from_numpy(imgs)
    for j in range(k):
        ids = torch.from_numpy(np.where(slots[:, j] == 0, 0,
                                        slots[:, j] + 2).astype(np.int64))
        out, _ = bank.execute_bank(out, ids, torch.from_numpy(params[:, j]),
                                   mask=tm)
    np.testing.assert_allclose(got, out.numpy(), atol=1e-5, rtol=0)
    keep = np.broadcast_to(mask == 0.0, got.shape)
    np.testing.assert_array_equal(got[keep], imgs[keep])


# ---------------------------------------------------------------------------
# the step and its VJP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["binary", "fractional"])
def case(request):
    """Inputs plus JAX's masked fused_step forward and VJP of
    sum |out - gt|."""
    imgs, params, gt, mask = _step_inputs(request.param)

    def loss(i, p):
        out = jpf.fused_step(i, jnp.asarray(SLOTS), p, jnp.asarray(mask))
        return jnp.abs(out - gt).sum(), out

    (_, out), (gi, gp) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        jnp.asarray(imgs), jnp.asarray(params))
    return (imgs, params, gt, mask, np.asarray(out), np.asarray(gi),
            np.asarray(gp))


def _port_grads(fn, imgs, params, gt, mask):
    ti = torch.from_numpy(imgs).requires_grad_(True)
    tp = torch.from_numpy(params).requires_grad_(True)
    out = fn(ti, torch.from_numpy(SLOTS), tp, torch.from_numpy(mask))
    (out - torch.from_numpy(gt)).abs().sum().backward()
    return out.detach().numpy(), ti.grad.numpy(), tp.grad.numpy()


def _jax_f64_param_grads(imgs, params, mask, g):
    """d_params of clip(branch(img, p)*m + img*(1-m), 0, 1) per image,
    the math `_bwd_branches` differentiates, evaluated in f64."""
    out = np.zeros((9, 24))
    with jax.enable_x64(True):
        for i, slot in enumerate(SLOTS):
            if slot in (0, 5):
                continue
            branch = jpf._BRANCHES[slot]
            m = jnp.asarray(mask[i], jnp.float64)

            def f(im, p, branch=branch, m=m):
                y = branch(im, [p[j] for j in range(24)])
                return jnp.clip(y * m + im * (1.0 - m), 0.0, 1.0)

            _, vjp = jax.vjp(f, jnp.asarray(imgs[i], jnp.float64),
                             jnp.asarray(params[i], jnp.float64))
            out[i] = np.asarray(vjp(jnp.asarray(g[i], jnp.float64))[1])
    return out


def test_masked_step_forward_and_vjp_match_jax(case):
    imgs, params, gt, mask, out_j, gi_j, gp_j = case
    out, gi, gp = _port_grads(step.fused_step, imgs, params, gt, mask)
    np.testing.assert_allclose(out, out_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gi, gi_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gp, gp_j, atol=5e-5, rtol=1e-5)
    g = np.sign(out - gt)
    exact = _jax_f64_param_grads(imgs, params, mask, g)
    np.testing.assert_allclose(gp, exact, atol=1e-5, rtol=1e-5)
    assert not gp[[0, 5, 8]].any()
    # slots 0 and 5 are never blended: g passes whole, inside the mask too
    np.testing.assert_array_equal(gi[[0, 5]], g[[0, 5]])
    # masked white passes x its direct term g * clip'(y) * (1 - m), where
    # the unmasked white passes nothing
    y = mask[8] + imgs[8] * (1.0 - mask[8])
    clip_d = np.where((y > 0) & (y < 1), 1.0,
                      np.where((y == 0) | (y == 1), 0.5, 0.0))
    np.testing.assert_array_equal(gi[8], (g[8] * clip_d) * (1.0 - mask[8]))
    assert gi[8][:, :, 0].sum() == 0 and gi[8][:, :, 1].any()
    # exact 0 / 1 pixels outside the mask stay as they are (y == x), so
    # the clamp passes half the cotangent, whatever the op
    for s in (1, 2, 3, 4, 6, 8):
        np.testing.assert_array_equal(gi[s][:, 0:4, 1], 0.5 * g[s][:, 0:4, 1])


def test_masked_chain_reference_autograd_matches_jax(case):
    """Autograd through the plain masked chain at K=1 keeps JAX's tie
    rules through the blend."""
    imgs, params, gt, mask, out_j, gi_j, gp_j = case

    def chain_k1(i, s, p, m):
        return chain.fused_chain_reference(i, s[:, None], p[:, None], m)

    _, gi, gp = _port_grads(chain_k1, imgs, params, gt, mask)
    np.testing.assert_allclose(gi, gi_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gp, gp_j, atol=5e-5, rtol=1e-5)


def test_masked_bwd_reference_matches_autograd_of_forward(case):
    """The written-out masked VJP against torch autograd of the plain
    masked forward: two derivations of the same gradient."""
    imgs, params, gt, mask = case[:4]
    tm = torch.from_numpy(mask)
    out = step.fused_step(torch.from_numpy(imgs), torch.from_numpy(SLOTS),
                          torch.from_numpy(params), tm).numpy()
    g = torch.from_numpy(np.sign(out - gt).astype(np.float32))
    ti = torch.from_numpy(imgs).requires_grad_(True)
    tp = torch.from_numpy(params).requires_grad_(True)
    y = chain.fused_chain_reference(ti, torch.from_numpy(SLOTS)[:, None],
                                    tp[:, None], tm)
    ai, ap = torch.autograd.grad(y, (ti, tp), g)
    ri, rp = step.fused_step_bwd_reference(
        torch.from_numpy(imgs), torch.from_numpy(SLOTS),
        torch.from_numpy(params), g, tm)
    np.testing.assert_allclose(ri.numpy(), ai.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(rp.numpy(), ap.numpy(), atol=5e-5, rtol=1e-5)


def test_all_ones_mask_equals_unmasked_bit_for_bit():
    imgs, slots, params = (torch.from_numpy(a) for a in _chain_case(3))
    ones = torch.ones(9, 1, H, W)
    assert torch.equal(chain.fused_chain(imgs, slots, params, ones),
                       chain.fused_chain(imgs, slots, params))
    imgs, params, gt, _ = (torch.from_numpy(a) for a in
                           _step_inputs("binary"))
    s = torch.from_numpy(SLOTS)
    g = torch.sign(step.fused_step(imgs, s, params) - gt)
    for a, b in zip(step.fused_step_bwd_reference(imgs, s, params, g, ones),
                    step.fused_step_bwd_reference(imgs, s, params, g)):
        assert torch.equal(a, b)


def test_masked_fused_step_plumbing():
    imgs, params, gt, mask = _step_inputs("fractional")
    before = dict(chain.LAUNCHES)
    tm = torch.from_numpy(mask).requires_grad_(True)
    tp = torch.from_numpy(params).requires_grad_(True)
    out = step.fused_step(torch.from_numpy(imgs), torch.from_numpy(SLOTS),
                          tp, tm)
    out.sum().backward()
    # the mask is data: no gradient flows to it
    assert tm.grad is None and tp.grad.shape == (9, 24)
    # a float64 mask is cast to the images' type, as the JAX package does
    out64 = step.fused_step(torch.from_numpy(imgs), torch.from_numpy(SLOTS),
                            torch.from_numpy(params), tm.detach().double())
    assert torch.equal(out64, out.detach())
    assert chain.LAUNCHES == before          # the plain versions ran


@pytest.mark.parametrize("fault", ["dtype", "shape", "device",
                                   "noncontig"])
def test_kernel_wrappers_reject_bad_masks(fault):
    """The checks a CUDA call makes on the mask before launching."""
    imgs = torch.zeros(2, 3, 8, 8)
    mask = torch.zeros(2, 1, 8, 8)
    chain._check_mask(mask, imgs, "test")
    if fault == "dtype":
        mask = mask.double()
    elif fault == "shape":
        mask = torch.zeros(2, 3, 8, 8)
    elif fault == "device":
        mask = mask.to("meta")
    else:
        mask = torch.zeros(2, 1, 8, 16)[..., ::2]
    with pytest.raises((TypeError, ValueError)):
        chain._check_mask(mask, imgs, "test")
    with pytest.raises(ValueError):
        chain.fused_chain(imgs.to("meta"), torch.zeros(2, 1, dtype=torch.int32,
                                                       device="meta"),
                          torch.zeros(2, 1, 24, device="meta"),
                          mask.to("meta"))


def test_masked_smem_size():
    """The mask is read only at the pixel being written, so it has no
    plane in shared memory: B2's is B1's, and a masked chain of the
    longest length passes the checks."""
    side = chain.TILE + 2 * 5
    assert chain.plan(2, 8, 16, 5).smem_bytes == 3 * side * side * 4
    imgs = torch.zeros(2, 3, 8, 16)
    k = chain.MAX_STEPS
    chain._check(imgs, torch.zeros(2, k, dtype=torch.int32),
                 torch.zeros(2, k, 24))
    chain._check_mask(torch.zeros(2, 1, 8, 16), imgs, "test")
    assert chain.plan(2, 8, 16, k).smem_bytes <= chain.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the bank (--fused_exec 0)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "fractional"])
def test_masked_bank_matches_jax(kind):
    """execute_bank(mask=) over every decoder vocab id 0..10, forward and
    gradients, against JAX's masked bank."""
    b = 11
    imgs = tie_images(b, H, W)
    rng = np.random.default_rng(5)
    ids = np.arange(b, dtype=np.int64)
    params = rng.uniform(0.1, 0.6, (b, 8, 24)).astype(np.float32)
    params[:, [3, 5]] += 0.5            # curve knots away from 0
    gt = rng.uniform(0.0, 1.0, imgs.shape).astype(np.float32)
    mask = _mask(kind, b, seed=6)

    def jloss(i, p):
        out, chosen = jbank.execute_bank(i, jnp.asarray(ids), p,
                                         mask=jnp.asarray(mask))
        return jnp.abs(out - gt).sum(), (out, chosen)

    (_, (out_j, ch_j)), (gi_j, gp_j) = jax.value_and_grad(
        jloss, (0, 1), has_aux=True)(jnp.asarray(imgs), jnp.asarray(params))
    ti = torch.from_numpy(imgs).requires_grad_(True)
    tp = torch.from_numpy(params).requires_grad_(True)
    out, chosen = bank.execute_bank(ti, torch.from_numpy(ids), tp,
                                    mask=torch.from_numpy(mask))
    (out - torch.from_numpy(gt)).abs().sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(chosen.detach().numpy(), np.asarray(ch_j))
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(gi_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp_j), atol=1e-4,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# a masked episode step through the fused step, on real GIER data
# ---------------------------------------------------------------------------

def test_masked_fused_episode_step_matches_jax():
    """One greedy masked episode step through `fused_step` (its plain
    versions here) against JAX's `make_episode_step(with_masks=True,
    pallas_exec=True)`: loss, gradients, BN statistics and Adam-updated
    weights, GloVe rows frozen (the bank's twins are test_torch_gier.py's).
    """
    from t2onet_tpu.config import ModelConfig as JModelConfig
    from tests._torch_port import gier_step_case, gier_train_step_parity

    cfg = JModelConfig.tiny(decoder_max_len=3, word_vec_dim=300,
                            fix_input_embedding=True)
    before = dict(chain.LAUNCHES)
    gier_train_step_parity(gier_step_case(cfg), cfg, "greedy_fused")
    assert chain.LAUNCHES == before
