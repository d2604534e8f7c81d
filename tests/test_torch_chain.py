"""The port's operator chain (t2onet_tpu_torch.ops.chain). On the CPU
`fused_chain` runs its plain PyTorch version, held here to the JAX
package's Pallas `fused_chain` in interpret mode and to a loop of the
port's own bank, within 1e-5 (the budget of test_pallas_fused.py). The
CUDA kernel itself runs only on a card, where `chip_smoke.py` holds it
to the plain version."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.ops.pallas_fused import fused_chain as jax_fused_chain
from t2onet_tpu.ops.pallas_fused import vocab_ops_to_slots as jax_v2s
from t2onet_tpu.serve import program_slots as jax_program_slots
from t2onet_tpu_torch.ops import bank, chain
from t2onet_tpu_torch.serve import program_slots
from tests._torch_port import jpeg_images, uniform_images

torch.set_num_threads(2)

ATOL = 1e-5


def _workload(b=3, k=4, h=32, w=128, seed=0, kind="uniform"):
    """test_pallas_fused.py's workload: vocab ids drawn from the ops the
    rollout may pick (END and 6 executor ops, sharpness included)."""
    rng = np.random.default_rng(seed)
    imgs = (uniform_images(b, h, w, seed) if kind == "uniform"
            else jpeg_images(h, w)[:b])
    ids = rng.choice([2, 3, 4, 5, 6, 8, 9], size=(b, k)).astype(np.int32)
    params = rng.uniform(0.1, 0.6, (b, k, 24)).astype(np.float32)
    return imgs, ids, params


def _slots(ids):
    return np.array(jax_v2s(jnp.asarray(ids)))


# jit caches the interpreted kernel per shape (an eager call re-traces)
_jax_chain = jax.jit(functools.partial(jax_fused_chain, interpret=True))


def _jax(imgs, slots, params):
    return np.array(_jax_chain(jnp.asarray(imgs), jnp.asarray(slots),
                               jnp.asarray(params)))


def _compare(imgs, slots, params, exact=False):
    expect = _jax(imgs, slots, params)
    got = chain.fused_chain(torch.from_numpy(imgs), torch.from_numpy(slots),
                            torch.from_numpy(params)).numpy()
    if exact:
        np.testing.assert_array_equal(got, expect)
    else:
        np.testing.assert_allclose(got, expect, atol=ATOL, rtol=0)
    # and against the port's own bank, one step at a time
    out = torch.from_numpy(imgs)
    for k in range(slots.shape[1]):
        ids = torch.from_numpy(np.where(slots[:, k] == 0, 0,
                                        slots[:, k] + 2).astype(np.int64))
        out, _ = bank.execute_bank(out, ids, torch.from_numpy(params[:, k]))
    np.testing.assert_allclose(got, out.numpy(), atol=ATOL, rtol=0)
    return got


@pytest.mark.parametrize("kind", ("uniform", "jpeg"))
def test_chain_matches_jax_and_bank(kind):
    imgs, ids, params = _workload(kind=kind)
    _compare(imgs, _slots(ids), params)


def test_chain_two_sharpness_steps():
    imgs, _, params = _workload(seed=1)
    slots = np.array([[7, 1, 7, 6], [2, 7, 7, 0], [7, 7, 7, 7]], np.int32)
    _compare(imgs, slots, params)


def test_chain_special_slots_write_nothing():
    imgs, _, params = _workload(seed=2, kind="jpeg")
    slots = np.array([[0, 5, 1, 5], [5, 0, 0, 5], [3, 0, 8, 5]], np.int32)
    got = _compare(imgs, slots, params)
    np.testing.assert_array_equal(got[1], imgs[1])


def test_chain_all_identity_is_bit_exact():
    imgs, _, params = _workload(seed=3)
    slots = np.array([[0, 5, 0, 5]] * 3, np.int32)
    got = _compare(imgs, slots, params, exact=True)
    np.testing.assert_array_equal(got, imgs)


def test_chain_ragged_shape():
    imgs, ids, params = _workload(b=2, k=3, h=33, w=97, seed=4)
    ids[0, 0] = 9                                       # a sharpness step
    _compare(imgs, _slots(ids), params)


def test_chain_keeps_nan_like_jax():
    """A tone curve whose knots sum to 0 divides by ~1e-10: the chain
    keeps what the clamp of jnp keeps (NaN stays NaN)."""
    imgs, _, params = _workload(b=1, k=2, seed=5)
    params[0, 0, :8] = [1.0, -1.0] * 4
    slots = np.array([[6, 1]], np.int32)
    expect = _jax(imgs, slots, params)
    got = chain.fused_chain(torch.from_numpy(imgs), torch.from_numpy(slots),
                            torch.from_numpy(params)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expect))
    fin = np.isfinite(expect)
    np.testing.assert_allclose(got[fin], expect[fin], atol=ATOL, rtol=0)


def test_white_step_forgets_the_input():
    """Unmasked, a white step sets every pixel to 1 whatever came before
    it, NaN included: each image's chain equals its steps after the last
    white step run on planes of ones, bit for bit. The kernel's flat path
    reads no input for such a chain, and its bound counts no read."""
    imgs, _, params = _workload(b=3, k=5, seed=6)
    slots = np.array([[1, 8, 7, 2, 6],        # sharpness after white
                      [7, 8, 8, 3, 1],        # two white steps
                      [4, 6, 7, 3, 8]], np.int32)   # white last
    got = _compare(imgs, slots, params)
    imgs[:, :, :4] = np.nan
    poisoned = chain.fused_chain(torch.from_numpy(imgs),
                                 torch.from_numpy(slots),
                                 torch.from_numpy(params)).numpy()
    np.testing.assert_array_equal(poisoned, got)
    for i, k0 in enumerate((2, 3, 5)):
        ones = torch.ones((1, 3) + imgs.shape[2:])
        rest = chain.fused_chain(ones, torch.from_numpy(slots[i:i + 1, k0:]),
                                 torch.from_numpy(params[i:i + 1, k0:]))
        np.testing.assert_array_equal(rest.numpy()[0], got[i])


_END_ROWS = np.array([[3, 4, 2, 5, 6],        # END at step 2
                      [3, 4, 5, 6, 9],        # no END
                      [2, 3, 4, 5, 6],        # END first
                      [0, 1, 10, 2, 9]])      # specials and white


def test_vocab_ops_to_slots_matches_jax():
    np.testing.assert_array_equal(
        chain.vocab_ops_to_slots(torch.from_numpy(_END_ROWS)).numpy(),
        np.array(jax_v2s(jnp.asarray(_END_ROWS))))


def test_program_slots_matches_jax():
    got = program_slots(torch.from_numpy(_END_ROWS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.array(jax_program_slots(jnp.asarray(_END_ROWS))))
    np.testing.assert_array_equal(got.numpy()[0], [1, 2, 0, 0, 0])


def _valid_args(b=2, k=3, h=8, w=8):
    return (torch.zeros(b, 3, h, w), torch.zeros(b, k, dtype=torch.int32),
            torch.zeros(b, k, 24))


@pytest.mark.parametrize("fault", ["img_dtype", "slot_dtype", "shape",
                                   "params_shape", "noncontig", "too_long"])
def test_kernel_wrapper_rejects_bad_input(fault):
    """The checks a CUDA call passes before launching (device-agnostic)."""
    imgs, slots, params = _valid_args()
    chain._check(imgs, slots, params)
    if fault == "img_dtype":
        imgs = imgs.double()
    elif fault == "slot_dtype":
        slots = slots.long()
    elif fault == "shape":
        imgs = imgs[:, :2]
    elif fault == "params_shape":
        params = params[:, :, :8]
    elif fault == "noncontig":
        imgs = torch.zeros(2, 3, 8, 16)[..., ::2]
    elif fault == "too_long":
        imgs, slots, params = _valid_args(k=40)
    with pytest.raises((TypeError, ValueError)):
        chain._check(imgs, slots, params)


def test_fused_chain_refuses_other_devices():
    imgs, slots, params = (t.to("meta") for t in _valid_args())
    with pytest.raises(ValueError):
        chain.fused_chain(imgs, slots, params)


def test_smem_sizes():
    """A block's shared memory is one copy of the three planes of a tile
    and its K-pixel halo; the longest chain the kernel takes fits, and a
    longer one is refused before any launch."""
    assert chain.plan(2, 8, 8, 5).smem_bytes == 3 * 42 * 42 * 4
    assert chain.plan(2, 8, 8, chain.MAX_STEPS).smem_bytes \
        <= chain.SMEM_LIMIT
    chain._check(*_valid_args(k=chain.MAX_STEPS))
    with pytest.raises(ValueError):
        chain._check(*_valid_args(k=chain.MAX_STEPS + 1))
