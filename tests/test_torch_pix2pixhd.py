"""pix2pixHD's generators in the port (t2onet_tpu_torch.models.pix2pixhd)
against the JAX package's, at tiny widths: the port's modules drawn as
torch's defaults from a seed, their state_dicts (the reference's names)
carried into flax by JAX's own `convert_pix2pixhd`, the same seeded
input through both. Tolerance: 1e-5 (forwards, on tanh outputs and on
unit-scale features)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.convert.torch_checkpoint import convert_pix2pixhd
from t2onet_tpu.models import pix2pixhd as jp
from t2onet_tpu_torch.models import pix2pixhd as pp
from t2onet_tpu_torch.models.common import init_torch_defaults

torch.set_num_threads(2)

CASES = {
    "global": (dict(ngf=4, n_downsampling=2, n_blocks=2), (2, 32)),
    "local": (dict(ngf=4, n_downsample_global=2, n_blocks_global=2,
                   n_local_enhancers=1, n_blocks_local=2), (1, 32)),
    "encoder": (dict(ngf=4, n_downsampling=2, n_instances=4), (2, 32)),
}


def _ids(b, hw, rng):
    """Instance maps with arbitrary id values (pix2pixHD's class * 1000 +
    index), 3 or 4 distinct per image."""
    ids = np.array([7, 26002, 26001, 33000])
    return ids[rng.integers(0, 4, (b, 1, hw, hw))].astype(np.int32)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_generator_matches_jax(kind):
    kw, (b, hw) = CASES[kind]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, 3, hw, hw)).astype(np.float32)
    extra = (_ids(b, hw, rng),) if kind == "encoder" else ()
    port = pp.define_generator(kind, **kw)
    init_torch_defaults(port, torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   *[torch.from_numpy(e) for e in extra]).numpy()
    flax_mod = jp.define_generator(kind, **kw)
    args = (jnp.asarray(x),) + tuple(jnp.asarray(e) for e in extra)
    shapes = jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0), *args)
    params = convert_pix2pixhd(
        {k: v.numpy() for k, v in port.state_dict().items()},
        shapes["params"])
    want = np.asarray(jax.jit(flax_mod.apply)({"params": params}, *args))
    assert got.shape == want.shape == (b, 3, hw, hw)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_encoder_pools_each_instance_and_bounds_the_ids():
    """Every pixel of an instance carries its mean; an image with more
    distinct ids than n_instances pools the smallest ones and zeroes the
    rest, as JAX's sized unique does."""
    rng = np.random.default_rng(2)
    enc = pp.Encoder(ngf=4, n_downsampling=1, n_instances=2)
    init_torch_defaults(enc, torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.standard_normal((1, 3, 16, 16))
                         .astype(np.float32))
    inst = torch.from_numpy(_ids(1, 16, rng))
    with torch.no_grad():
        out = enc(x, inst)[0]
        raw = enc.model(x)[0]
    ids = inst[0, 0]
    kept = sorted(set(ids.flatten().tolist()))[:2]
    for v in set(ids.flatten().tolist()):
        m = ids == v
        for ch in range(3):
            got = out[ch][m]
            if v in kept:
                assert torch.allclose(got, raw[ch][m].mean().expand_as(got),
                                      atol=1e-6)
            else:
                assert not got.any()
    with pytest.raises(ValueError):
        pp.define_generator("unknown")
