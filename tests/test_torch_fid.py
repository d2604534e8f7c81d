"""FID and the VGG loss in the port (t2onet_tpu_torch.evals.inception,
evals.metrics, models.vgg) against the JAX package's, on the CPU.

The port's modules are drawn from a seed (BatchNorms given non-trivial
statistics); their state_dicts, in torchvision's names, reach JAX
through its own converters (`convert_torchvision_inception`,
`convert_torchvision_vgg19`). Compared: the five VGG19 slices and the
VGG loss with its gradient; each Inception block (A-E) in each of its
branch pools; the whole `features_fn` (resize to 299, [-1, 1], the
94-layer graph) on a batch of 2 in both variants; and `calc_fid` of the
evaluator on fixed features.

Tolerances: block and VGG forwards 1e-5 relative to the output's scale;
the VGG loss 1e-5 and its gradient 1e-4 of its norm; the whole
Inception graph 1e-4 of each feature vector's norm; FID 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.evals import inception as ji
from t2onet_tpu.evals.metrics import ImageEvaluator as JImageEvaluator
from t2onet_tpu.models import vgg as jvgg
from t2onet_tpu_torch.cli import test_fivek, test_gier
from t2onet_tpu_torch.evals import inception as pi
from t2onet_tpu_torch.evals.metrics import ImageEvaluator
from t2onet_tpu_torch.models import vgg as pvgg
from t2onet_tpu_torch.models.common import init_torch_defaults

torch.set_num_threads(2)


def _seeded(module, seed):
    """torch-default weights from `seed`, and every BatchNorm a scale,
    bias, mean and var away from its init."""
    init_torch_defaults(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, v in ((m.weight, rng.uniform(0.8, 1.2, n)),
                             (m.bias, rng.normal(0, 0.1, n)),
                             (m.running_mean, rng.normal(0, 0.1, n)),
                             (m.running_var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return module.eval()


def _sd(module, prefix=""):
    return {prefix + k: v.numpy() for k, v in module.state_dict().items()}


def _scale_close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_vgg19_slices_and_loss_match_jax():
    vgg = _seeded(pvgg.Vgg19Features(), 0)
    variables = jvgg.convert_torchvision_vgg19(
        {"classifier.0.weight": np.zeros((2, 2), np.float32), **_sd(vgg)})
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    y = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    want = jax.jit(jvgg.Vgg19Features().apply)(variables, jnp.asarray(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _scale_close(g, w, 1e-5)

    jloss = jvgg.make_vgg_loss(variables)
    want_l, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x),
                                                        jnp.asarray(y))
    ploss = pvgg.make_vgg_loss(vgg)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    loss = ploss(xt, yt)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
    err = np.linalg.norm(xt.grad.numpy() - np.asarray(want_g))
    assert err <= 1e-4 * np.linalg.norm(np.asarray(want_g))
    assert yt.grad is None and not any(p.requires_grad
                                       for p in vgg.parameters())
    assert float(ploss(xt, xt)) == 0.0


BLOCKS = [("A", "avg_tv"), ("A", "avg_tf"), ("B", None), ("C", "avg_tv"),
          ("C", "avg_tf"), ("D", None), ("E", "avg_tv"), ("E", "avg_tf"),
          ("E", "max")]


@pytest.mark.parametrize("kind, pool", BLOCKS)
def test_inception_block_matches_jax(kind, pool):
    cin, hw = 16, 9
    extra = {"A": (8,), "C": (8,)}.get(kind, ())
    port = getattr(pi, f"Inception{kind}")(cin, *extra,
                                           **({"pool_mode": pool}
                                              if pool else {}))
    _seeded(port, 2)
    tree = ji.convert_torchvision_inception(_sd(port, "X."))
    jmod = getattr(ji, f"Inception{kind}")(*extra, **({"pool_mode": pool}
                                                      if pool else {}))
    x = np.random.default_rng(3).standard_normal((2, cin, hw, hw)) \
        .astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    want = jax.jit(jmod.apply)(
        {"params": tree["params"]["X"],
         "batch_stats": tree["batch_stats"]["X"]},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    _scale_close(got, np.asarray(want).transpose(0, 3, 1, 2), 1e-5)


@pytest.mark.parametrize("fid_variant", [True, False])
def test_full_inception_features_match_jax(tmp_path, fid_variant):
    """`make_random_inception_pth` -> `load_fid_inception` on a batch of
    2 at 64 px (resized to 299 inside) against JAX's `make_features_fn`
    on the same .pth."""
    path = str(tmp_path / "inception.pth")
    pi.make_random_inception_pth(path, seed=4)
    sd = torch.load(path, weights_only=True)
    assert "Mixed_7c.branch_pool.conv.weight" in sd and len(sd) > 470
    feats = pi.load_fid_inception(path, "cpu", fid_variant=fid_variant)
    x = np.random.default_rng(5).uniform(0, 1, (2, 3, 64, 64)) \
        .astype(np.float32)
    got = feats(x)
    want = np.asarray(ji.make_features_fn(
        ji.convert_torchvision_inception(sd), fid_variant=fid_variant)(
        jnp.asarray(x)))
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)
    for parser in (test_fivek.eval_parser(), test_gier.eval_parser()):
        a = parser.parse_args(["--fid_inception_ckpt", path,
                               "--fid_variant", str(int(fid_variant))])
        assert a.fid_inception_ckpt == path
        assert a.fid_variant == int(fid_variant)


def test_calc_fid_matches_jax():
    """The evaluator's FID of inputs and outputs against the ground
    truths, on fixed 8-d features (a seeded projection of each image)."""
    rng = np.random.default_rng(6)
    proj = rng.standard_normal((3 * 8 * 8, 8)).astype(np.float32)

    def features_fn(imgs):
        imgs = np.asarray(imgs.cpu() if torch.is_tensor(imgs) else imgs)
        return imgs.reshape(imgs.shape[0], -1) @ proj

    port = ImageEvaluator(host_metrics=True, features_fn=features_fn)
    jax_ = JImageEvaluator(host_metrics=True, features_fn=features_fn)
    for _ in range(12):
        inp, out, gt = (rng.uniform(0, 1, (1, 3, 8, 8)).astype(np.float32)
                        for _ in range(3))
        m = port.update(inp, out, gt)
        jax_.update(inp, out, gt)
        assert m["features_s"] >= 0
    got, want = port.eval(), jax_.eval()
    assert set(got) == set(want) >= {"in_FID", "out_FID"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert ImageEvaluator().calc_fid() == (None, None)
