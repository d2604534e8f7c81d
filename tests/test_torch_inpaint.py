"""The port's inpaint fillers (t2onet_tpu_torch.models.inpaint and
.edgeconnect, cli.train_inpaint) and the planner's inpaint candidate
(beam_search(inpaint_fn=), cli.plan_gier --inpaint_ckpt) against the JAX
package's, on the CPU at 16-32 px from seeded numpy inputs and weights
carried over by `convert.load_jax_inpaint`.

Tolerances: InpaintNet's forward within 1e-5 and its gradients within
1e-4 of each tensor's largest entry; the loss within 1e-6 relatively
(f32 sums in another order); the masks and canny's edges equal; three
Adam steps (torch.optim.Adam against optax.adam: torch computes the bias
corrections in f64, optax in f32) within 1e-6 in every weight, a
hundredth of one step's 2e-4; EdgeConnect's generators (full width,
spectral norm on every layer) within 1e-4; plans with the same ops and
distances within 1e-4."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from t2onet_tpu.models import edgeconnect as jec
from t2onet_tpu.models import inpaint as jinp
from t2onet_tpu.ops import operators as jops
from t2onet_tpu.planner import beam as jbeam
from t2onet_tpu_torch.cli import plan_gier, train_inpaint
from t2onet_tpu_torch.convert import (inpaint_variables_to_state_dict,
                                      load_jax_inpaint)
from t2onet_tpu_torch.data.gier import GIER
from t2onet_tpu_torch.models import edgeconnect, inpaint
from t2onet_tpu_torch.planner import beam
from tests._torch_port import jpeg_images

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIER_DATA = os.path.join(ROOT, "data_real_gier")
LR = 2e-4                       # cli.train_inpaint's default
INPAINT = 4                     # executor index of the inpaint op
GIER_INPAINT_PAIR = 9           # the first shapeAlign train pair with one


def _random_edgeconnect():
    spec = importlib.util.spec_from_file_location(
        "make_random_edgeconnect",
        os.path.join(ROOT, "scripts", "make_random_edgeconnect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_generator_sd


@pytest.fixture(scope="module")
def tiny():
    """A JAX InpaintNet (features 4), its params as numpy, the port's net
    from them, and a batch of JPEG crops with free-form holes."""
    net = jinp.InpaintNet(features=4, dilations=(2, 2))
    img = np.concatenate([jpeg_images(16, 16)[:1], np.random.default_rng(0)
                          .uniform(0, 1, (1, 3, 16, 16)).astype(np.float32)])
    mask = jinp.random_freeform_masks(np.random.default_rng(1), 2, 16, 16)
    params = jax.tree_util.tree_map(np.asarray, net.init(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(mask)))
    pnet = inpaint.InpaintNet(features=4, dilations=(2, 2))
    load_jax_inpaint(pnet, params)
    return net, params, pnet, img, mask


def _grads_close(pgrads, jgrads, rel):
    want = inpaint_variables_to_state_dict(jgrads)
    assert set(pgrads) == set(want)
    for k, w in want.items():
        g = pgrads[k]
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-12), k


def test_forward_and_gradients_match_jax(tiny):
    net, params, pnet, img, mask = tiny
    t_img, t_mask = torch.from_numpy(img), torch.from_numpy(mask)
    pred = pnet(t_img, t_mask)
    want = net.apply(params, jnp.asarray(img), jnp.asarray(mask))
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    pnet.zero_grad()
    inpaint.inpaint_loss(pred, t_img, t_mask).backward()
    jgrads = jax.grad(lambda p: jinp.inpaint_loss(
        net.apply(p, jnp.asarray(img), jnp.asarray(mask)), jnp.asarray(img),
        jnp.asarray(mask)))(params)
    _grads_close({k: p.grad.numpy() for k, p in pnet.named_parameters()},
                 jax.tree_util.tree_map(np.asarray, jgrads), 1e-4)


@pytest.mark.parametrize("shape,seed", [((2, 16, 16), 1), ((3, 32, 48), 5),
                                        ((4, 64, 64), 9), ((2, 200, 312), 4)])
def test_loss_and_masks_match_jax(shape, seed):
    got = inpaint.random_freeform_masks(np.random.default_rng(seed), *shape)
    want = jinp.random_freeform_masks(np.random.default_rng(seed), *shape)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (shape[0], 3) + shape[1:]).astype(np.float32)
    tgt = rng.uniform(0, 1, pred.shape).astype(np.float32)
    tgt[:, :, :2] = pred[:, :, :2]                 # exact zero residuals
    ploss = inpaint.inpaint_loss(torch.from_numpy(pred),
                                 torch.from_numpy(tgt), torch.from_numpy(got))
    jloss = jinp.inpaint_loss(jnp.asarray(pred), jnp.asarray(tgt),
                              jnp.asarray(want))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)


def test_train_steps_match_optax(tiny):
    net, params, _, img, mask = tiny
    pnet = inpaint.InpaintNet(features=4, dilations=(2, 2))
    load_jax_inpaint(pnet, params)
    step = inpaint.make_train_step(pnet, torch.optim.Adam(
        pnet.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8))
    tx = optax.adam(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    jstep = jinp.make_train_step(net, tx)
    for _ in range(3):
        ploss = step(torch.from_numpy(img), torch.from_numpy(mask))
        jparams, opt_state, jloss = jstep(jparams, opt_state,
                                          jnp.asarray(img), jnp.asarray(mask))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
    want = inpaint_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams))
    before = inpaint_variables_to_state_dict(params)
    for k, p in pnet.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k], atol=1e-6, rtol=0)
        assert np.abs(p.numpy() - before[k]).max() > 0, k


def test_save_load_round_trip(tiny, tmp_path):
    net, params, pnet, img, mask = tiny
    inpaint.save_inpaint(str(tmp_path / "port"), pnet)
    jinp.save_inpaint(str(tmp_path / "jax"), net, params)
    loaded = inpaint.load_inpaint(str(tmp_path / "port"))
    for k, v in pnet.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    with torch.no_grad():
        a = loaded(torch.from_numpy(img), torch.from_numpy(mask))
        b = pnet(torch.from_numpy(img), torch.from_numpy(mask))
    assert torch.equal(a, b)
    for d in ("port", "jax"):
        with open(tmp_path / d / "arch.json") as f:
            assert json.load(f) == {"features": 4, "dilations": [2, 2]}


def test_inpaint_fn_matches_jax(tiny):
    net, params, pnet, img, mask = tiny
    one = mask[:1]                       # one pair's mask, every row
    with torch.no_grad():
        got = inpaint.make_inpaint_fn(pnet, one)(torch.from_numpy(img))
    want = jinp.make_inpaint_fn(net, params, jnp.asarray(one))(
        jnp.asarray(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    keep = np.broadcast_to(one == 0, (2, 3, 16, 16))
    np.testing.assert_array_equal(got.numpy()[keep], img[keep])


@pytest.mark.parametrize("kind", ["edge", "inpaint"])
def test_edgeconnect_generators_match_jax(kind):
    """Full-width generators from a random state_dict with spectral norm
    on every layer, at 32 px; eval() runs no power iteration."""
    make_sd = _random_edgeconnect()
    cin, cout = (3, 1) if kind == "edge" else (4, 3)
    rng = np.random.default_rng(0 if kind == "edge" else 1)
    sd = make_sd(rng, cin, cout, True, torch)
    x = rng.uniform(0, 1, (2, cin, 32, 32)).astype(np.float32)
    model = jec.EdgeGenerator() if kind == "edge" else jec.InpaintGenerator()
    want = np.asarray(model.apply(jec.convert_edgeconnect_gen(sd, kind),
                                  jnp.asarray(x.transpose(0, 2, 3, 1))))
    net = edgeconnect.load_generator({"iteration": 7, "generator": sd}, kind)
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
        again = net.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(again, got)
    for k, v in net.state_dict().items():
        assert torch.equal(v, weights[k]), k


def test_spectral_norm_as_torch_stores_it():
    """Resolved weights equal torch's own spectral_norm weights, a
    ConvTranspose2d's (u over its output channels) included."""
    torch.manual_seed(0)
    for layer in (torch.nn.Conv2d(6, 5, 3), torch.nn.ConvTranspose2d(6, 5, 4)):
        sn = torch.nn.utils.spectral_norm(layer)
        sn.eval()
        sn(torch.rand(1, 6, 8, 8))                 # weight from u, v as saved
        sd = {f"l.{k}": v for k, v in sn.state_dict().items()}
        np.testing.assert_allclose(
            edgeconnect._resolve_spectral(sd, "l").detach().numpy(),
            sn.weight.detach().numpy(), rtol=1e-6, atol=1e-7)


def test_canny_edges_identical():
    crops = jpeg_images(32, 40)
    gray = list(0.2125 * crops[:, 0] + 0.7154 * crops[:, 1]
                + 0.0721 * crops[:, 2])
    gray.append(np.random.default_rng(3).uniform(0, 1, (24, 24))
                .astype(np.float32))
    gray.append(np.zeros((16, 16), np.float32))
    for g in gray:
        for sigma in (1.5, 2.0):
            np.testing.assert_array_equal(edgeconnect.canny_edges(g, sigma),
                                          jec.canny_edges(g, sigma))


def test_edgeconnect_inpaint_fn_matches_jax():
    make_sd = _random_edgeconnect()
    rng = np.random.default_rng(2)
    esd, isd = make_sd(rng, 3, 1, True, torch), make_sd(rng, 4, 3, False,
                                                         torch)
    mask = np.zeros((32, 32), np.float32)
    mask[8:20, 10:22] = 1.0
    img = jpeg_images(32, 32)[:2]
    want = jec.make_edgeconnect_inpaint_fn(
        jec.convert_edgeconnect_gen(esd, "edge"),
        jec.convert_edgeconnect_gen(isd, "inpaint"), mask)(img)
    got = edgeconnect.make_edgeconnect_inpaint_fn(
        edgeconnect.load_generator(esd, "edge"),
        edgeconnect.load_generator(isd, "inpaint"),
        mask[None, None])(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _gier_pair(size=16):
    g = GIER(os.path.join(GIER_DATA, "GIER"),
             os.path.join(GIER_DATA, "language"), "train",
             data_mode="shapeAlign", is_load_mask=True, train_img_size=size)
    item = g.get_pair_item(GIER_INPAINT_PAIR)
    masks = {int(k) - 3: m[None].astype(np.float32)
             for k, m in item["mask_dict"].items()}
    assert INPAINT in masks
    return item["input"][None], masks


def test_beam_search_with_filler_matches_jax(tiny):
    """A 16-px GIER pair whose target is its input brightened, then filled
    by the filler: both planners take the inpaint candidate, with the
    same ops and distances."""
    net, params, pnet, _, _ = tiny
    x, op_masks = _gier_pair()
    hole = op_masks[INPAINT][None]
    jfill = jinp.make_inpaint_fn(net, params, jnp.asarray(hole))
    y = np.asarray(jfill(jops.apply_op_by_index(
        jnp.asarray(x), 0, jnp.asarray([[0.3]], jnp.float32))))
    kw = dict(beam_size=2, operations=(0, 1, INPAINT, 5), max_step=3,
              err=1e-4, n_starts=2, n_iters=20, seed=11, op_masks=op_masks)
    wa, wi = jbeam.beam_search(x, y, inpaint_fn=jfill, **kw)
    ga, gi = beam.beam_search(x, y, inpaint_fn=inpaint.make_inpaint_fn(
        pnet, hole), device="cpu", **kw)
    assert "inpaint" in [s[0] for s in wa[0]]
    assert [[s[0] for s in b] for b in ga] == [[s[0] for s in b] for b in wa]
    for gb, wb in zip(ga, wa):
        for g, w in zip(gb, wb):
            assert abs(g[2] - w[2]) <= 1e-4
            np.testing.assert_allclose(g[1], w[1], atol=1e-3)
    for gb, wb in zip(gi, wi):
        for g, w in zip(gb, wb):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4)


def test_train_inpaint_cli_draws_distinct_batches(tmp_path):
    """A tiny `train_inpaint --device cpu` run checkpoints and reports the
    held-out hole L1; its four held-out batches are distinct, where the
    JAX CLI's call pattern draws one batch four times."""
    argv = ["--synthetic", "--device", "cpu", "--synthetic_n", "64",
            "--img_size", "16", "--batch_size", "2", "--features", "4",
            "--num_iters", "3", "--print_every", "1", "--checkpoint_every",
            "2", "--run_dir", str(tmp_path)]
    net, m = train_inpaint.main(argv)
    assert set(m) == {"hole_l1", "hole_l1_blank", "hole_psnr",
                      "hole_psnr_blank"}
    assert all(np.isfinite(v) for v in m.values())
    loaded = inpaint.load_inpaint(str(tmp_path / "inpaint_model"))
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v.cpu())
    with open(tmp_path / "inpaint.jsonl") as f:
        assert len([json.loads(line) for line in f]) == 4
    a = train_inpaint.build_parser().parse_args(argv)
    from t2onet_tpu_torch.cli import common

    eval_ds = common.build_dataset_and_vocab(a, phase="val")[0]
    got = [b["img_x"] for b in train_inpaint.held_out_batches(eval_ds, 2)]
    assert len(got) == train_inpaint.N_EVAL
    for i in range(len(got)):
        for j in range(i):
            assert not np.array_equal(got[i], got[j])
    jax_way = [next(eval_ds.batches(batch_size=2, steps=1, shuffle=True))
               ["img_x"] for _ in range(train_inpaint.N_EVAL)]
    assert all(np.array_equal(b, jax_way[0]) for b in jax_way)


def test_plan_gier_with_inpaint_ckpt_matches_jax(tiny, tmp_path,
                                                 monkeypatch):
    """`cli.plan_gier --inpaint_ckpt` against the JAX CLI with the same
    filler: the same ops, distances within 1e-4. JAX's `plan_gier.main`
    rebinds `cli.common.add_base_args` for the process: monkeypatch puts
    it back when the test ends."""
    from t2onet_tpu.cli import common as jcommon
    from t2onet_tpu.cli import plan_gier as jplan_gier

    monkeypatch.setattr(jcommon, "add_base_args", jcommon.add_base_args)
    net, params, pnet, _, _ = tiny
    jinp.save_inpaint(str(tmp_path / "jck"), net, params)
    inpaint.save_inpaint(str(tmp_path / "pck"), pnet)
    argv = ["--data_dir", GIER_DATA, "--data_mode", "shapeAlign",
            "--img_size", "16", "--start", str(GIER_INPAINT_PAIR), "--limit",
            "1", "--n_iters", "10", "--beam_size", "2"]
    jplan_gier.main(argv + ["--inpaint_ckpt", str(tmp_path / "jck"),
                            "--out_dir", str(tmp_path / "jax")])
    assert plan_gier.main(argv + ["--device", "cpu", "--inpaint_ckpt",
                                  str(tmp_path / "pck"), "--out_dir",
                                  str(tmp_path / "port")]) == 1
    [item] = os.listdir(tmp_path / "port")
    with open(tmp_path / "jax" / item / "acts.json") as f:
        want = json.load(f)
    with open(tmp_path / "port" / item / "acts.json") as f:
        got = json.load(f)
    assert abs(got["init distance"] - want["init distance"]) <= 1e-6
    gs, ws = got["operation sequence"], want["operation sequence"]
    assert [[s[0] for s in b] for b in gs] == [[s[0] for s in b] for b in ws]
    for gb, wb in zip(gs, ws):
        for g, w in zip(gb, wb):
            assert abs(g[2] - w[2]) <= 1e-4
