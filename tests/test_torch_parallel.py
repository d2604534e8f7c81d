"""Data parallelism of the port (t2onet_tpu_torch.parallel) against its
single-device forms and the JAX package's mesh, at tiny widths.

- `fused_chain_sharded` on a mesh of 2 and 4 CPU entries equals
  `fused_chain` exactly, and JAX's `fused_chain_sharded` (interpret
  mode, a 2-device mesh of conftest's virtual CPUs) within the chain
  tests' 1e-5, masked and unmasked.
- `ServingEngine(mesh=[cpu, cpu])` gives the single-device engine's ops
  and images within 2e-5 (JAX's test_mesh_sharded_engine_matches_single).
- `batch_beam_search(mesh=)` gives the single-device plans and JAX's
  mesh plans within test_torch_planner.py's bounds.
- Two ranks over gloo (`parallel.workers`) against JAX's steps on a
  2-device mesh (supervised, and a sampled episode with JAX's draws
  fed), within test_torch_train.py's bounds; against the port's own
  world size 1 for the RL and GAN steps and a discrete supervised step,
  in f64, gradients and weights within 1e-9 of their largest entry.
- The cross-rank BatchNorm against one-process BatchNorm on the
  concatenated batch: forward, backward and running statistics.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.ops.pallas_fused import fused_chain_sharded as jax_sharded
from t2onet_tpu.parallel.mesh import make_mesh as jax_mesh
from t2onet_tpu.planner import beam as jbeam
from t2onet_tpu.train import loop as jloop
from t2onet_tpu_torch.ops import chain
from t2onet_tpu_torch.parallel import workers
from t2onet_tpu_torch.parallel.mesh import Mesh, make_mesh
from t2onet_tpu_torch.planner import beam
from t2onet_tpu_torch.serve import ServingEngine
from tests._torch_port import (check_train_step, draw_sequence, jax_actor,
                               jax_train_state, port_actor, uniform_images)

torch.set_num_threads(2)

ATOL = 1e-5
L, B, LR = 12, 4, 1e-3
CFG = JModelConfig.tiny(encoder_max_len=L, decoder_max_len=3)
V = len(synthetic_vocab())


def _chain_case(b, seed=0, h=16, w=24, k=4):
    rng = np.random.default_rng(seed)
    imgs = uniform_images(b, h, w, seed)
    slots = rng.integers(0, 9, (b, k)).astype(np.int32)
    params = rng.uniform(0.1, 0.6, (b, k, 24)).astype(np.float32)
    mask = rng.uniform(0.0, 1.0, (b, 1, h, w)).astype(np.float32)
    return imgs, slots, params, mask


@pytest.mark.parametrize("masked", [False, True])
def test_fused_chain_sharded_matches_chain_and_jax(masked):
    imgs, slots, params, mask = _chain_case(4)
    t = [torch.from_numpy(a) for a in (imgs, slots, params)]
    m = torch.from_numpy(mask) if masked else None
    want = chain.fused_chain(*t, mask=m)
    for n in (2, 4):
        got = chain.fused_chain_sharded(*t, make_mesh(n_devices=n,
                                                      device="cpu"), mask=m)
        assert torch.equal(got, want), n
    # pre-split shards come back as shards
    shards = chain.fused_chain_sharded(
        [t[0][:2], t[0][2:]], [t[1][:2], t[1][2:]], [t[2][:2], t[2][2:]],
        ["cpu", "cpu"], mask=None if m is None else [m[:2], m[2:]])
    assert torch.equal(torch.cat(shards), want)
    jout = jax_sharded(jnp.asarray(imgs), jnp.asarray(slots),
                       jnp.asarray(params), jax_mesh(n_devices=2),
                       mask=jnp.asarray(mask) if masked else None,
                       interpret=True)
    np.testing.assert_allclose(want.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)


def test_sharded_chain_and_mesh_refuse_what_jax_refuses():
    imgs, slots, params, _ = _chain_case(3)
    with pytest.raises(ValueError, match="batch 3 not divisible by the "
                                         "'data' mesh axis size 2"):
        chain.fused_chain_sharded(torch.from_numpy(imgs),
                                  torch.from_numpy(slots),
                                  torch.from_numpy(params), ["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 devices asked for, 1 visible"):
        make_mesh(devices=["cpu"], n_devices=3)
    assert Mesh(["cpu", "cpu"]).distinct == [torch.device("cpu")]


@pytest.fixture(scope="module")
def engines():
    x = np.zeros((1, L), np.int32)
    img = np.zeros((1, 3, 32, 32), np.float32)
    _, params, stats = jax_actor(CFG, V, x, img, seed=3, knots_near_one=True)
    kw = dict(decode_size=32, quantum=32, max_batch=4, encoder_max_len=L,
              u8_wire=False, io_threads=2)
    single = ServingEngine(port_actor(CFG, V, params, stats),
                           synthetic_vocab(), device="cpu", **kw)
    meshed = ServingEngine(port_actor(CFG, V, params, stats),
                           synthetic_vocab(), mesh=["cpu", "cpu"], **kw)
    return single, meshed


def test_mesh_engine_matches_single_device(engines):
    """Two buckets, a micro-batch of 4 and a short one of 1 (padded to the
    mesh with its request), in request order."""
    single, meshed = engines
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(0, 1, (3, 32, 32 if i < 5 else 64)).astype(
        np.float32) for i in range(7)]
    reqs = ["increase the brightness", "improve contrast",
            "increase saturation", "sharpen the image",
            "fix the tone", "brighten the image", "improve contrast"]
    want = single.edit_batch(imgs, reqs)
    got = meshed.edit_batch(imgs, reqs)
    assert meshed.stats["batches"] == 3
    for g, w in zip(got, want):
        assert g.ops == w.ops and g.bucket == w.bucket
        assert g.image.shape == w.image.shape
        np.testing.assert_allclose(g.image, w.image, atol=2e-5)
        np.testing.assert_allclose(g.params, w.params, atol=1e-5)


def test_mesh_engine_rejects_indivisible_batch(engines):
    with pytest.raises(ValueError, match="max_batch 6 not divisible by mesh "
                                         "size 4"):
        ServingEngine(engines[0].actor, synthetic_vocab(), max_batch=6,
                      mesh=make_mesh(n_devices=4, device="cpu"))
    for kw in ({}, {"device": "cpu", "mesh": ["cpu", "cpu"]}):
        with pytest.raises(ValueError, match="takes a device or a mesh"):
            ServingEngine(engines[0].actor, synthetic_vocab(), **kw)


def test_mesh_planner_matches_single_device_and_jax():
    """3 pairs on a mesh of 2 (one padding pair): the plain lockstep
    against the single-device plans and JAX's 2-device mesh, the eps
    path's fit step against the single-device plans."""
    from tests.test_torch_planner import _assert_plans_match, fivek_pairs

    x, y, _ = fivek_pairs(3)
    m = make_mesh(n_devices=2, device="cpu")
    for kw in (dict(max_step=3), dict(mode="eps", eps=0.5, max_step=2)):
        kw.update(n_iters=20, seed=12)
        single = beam.batch_beam_search(x, y, device="cpu", **kw)
        got = beam.batch_beam_search(x, y, mesh=m, **kw)
        want = (jbeam.batch_beam_search(x, y, mesh=jax_mesh(n_devices=2),
                                        **kw) if "mode" not in kw else single)
        for (ga, gi), (sa, si), (wa, _) in zip(got, single, want):
            _assert_plans_match(ga, sa)
            _assert_plans_match(ga, wa)
            for gb, sb in zip(gi, si):
                for g, s in zip(gb, sb):
                    np.testing.assert_allclose(g, s, atol=1e-6)


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------

def _sd(actor):
    return {k: v.detach().clone() for k, v in actor.state_dict().items()}


def _case(name, kind, cfg, actor, batch, **kw):
    return dict(name=name, kind=kind, cfg=dataclasses.asdict(cfg),
                vocab_size=V, state_dict=_sd(actor), lr=LR, batch=batch, **kw)


def _loaded(cfg, params, stats, result):
    """A port actor holding a rank's gradients and updated weights."""
    actor = port_actor(cfg, V, params, stats)
    actor.load_state_dict(result["state_dict"])
    for n, p in actor.named_parameters():
        if n in result["grads"]:
            p.grad = result["grads"][n]
    return types.SimpleNamespace(actor=actor)


@pytest.fixture(scope="module")
def dp_vs_jax(tmp_path_factory):
    """JAX's mesh steps and the port's two ranks on the same init."""
    ds = JSyntheticFiveK(n=8, img_size=16, seed=0, req_max_len=L,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    sup = {k: nb[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    epi = {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1]}
    ja, params, stats = jax_actor(CFG, V, nb["x"], nb["img_x"], seed=6,
                                  knots_near_one=True)
    actor = port_actor(CFG, V, params, stats)
    mesh2 = jax_mesh(n_devices=2)
    js0 = jax_train_state(params, stats, LR)
    key = jax.random.PRNGKey(3)
    gumbel, _ = draw_sequence(key, CFG.decoder_max_len, B, CFG.op_vocab_size)
    out = {
        "supervised": jloop.make_supervised_step(ja, mesh=mesh2,
                                                 donate=False)(
            js0, {k: jnp.asarray(v) for k, v in sup.items()}),
        "episode": jloop.make_episode_step(ja, mesh=mesh2, sample=True,
                                           donate=False)(
            js0, {k: jnp.asarray(v) for k, v in epi.items()}, key)}
    cases = [_case("supervised", "supervised", CFG, actor, sup),
             _case("episode", "episode", CFG, actor, epi, gumbel=gumbel,
                   sample=True)]
    ranks = workers.run_ranks({"kind": "steps", "device": "cpu",
                               "cases": cases}, 2,
                              str(tmp_path_factory.mktemp("dp_vs_jax")))
    return params, stats, out, ranks


@pytest.mark.parametrize("mode", ["supervised", "episode"])
def test_two_ranks_match_jax_mesh_steps(dp_vs_jax, mode):
    params, stats, out, ranks = dp_vs_jax
    js1, jm = out[mode]
    r0, r1 = ranks[0][mode], ranks[1][mode]
    assert r0["digest"] == r1["digest"]
    assert r0["metrics"] == r1["metrics"]
    key = "L1_loss" if mode == "episode" else "loss"
    check_train_step(_loaded(CFG, params, stats, r0["actor"]), js1,
                     r0["metrics"][key], float(jm[key]), params,
                     CFG.n_layers, LR)
    if mode == "supervised":
        for k in ("op_loss", "param_loss"):
            np.testing.assert_allclose(r0["metrics"][k], float(jm[k]),
                                       rtol=1e-5)


def _assert_close_f64(got, want, what):
    """Every tensor within 1e-9 of the largest entry of them all: a bias
    before a BatchNorm has a true gradient of 0 and rounding noise of
    ~1e-20 in f64, which no relative bound of its own holds."""
    scale = max(float(v.abs().max()) for v in want.values() if v.numel())
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-9 * scale, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def f64_cases(tmp_path_factory):
    """In f64, draws fed, the port at world size 2 and in one process: an
    RL step (parameter noise 0.6), a GAN step, a discrete-mode
    supervised step (the global bin divisor; the one-process discrete
    step against JAX's is test_torch_modes.py's), and an episode step
    with attend_batch_max (the global batch's longest request) followed
    by the trainers' validation on rank 0 alone."""
    from t2onet_tpu_torch.models.common import init_torch_defaults
    from t2onet_tpu_torch.models.gan import DiscBundle

    ds = JSyntheticFiveK(n=8, img_size=16, seed=1, req_max_len=L,
                         op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    sup = {k: nb[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    epi = {"x": nb["x"], "img_x": nb["img_x"], "gt_img": nb["img_y"][:, -1]}
    _, params, stats = jax_actor(CFG, V, epi["x"], epi["img_x"], seed=9,
                                 knots_near_one=True)
    actor = port_actor(CFG, V, params, stats)
    dcfg = dataclasses.replace(CFG, discrete_param=True, discrete_step=6)
    dactor = port_actor(dcfg, V, *jax_actor(dcfg, V, epi["x"], epi["img_x"],
                                            seed=9)[1:])
    acfg = dataclasses.replace(CFG, attend_batch_max=True)
    aactor = port_actor(acfg, V, params, stats)
    rng = np.random.default_rng(4)
    steps, n_cls = CFG.decoder_max_len, CFG.op_vocab_size
    gumbel = [rng.gumbel(size=(B, n_cls)) for _ in range(steps)]
    normal = [rng.normal(size=(B, 8, 24)) for _ in range(steps)]
    hidden = CFG.n_layers * 2 * CFG.hidden_size
    bundle = DiscBundle(hidden, cond_nc=16, ndf=8, n_layers=2, num_D=2)
    init_torch_defaults(bundle, torch.Generator().manual_seed(7))
    gan = dict(hidden_dim=hidden, cond_nc=16, ndf=8, n_layers_D=2, num_D=2,
               state_dict=_sd(bundle))
    cases = [_case("rl", "rl", CFG, actor, epi, dtype="float64",
                   gumbel=gumbel, normal=normal, param_noise=0.6),
             _case("gan", "gan", CFG, actor, epi, dtype="float64",
                   gumbel=gumbel, gan=gan),
             _case("discrete", "supervised", dcfg, dactor, sup,
                   dtype="float64"),
             _case("attend_max", "episode", acfg, aactor, epi,
                   dtype="float64", gumbel=gumbel, sample=True,
                   validate=True)]
    ranks = workers.run_ranks({"kind": "steps", "device": "cpu",
                               "cases": cases}, 2,
                              str(tmp_path_factory.mktemp("f64")))
    one = {c["name"]: workers.run_step_case(c, torch.device("cpu"))
           for c in cases}
    return ranks, one


@pytest.mark.parametrize("name", ["rl", "gan", "discrete", "attend_max"])
def test_two_ranks_match_one_process(f64_cases, name):
    ranks, one = f64_cases
    r0, r1, w = ranks[0][name], ranks[1][name], one[name]
    assert r0["digest"] == r1["digest"]
    for k, v in w["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    for mod in ("actor", "disc") if name == "gan" else ("actor",):
        _assert_close_f64(r0[mod]["grads"], w[mod]["grads"], f"{mod} grad")
        _assert_close_f64(r0[mod]["state_dict"], w[mod]["state_dict"],
                          f"{mod} weight")
    if "val" in w:
        _assert_close_f64({"val": r0["val"]}, {"val": w["val"]}, "val")
        assert "val" not in r1


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    rng = np.random.default_rng(5)
    cases = []
    for ndim in (2, 4):
        shape = (8, 5) if ndim == 2 else (8, 5, 3, 4)
        cases.append(dict(
            name=ndim, x=rng.normal(0.3, 1.5, shape).astype(np.float32),
            g=rng.normal(0.0, 1.0, shape).astype(np.float32),
            state_dict={"weight": torch.from_numpy(rng.uniform(
                0.8, 1.2, 5).astype(np.float32)),
                "bias": torch.from_numpy(rng.normal(0, 0.1, 5).astype(
                    np.float32)),
                "running_mean": torch.from_numpy(rng.normal(
                    0, 0.1, 5).astype(np.float32)),
                "running_var": torch.from_numpy(rng.uniform(
                    0.5, 1.5, 5).astype(np.float32)),
                "num_batches_tracked": torch.tensor(0)}))
    ranks = workers.run_ranks({"kind": "bn", "device": "cpu",
                               "cases": cases}, 2,
                              str(tmp_path_factory.mktemp("bn")))
    one = {c["name"]: workers.run_bn_case(c, torch.device("cpu"))
           for c in cases}
    return ranks, one


@pytest.mark.parametrize("ndim", [2, 4])
def test_cross_rank_batchnorm_matches_one_process(bn_ranks, ndim):
    """Forward, input gradient and running statistics within 1e-5; the
    summed affine gradients within 1e-5 of their largest entry (the sums
    of squares over the ranks' rows against torch's batch_norm)."""
    ranks, one = bn_ranks
    r0, r1, w = ranks[0][ndim], ranks[1][ndim], one[ndim]
    for k in ("y", "x_grad"):
        np.testing.assert_allclose(torch.cat([r0[k], r1[k]]).numpy(),
                                   w[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
    for k in ("weight_grad", "bias_grad", "running_mean", "running_var"):
        assert torch.equal(r0[k], r1[k]), k
        scale = float(w[k].abs().max())
        np.testing.assert_allclose(r0[k].numpy(), w[k].numpy(),
                                   atol=1e-5 * max(scale, 1.0), rtol=0,
                                   err_msg=k)
