"""Tensor parallelism of the parameter heads (the port's counterpart of
the JAX package's (data x model) mesh, `parallel/mesh.py:make_2d_mesh`
and `state_shardings`), at tiny widths on the CPU over gloo.

- `make_2d_mesh` refuses what JAX's refuses, with its text.
- A (1 x 2) and a (2 x 2) grid (`parallel.workers` ranks): one f64
  supervised and one sampled f64 episode step (the same Gumbel draws
  fed) against the same steps in one process: metrics within 1e-9
  relative; each rank's gradients (its own heads and the replicated
  rest), the gathered weights and the gathered Adam moments within 1e-9
  of the largest entry; every rank's gathered weights equal bit for
  bit.
- Ownership (JAX's `test_state_shardings_cover_adam_moments`): each
  rank's Adam holds moments for its own four heads and every replicated
  parameter, and none for the other ranks' heads.
- `python -m t2onet_tpu_torch.parallel.dryrun 4` runs (2 x 2) and prints
  its ok line.
"""

import dataclasses

import numpy as np
import pytest
import torch

from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab
from t2onet_tpu_torch.models.actor import Actor
from t2onet_tpu_torch.ops.operators import OP_NAMES
from t2onet_tpu_torch.parallel import dryrun, mesh, workers

torch.set_num_threads(2)

L, B = 12, 4
CFG = ModelConfig.tiny(encoder_max_len=L, decoder_max_len=3)
V = len(synthetic_vocab())
GRIDS = {"1x2": (2, 2), "2x2": (4, 2)}       # name: (world, model_par)


def test_make_2d_mesh_refuses_what_jax_refuses():
    from t2onet_tpu.parallel.mesh import make_2d_mesh as jax_2d

    with pytest.raises(ValueError) as want:
        jax_2d(3, model_par=2)
    try:
        with pytest.raises(ValueError) as got:
            mesh.make_2d_mesh(2)             # one process: a world of 1
        assert str(got.value) == str(want.value).replace("3 devices",
                                                         "1 devices")
        with pytest.raises(ValueError, match="8 op heads not divisible by "
                                             "model_par=3"):
            mesh.make_2d_mesh(3)
        grid = mesh.make_2d_mesh(1)
        assert (grid.data_par, grid.model_par) == (1, 1)
        assert list(mesh.owned_heads()) == list(range(8))
    finally:
        mesh.close_data_parallel()


def _cases():
    ds = SyntheticFiveK(n=8, img_size=16, seed=1, req_max_len=L,
                        op_max_len=CFG.decoder_max_len)
    nb = next(ds.batches(B, 1, shuffle=False))
    actor = Actor(CFG, OperatorConfig(), V,
                  generator=torch.Generator().manual_seed(9))
    sd = {k: v.detach().clone() for k, v in actor.state_dict().items()}
    rng = np.random.default_rng(4)
    gumbel = [rng.gumbel(size=(B, CFG.op_vocab_size))
              for _ in range(CFG.decoder_max_len)]
    base = dict(cfg=dataclasses.asdict(CFG), vocab_size=V, state_dict=sd,
                dtype="float64", optimizer=True)
    return [dict(base, name="supervised", kind="supervised",
                 batch={k: nb[k] for k in ("x", "y", "img_x", "img_y",
                                           "gt_params")}),
            dict(base, name="episode", kind="episode", sample=True,
                 gumbel=gumbel, batch={"x": nb["x"], "img_x": nb["img_x"],
                                       "gt_img": nb["img_y"][:, -1]})]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    cases = _cases()
    one = {c["name"]: workers.run_step_case(c, torch.device("cpu"))
           for c in cases}
    grids = {name: workers.run_ranks(
        {"kind": "steps", "device": "cpu", "model_par": mp, "cases": cases},
        world, str(tmp_path_factory.mktemp(f"tp_{name}")))
        for name, (world, mp) in GRIDS.items()}
    return one, grids


def _close(got, want, what):
    """Each tensor of `want` within 1e-9 of the largest entry of them all
    (f64; a bias before a BatchNorm has a true gradient of 0 and noise of
    ~1e-20, which no bound of its own holds)."""
    scale = max(float(v.abs().max()) for v in want.values() if v.numel())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-9 * scale, err_msg=f"{what} {k}")


def _heads_of(names):
    return sorted({OP_NAMES.index(n.split(".")[1][:-3]) for n in names
                   if n.startswith("executor.")})


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("name", ["supervised", "episode"])
def test_grid_step_matches_one_process(tp_runs, grid, name):
    """Tolerance: 1e-9 relative for the metrics, 1e-9 of the largest
    entry for gradients, weights and Adam moments (f64)."""
    one, grids = tp_runs
    w = one[name]
    ranks = [r[name] for r in grids[grid]]
    assert len({r["digest"]["actor"] for r in ranks}) == 1
    for r in ranks:
        for k, v in w["metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-9,
                                       atol=1e-12, err_msg=k)
        grads = r["actor"]["grads"]
        assert _heads_of(grads) == _heads_of(r["moments"])
        _close(grads, {k: w["actor"]["grads"][k] for k in grads}, "grad")
        _close(r["actor"]["state_dict"], w["actor"]["state_dict"], "weight")
        got, want = r["optimizer"], w["optimizer"]
        assert sorted(got["state"]) == sorted(want["state"])
        for i, st in want["state"].items():
            assert float(got["state"][i]["step"]) == float(st["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            _close({i: got["state"][i][key] for i in got["state"]},
                   {i: st[key] for i, st in want["state"].items()}, key)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_each_rank_holds_moments_of_its_own_heads(tp_runs, grid):
    """The counterpart of JAX's test_state_shardings_cover_adam_moments:
    each rank's Adam covers its model rank's four heads (all four tensors
    of each) and every replicated parameter; one process covers all."""
    one, grids = tp_runs
    world, mp = GRIDS[grid]
    everything = one["supervised"]["moments"]
    assert _heads_of(everything) == list(range(8))
    rest = [n for n in everything if not n.startswith("executor.")]
    for r, result in enumerate(grids[grid]):
        held = result["supervised"]["moments"]
        own = list(range((r % mp) * 4, (r % mp) * 4 + 4))
        assert _heads_of(held) == own
        assert [n for n in held if not n.startswith("executor.")] == rest
        assert len(held) == len(rest) + 4 * len(own)


def test_dryrun_4_runs_two_by_two(tmp_path, capsys):
    out = dryrun.dryrun_multichip(4, job_dir=str(tmp_path / "ranks"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh=(2x2) ")
    assert out["model_par"] == 2 and out["serve_reqs"] == 4
