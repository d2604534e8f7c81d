"""The learned planner distance (dist_type 'seq2seqGAN-disc') of the port
against the JAX package's, on the CPU at 16 px: the scored fits
(`fit_op_params_scored`, one-hot and selected-branch), `beam_search`
with a discriminator's `score_fn`, the `plan_fivek --dist_type
seq2seqGAN-disc` CLI against JAX's on the repo's FiveK train pairs (both
read one reference model.pth by name), and the disc planner's
`FiveKActDVisualize` items.

The discriminator runs in eval mode, as the planner runs it. Tolerances
as the pixel planner's (tests/test_torch_planner.py): distances within
1e-5 after a fit and 1e-4 along a beam search, parameters within 1e-3
(curve knots are ill-conditioned), the same op sequences.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.data import fivek as jfivek
from t2onet_tpu.models import gan as jgan
from t2onet_tpu.planner import beam as jbeam
from t2onet_tpu.planner import fit as jfit
from t2onet_tpu_torch.cli import common, plan_fivek
from t2onet_tpu_torch.convert import load_jax_disc
from t2onet_tpu_torch.data import fivek
from t2onet_tpu_torch.models.common import init_torch_defaults
from t2onet_tpu_torch.models.gan import DiscBundle, make_disc_planner_score
from t2onet_tpu_torch.planner import beam, fit
from tests._torch_port import jax_disc
from tests.test_torch_planner import (FIVEK_ANNO, FIVEK_IMGS, H2H,
                                      _assert_layouts_match,
                                      _assert_plans_match, fivek_pairs)

torch.set_num_threads(2)

SIZE = 16
CN, NDF, HID = 16, 8, 16
OPS = (0, 1, 3, 5)
ACTS = os.path.join(os.path.dirname(H2H), "data_real_h2h_acts",
                    "actions_set_1")


@pytest.fixture(scope="module")
def scorers():
    """(JAX score_fn, port score_fn, cond (2, CN)) from one
    discriminator, eval mode."""
    jb, params, stats = jax_disc(CN, NDF, 2, SIZE, 2, HID // 2)
    bundle = DiscBundle(HID, cond_nc=CN, ndf=NDF)
    load_jax_disc(bundle, params, stats)
    bundle.eval().requires_grad_(False)
    cond = np.random.default_rng(0).normal(0, 1, (2, CN)).astype(np.float32)
    return (jgan.make_disc_planner_score(
        jb.disc_apply(params, stats, train=False)),
        make_disc_planner_score(bundle.netD), cond)


@pytest.mark.parametrize("selected", [False, True])
def test_scored_fit_matches_jax(scorers, selected):
    jscore, pscore, cond = scorers
    x, _, _ = fivek_pairs(2)
    init = fit.init_candidates(OPS, 2, key=3)
    kw = dict(n_iters=10, lr=0.05)
    jaux = (jnp.asarray(x), jnp.asarray(cond))
    paux = (torch.from_numpy(x), torch.from_numpy(cond))
    if selected:
        wp, wd = jfit.fit_op_params_scored_sel(
            jnp.asarray(x), jnp.asarray(init), OPS, 2, jscore, jaux, **kw)
        gp, gd = fit.fit_op_params_scored_sel(
            torch.from_numpy(x), torch.from_numpy(init), OPS, 2, pscore,
            paux, **kw)
    else:
        slots = fit.candidate_op_slots(OPS, 2)
        onehot = np.eye(9, dtype=np.float32)[slots + 1]
        wp, wd = jfit.fit_op_params_scored(
            jnp.asarray(x), jnp.asarray(onehot), jnp.asarray(init), jscore,
            jaux, **kw)
        gp, gd = fit.fit_op_params_scored(
            torch.from_numpy(x), torch.from_numpy(onehot),
            torch.from_numpy(init), pscore, paux, **kw)
    assert tuple(gd.shape) == (2, len(OPS) * 2)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), atol=1e-3,
                               rtol=0)


def test_beam_search_with_score_fn_matches_jax(scorers):
    """One pair, plain mode: candidates fitted and ranked by the
    discriminator's distance (I_gt unread), beams replayed."""
    jscore, pscore, cond = scorers
    x, y, _ = fivek_pairs(1)
    kw = dict(operations=OPS, max_step=3, n_iters=10, seed=4)
    wa, wi = jbeam.beam_search(x, y, score_fn=jscore,
                               score_aux=(jnp.asarray(x),
                                          jnp.asarray(cond[:1])), **kw)
    ga, gi = beam.beam_search(x, y, score_fn=pscore,
                              score_aux=(torch.from_numpy(x),
                                         torch.from_numpy(cond[:1])),
                              device="cpu", **kw)
    _assert_plans_match(ga, wa)
    assert [len(b) for b in gi] == [len(b) for b in wi]
    for gb, wb in zip(gi, wi):
        for g, w in zip(gb, wb):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


_TINY = ["--hidden_size", "8", "--word_vec_dim", "300", "--operator_fc_dim",
         "8", "--resnet_widths", "4,4,8,8", "--vis_feat_dim", "8"]


def test_plan_fivek_disc_cli_matches_jax(tmp_path):
    """Both CLIs plan the first FiveK train pair with the disc distance
    from one reference seq2seqGAN model.pth (the port's actor at a tiny
    width and a one-scale, one-layer discriminator at the CLIs' fixed
    ndf 64 and 512-wide code, written under the reference's names) and
    write the same ops; one beam, one restart and 3 Adam steps keep
    JAX's side to ~20 s."""
    from t2onet_tpu.cli import plan_fivek as jplan

    args = ["--data_dir", H2H, "--img_size", str(SIZE), "--limit", "1",
            "--n_iters", "3", "--beam_size", "1", "--n_starts", "1",
            "--num_D", "1", "--n_layers_D", "1"] + _TINY
    a = plan_fivek.plan_parser().parse_args(args + ["--device", "cpu"])
    vocab2id, _, w2v = common.build_vocab_only(a)
    actor, _ = common.build_actor(a, len(vocab2id), w2v)
    bundle = DiscBundle(a.n_layers * 2 * a.hidden_size, n_layers=1,
                        num_D=1)
    init_torch_defaults(bundle, torch.Generator().manual_seed(5))
    sd = {f"actor.{k}": v for k, v in actor.state_dict().items()}
    sd.update(bundle.state_dict())
    ckpt = str(tmp_path / "model.pth")
    torch.save(sd, ckpt)

    disc = ["--dist_type", "seq2seqGAN-disc", "--torch_gan_ckpt", ckpt]
    assert plan_fivek.main(args + disc + ["--device", "cpu", "--out_dir",
                                          str(tmp_path / "port")]) == 1
    jplan.main(args + disc + ["--cpu", "--out_dir", str(tmp_path / "jax")])
    _assert_layouts_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(SystemExit):
        plan_fivek.main(args + disc + ["--device", "cpu", "--pair_batch",
                                       "2"])


@pytest.mark.parametrize("kind", ["ActVisualize", "ActDVisualize"])
def test_fivek_visualize_items_match_jax(kind, tmp_path):
    """Native-resolution items with the top planner sequence whole; the D
    variant reads seq2seqGAN-disc_ops.json (here a copy of the committed
    planner JSONs)."""
    act_dir = ACTS
    if kind == "ActDVisualize":
        act_dir = str(tmp_path)
        for i in range(2):
            os.makedirs(tmp_path / f"train{i}")
            shutil.copy(os.path.join(ACTS, f"train{i}", f"{i:05d}.json"),
                        tmp_path / f"train{i}" / "seq2seqGAN-disc_ops.json")
    port = getattr(fivek, f"FiveK{kind}")(FIVEK_IMGS, FIVEK_ANNO, act_dir,
                                          "train")
    want = getattr(jfivek, f"FiveK{kind}")(FIVEK_IMGS, FIVEK_ANNO, act_dir,
                                           "train")
    assert len(port) == len(want)
    for i in range(2):
        got, exp = port[i], want[i]
        assert len(got) == len(exp) == 6
        assert min(got[0].shape[1:]) == 600
        for g, w in zip(got[:5], exp[:5]):
            np.testing.assert_array_equal(g, w)
        assert got[5] == exp[5]
