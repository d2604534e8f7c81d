"""The port's planner (`t2onet_tpu_torch.planner`, `cli.plan_fivek`,
`cli.plan_gier`) against the JAX package's, on the CPU at 16 px.

The same seeded numpy inputs (real FiveK train pairs, resized; real GIER
pairs and their local masks) go through both. Tolerances:
- `init_candidates`: equal bit for bit (both draw from numpy);
- `fit_op_params_sel`: distances within 1e-5, parameters within 1e-3:
  the port writes optax's Adam step out in f32 and takes jnp.abs's
  gradient at 0, so what differs is the operators' last bits, which an
  L1 fit's kinks grow over the iterations (measured 3e-7 and 1e-6 on
  the first FiveK train pairs); curve knots are ill-conditioned (many
  knot vectors give almost the same image), so their gap is the largest;
- `fit_select_update`: the same selected beams and ops (ties built on
  purpose: identical beam rows, parameterless ops, equal restarts), the
  next beam buffer and the distances within 1e-5;
- beam searches: the same op sequences, distances within 1e-4;
- the uint8 replay wire: equal byte for byte.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.data import fivek as jfivek
from t2onet_tpu.data import gier as jgier
from t2onet_tpu.planner import beam as jbeam
from t2onet_tpu.planner import fit as jfit
from t2onet_tpu.planner import generate as jgenerate
from t2onet_tpu_torch.cli import plan_fivek, plan_gier
from t2onet_tpu_torch.data import gier
from t2onet_tpu_torch.planner import beam, fit, generate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2H = os.path.join(ROOT, "data_real_h2h")
FIVEK_IMGS = os.path.join(H2H, "FiveK", "images")
FIVEK_ANNO = os.path.join(H2H, "FiveK", "annotations")
GIER_DATA = os.path.join(ROOT, "data_real_gier")
SIZE = 16
ITERS = 20


def fivek_pairs(n, size=SIZE):
    """(inputs, targets, requests): the first n FiveK train pairs."""
    ds = jfivek.FiveK(FIVEK_IMGS, FIVEK_ANNO, "train", 1, size)
    items = [ds[i] for i in range(n)]
    return (np.stack([it[0] for it in items]),
            np.stack([it[1] for it in items]), [it[3] for it in items])


# GIER shapeAlign train pairs whose edits are local (masks on ops 7, 4, 4)
LOCAL = (7, 9, 10)


def gier_pairs(ids, size=SIZE):
    """(inputs, targets, per-pair {executor op: (1, H, W) mask}): GIER
    shapeAlign train pairs by index, as plan_gier loads them."""
    g = jgier.GIER(os.path.join(GIER_DATA, "GIER"),
                   os.path.join(GIER_DATA, "language"), "train",
                   data_mode="shapeAlign", is_load_mask=True,
                   train_img_size=size)
    xs, ys, masks = [], [], []
    for i in ids:
        item = g.get_pair_item(i)
        xs.append(item["input"])
        ys.append(item["output"])
        masks.append({int(k) - 3: m[None].astype(np.float32)
                      for k, m in item["mask_dict"].items()})
    return np.stack(xs), np.stack(ys), masks


def _masks_np(kind, n, n_ops, seed=3):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    shape = (n_ops, 1, SIZE, SIZE) if kind == "shared" else \
        (n, n_ops, 1, SIZE, SIZE)
    m = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    m[..., :4, :] = 0.5                               # fractional rows
    return m


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ops,n_starts,key", [
    ((0, 1, 2, 3, 5, 6), 2, 10), ((0, 1, 2, 3, 4, 5, 6, 7), 3, None),
    ((5, 3), 1, 7)])
def test_init_candidates_equal_jax(ops, n_starts, key):
    got = fit.init_candidates(ops, n_starts, key=key)
    want = jfit.init_candidates(ops, n_starts, key=key)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fit.candidate_op_slots(ops, n_starts),
                                  jfit.candidate_op_slots(ops, n_starts))


@pytest.mark.parametrize("dist,masks", [("l1", None), ("l2", None),
                                        ("l1", "shared"), ("l1", "per_row")])
def test_fit_op_params_sel_matches_jax(dist, masks):
    x, y, _ = fivek_pairs(2)
    ops = (0, 1, 2, 3, 4, 5, 6, 7) if masks else fit.DEFAULT_PLAN_OPS
    init = fit.init_candidates(ops, 2, key=10)
    m = _masks_np(masks, 2, len(ops))
    jp, jd = jfit.fit_op_params_sel(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(init), ops, 2,
        n_iters=ITERS, lr=0.05, dist=dist,
        masks=None if m is None else jnp.asarray(m))
    pp, pd = fit.fit_op_params_sel(_t(x), _t(y), _t(init), ops, 2,
                                   n_iters=ITERS, lr=0.05, dist=dist,
                                   masks=_t(m))
    assert pp.shape == (2, 2 * len(ops), 24) and pd.shape == (2, 2 * len(ops))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=0, atol=1e-3)
    outs = fit.execute_candidates_sel(_t(x), pp, ops, 2, _t(m))
    jouts = jfit.execute_candidates_sel(
        jnp.asarray(x), jnp.asarray(pp.numpy()), ops, 2,
        None if m is None else jnp.asarray(m))
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), rtol=0,
                               atol=1e-5)


def test_abs_gradient_at_zero_matches_jnp():
    """The L1 distance's tie rule: jnp.abs passes +1 at 0, torch.abs 0."""
    import jax

    from t2onet_tpu_torch.ops.color import abs_

    v = np.asarray([-2.0, -0.0, 0.0, 3.0, np.nan], np.float32)
    t = torch.from_numpy(v.copy()).requires_grad_()
    abs_(t).sum().backward()
    want = jax.grad(lambda a: jnp.abs(a).sum())(jnp.asarray(v))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(abs_(t).detach().numpy(), np.abs(v))


def _select_case(ties):
    """(imgs (P,B,3,H,W), targets, init, allow, min_dists, ops, masks) of
    one lockstep step. With ties: beam rows 0 and 1 are one image, the
    ops include the parameterless inpaint and white (equal distances
    across restarts) and every restart starts from the same row, so the
    selection must break ties by the lowest index and the first argmin."""
    x, y, _ = fivek_pairs(2)
    rng = np.random.default_rng(4)
    imgs = np.stack([x, np.clip(x * 1.1, 0, 1),
                     np.clip(x * 0.9 + 0.05, 0, 1)], 1).astype(np.float32)
    if ties:
        imgs[:, 1] = imgs[:, 0]
        ops = (4, 7, 0, 2)
        init = np.repeat(fit.init_candidates(ops, 1), 2, axis=0)
        allow = np.ones((2, 3, len(ops)), bool)
        allow[0, 2, 0] = False
        allow[1] = False                      # two equal candidates, then
        allow[1, :2, 0] = True                # rejected ones (+inf)
        min_d = np.asarray([np.inf, np.inf], np.float32)
        masks = None
    else:
        ops = fit.DEFAULT_PLAN_OPS
        init = fit.init_candidates(ops, 2, key=3)
        allow = rng.uniform(size=(2, 3, len(ops))) > 0.3
        min_d = np.asarray([np.inf, 0.05], np.float32)
        masks = _masks_np("per_row", 2, len(ops))
    return imgs, y, init, allow, min_d, ops, masks


@pytest.mark.parametrize("ties", [False, True])
def test_fit_select_update_matches_jax(ties):
    imgs, y, init, allow, min_d, ops, masks = _select_case(ties)
    beam_size = 4
    jout = jfit.fit_select_update(
        jnp.asarray(imgs), jnp.asarray(y), jnp.asarray(init),
        jnp.asarray(allow), jnp.asarray(min_d), ops, 2, beam_size,
        n_iters=ITERS, lr=0.05,
        masks=None if masks is None else jnp.asarray(masks))
    pout = fit.fit_select_update(
        _t(imgs), _t(y), _t(init), _t(allow), _t(min_d), ops, 2, beam_size,
        n_iters=ITERS, lr=0.05, masks=_t(masks))
    buf, sel_d, sel_p, sel_b, sel_pos = [np.asarray(a) for a in jout]
    np.testing.assert_array_equal(pout[3].numpy(), sel_b)
    np.testing.assert_array_equal(pout[4].numpy(), sel_pos)
    np.testing.assert_allclose(pout[1].numpy(), sel_d, rtol=0, atol=1e-5)
    fin = np.isfinite(sel_d)
    np.testing.assert_allclose(pout[2].numpy()[fin], sel_p[fin], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(pout[0].numpy(), buf, rtol=0, atol=1e-5)
    if ties:
        # the case holds ties JAX's selection had to break
        row = sel_d[0][np.isfinite(sel_d[0])]
        assert len(np.unique(row)) < len(row)
        assert (~fin).any()


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _assert_plans_match(got, want):
    assert len(got) == len(want)
    for g_beam, w_beam in zip(got, want):
        assert [a[0] for a in g_beam] == [a[0] for a in w_beam]
        np.testing.assert_allclose([a[2] for a in g_beam],
                                   [a[2] for a in w_beam], rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["plain", "fixed", "eps", "masked"])
def test_batch_beam_search_matches_jax(mode):
    if mode == "masked":
        x, y, op_masks = gier_pairs(LOCAL)
        assert all(op_masks)
        kw = dict(operations=tuple(range(8)), max_step=3, err=1e-3,
                  op_masks=op_masks)
    else:
        x, y, _ = fivek_pairs(3)
        kw = {"fixed": dict(mode="fixed", operations=(5, 0, 1)),
              "eps": dict(mode="eps", eps=0.5, max_step=3),
              "plain": dict(max_step=4)}[mode]
    kw.update(n_iters=ITERS, seed=12)
    want = jbeam.batch_beam_search(x, y, **kw)
    got = beam.batch_beam_search(x, y, device="cpu", **kw)
    for (ga, gi), (wa, wi) in zip(got, want):
        _assert_plans_match(ga, wa)
        assert [len(b) for b in gi] == [len(b) for b in wi]


@pytest.mark.parametrize("mode", ["plain", "eps"])
def test_beam_search_matches_jax(mode):
    x, y, _ = fivek_pairs(1)
    _, _, op_masks = gier_pairs(LOCAL[1:2])
    kw = dict(mode=mode, eps=0.5, max_step=3, n_iters=ITERS, seed=5,
              operations=(0, 1, 3, 5, 6), op_masks=op_masks[0])
    wa, wi = jbeam.beam_search(x, y, **kw)
    ga, gi = beam.beam_search(x, y, device="cpu", **kw)
    _assert_plans_match(ga, wa)
    for gb, wb in zip(gi, wi):
        assert len(gb) == len(wb)
        for g, w in zip(gb, wb):
            assert g.shape == w.shape == (1, 3, SIZE, SIZE)


def test_unported_arguments_raise():
    """A mesh with a learned distance raises, as in JAX (sharded planning
    itself: tests/test_torch_parallel.py). A learned distance is no pixel
    dist_type, as in JAX: it goes through score_fn, which beam_search
    takes (tests/test_torch_gan_planner.py)."""
    from t2onet_tpu_torch.parallel.mesh import make_mesh

    x, y, _ = fivek_pairs(1)
    with pytest.raises(ValueError, match="mesh and score_fn"):
        beam._fit_step(x, y, [0], 1, 1, 0.05, 0, device="cpu",
                       score_fn=lambda outs, aux: outs.mean(),
                       mesh=make_mesh(n_devices=2, device="cpu"))
    with pytest.raises(ValueError, match="score_fn"):
        beam.normalize_dist_type("seq2seqGAN-disc")
    assert beam.normalize_dist_type("L2") == "l2"


@pytest.mark.parametrize("masked", [False, True])
def test_replay_uint8_wire_equals_jax(masked):
    """Every op at its fitted-like params, sequences of unequal length
    (identity padding), with and without per-pair masks."""
    x, y, op_masks = gier_pairs(LOCAL[:2])
    rng = np.random.default_rng(6)
    names = beam.OP_NAMES
    actions = []
    for pi in range(2):
        beams = []
        for b in range(2):
            seq = []
            for op in rng.permutation(8)[: 3 + b + pi]:
                k = jfivek.ACT2PN[names[op]] or 1
                p = rng.uniform(0.2, 1.2, k) if names[op] in ("color",
                                                               "tone") \
                    else rng.uniform(-0.6, 0.6, k)
                seq.append((names[op], p.astype(np.float32).tolist(), 0.1))
            beams.append(seq)
        actions.append(beams)
    m = op_masks if masked else None
    for wire in (True, False):
        want = jbeam._replay_images_batch(x, actions, m, max_beams=None,
                                          uint8_wire=wire)
        got = beam._replay_images_batch(x, actions, m, uint8_wire=wire,
                                        device="cpu")
        for gp, wp in zip(got, want):
            for gb, wb in zip(gp, wp):
                assert len(gb) == len(wb)
                for g, w in zip(gb, wb):
                    if wire:
                        np.testing.assert_array_equal(
                            np.round(g * 255).astype(np.uint8),
                            np.round(w * 255).astype(np.uint8))
                    else:
                        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    one = beam._replay_images_batch(x, actions, m, max_beams=1,
                                    uint8_wire=True, device="cpu")
    assert [len(b) for b in one[0]] == [len(actions[0][0]), 0]


# ---------------------------------------------------------------------------
# dataset planning and the CLIs
# ---------------------------------------------------------------------------

def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = \
                os.path.join(d, f)
    return out


def _assert_layouts_match(got_dir, want_dir, json_name=None):
    got, want = _tree(got_dir), _tree(want_dir)
    assert sorted(got) == sorted(want) and got
    for rel in sorted(want):
        if not rel.endswith(".json"):
            continue
        with open(got[rel]) as f:
            g = json.load(f)
        with open(want[rel]) as f:
            w = json.load(f)
        assert list(g) == list(w) == ["request", "init distance",
                                      "operation sequence"]
        assert g["request"] == w["request"]
        np.testing.assert_allclose(g["init distance"], w["init distance"],
                                   rtol=0, atol=1e-6)
        _assert_plans_match(g["operation sequence"], w["operation sequence"])


def test_plan_dataset_batched_writes_jax_layout(tmp_path):
    """Three pairs in lockstep batches of 2: a full batch and a padded
    tail, each with its own seed."""
    x, y, reqs = fivek_pairs(3)
    pairs = [(x[i:i + 1], y[i:i + 1], reqs[i]) for i in range(3)]
    kw = dict(pair_batch=2, seed=10, n_iters=ITERS, max_step=3)
    n = generate.plan_dataset_batched(pairs, str(tmp_path / "port"),
                                      device="cpu", **kw)
    jn = jgenerate.plan_dataset_batched(pairs, str(tmp_path / "jax"), **kw)
    assert n == jn == 3
    _assert_layouts_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.path.exists(tmp_path / "port" / "train2" / "00002.json")


def test_plan_fivek_cli_matches_jax(tmp_path):
    """The port's CLI on the CPU against JAX's on the real FiveK train
    pairs: one pair alone, the single-pair path."""
    from t2onet_tpu.cli import plan_fivek as jplan

    common = ["--data_dir", H2H, "--img_size", str(SIZE), "--limit", "1",
              "--n_iters", str(ITERS), "--start", "1"]
    assert plan_fivek.main(common + ["--device", "cpu", "--out_dir",
                                     str(tmp_path / "port")]) == 1
    jplan.main(common + ["--cpu", "--out_dir", str(tmp_path / "jax")])
    _assert_layouts_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert os.path.exists(tmp_path / "port" / "train1" / "00001.json")


@pytest.mark.parametrize("flag", [["--data_parallel", "2"]])
def test_plan_fivek_refuses_unported_flags(flag):
    """--data_parallel parses, and plan_fivek refuses it without a
    lockstep batch, as JAX's does (the sharded planner itself:
    tests/test_torch_parallel.py)."""
    assert plan_fivek.plan_parser().parse_args(flag).data_parallel == 2
    with pytest.raises(SystemExit, match="--pair_batch > 1"):
        plan_fivek.main(flag + ["--device", "cpu", "--synthetic"])


@pytest.mark.parametrize("flag, dest, value", [
    (["--dist_type", "seq2seqGAN-disc"], "dist_type", "seq2seqgan-disc"),
    (["--dist_type", "disc"], "dist_type", "seq2seqgan-disc"),
    (["--disc_run_dir", "x"], "disc_run_dir", "x"),
    (["--torch_gan_ckpt", "x"], "torch_gan_ckpt", "x")])
def test_plan_fivek_takes_the_disc_flags(flag, dest, value):
    """The learned distance's flags parse; plan_gier's --dist_type stays
    a pixel distance, as JAX's."""
    assert getattr(plan_fivek.plan_parser().parse_args(flag), dest) == value
    with pytest.raises(SystemExit):
        plan_gier.plan_parser().parse_args(["--dist_type",
                                            "seq2seqGAN-disc"])


@pytest.mark.parametrize("flag", ["--inpaint_ckpt", "--edgeconnect_dir"])
def test_plan_gier_refuses_unported_flags(flag, tmp_path):
    """An inpaint filler captures one pair's mask: with --pair_batch, or
    beside the other filler, the CLI refuses it before planning."""
    base = ["--device", "cpu", "--out_dir", str(tmp_path), flag, "x"]
    other = "--edgeconnect_dir" if flag == "--inpaint_ckpt" else \
        "--inpaint_ckpt"
    for extra, why in ((["--pair_batch", "2"], "one at a time"),
                       ([other, "y"], "pick one")):
        with pytest.raises(SystemExit) as e:
            plan_gier.main(base + extra)
        assert why in str(e.value.code)


def test_plan_fivek_cli_on_synthetic_pairs(tmp_path):
    """--synthetic plans the synthetic set's (input, final image) pairs,
    lockstep-batched with a padded tail."""
    n = plan_fivek.main(["--synthetic", "--device", "cpu", "--synthetic_n",
                         "3", "--img_size", str(SIZE), "--n_iters", "5",
                         "--pair_batch", "2", "--out_dir", str(tmp_path)])
    assert n == 3
    for i in range(3):
        with open(tmp_path / f"train{i}" / f"{i:05d}.json") as f:
            info = json.load(f)
        assert len(info["operation sequence"]) >= 1
        assert info["init distance"] > 0


def test_plan_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        plan_fivek.main(["--synthetic", "--out_dir", str(tmp_path)])


def test_get_pair_item_matches_jax():
    kw = dict(data_mode="shapeAlign", is_load_mask=True, train_img_size=24)
    args = (os.path.join(GIER_DATA, "GIER"),
            os.path.join(GIER_DATA, "language"), "train")
    pg, jg = gier.GIER(*args, **kw), jgier.GIER(*args, **kw)
    for i in range(3):
        got, want = pg.get_pair_item(i), jg.get_pair_item(i)
        assert sorted(got) == sorted(want)
        for k in ("input", "output"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        for k in ("is_local", "op_idx", "request"):
            assert got[k] == want[k]
        assert sorted(got["mask_dict"]) == sorted(want["mask_dict"])
        for k in want["mask_dict"]:
            np.testing.assert_array_equal(got["mask_dict"][k],
                                          want["mask_dict"][k])


def test_plan_gier_cli_matches_jax(tmp_path, monkeypatch):
    """Two GIER pairs in one lockstep batch with their masks, both
    CLIs. JAX's `plan_gier.main` rebinds `cli.common.add_base_args` for
    the process (`train_gier._patch_parser`): monkeypatch puts it back
    when the test ends."""
    from t2onet_tpu.cli import common as jcommon
    from t2onet_tpu.cli import plan_gier as jplan

    monkeypatch.setattr(jcommon, "add_base_args", jcommon.add_base_args)

    common = ["--data_dir", GIER_DATA, "--data_mode", "shapeAlign",
              "--img_size", str(SIZE), "--limit", "2", "--pair_batch", "2",
              "--n_iters", str(ITERS)]
    assert plan_gier.main(common + ["--device", "cpu", "--out_dir",
                                    str(tmp_path / "port")]) == 2
    jplan.main(common + ["--cpu", "--out_dir", str(tmp_path / "jax")])
    _assert_layouts_match(str(tmp_path / "port"), str(tmp_path / "jax"))
