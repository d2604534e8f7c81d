"""The port's evaluation against the JAX package's on the CPU: the
metrics (L1, SSIM on the device and on the host, the Frechet distance,
ImageEvaluator) on real FiveK test pairs, the bucketing helpers, the
HTML gallery, the eval CLI's three loops (`test_native_res` on two
FiveK test pairs at native 600 x 600 in a 640 x 640 bucket, `test` and
`test_variance` on the synthetic set) from one converted init, and the
CLIs end to end: `test_fivek.main` from a checkpoint the trainer wrote,
`test_gier.main` on the real GIER test split. Also the precision switch
of the port's entry points, and that none of it imports JAX.

Tolerances: metrics within 1e-5 of JAX's (the same f32 op math; SSIM's
convolutions sum in other orders); `fit_within` within 2e-7 (cv2's
f32 bilinear against the JAX package's C++ resize in double: 1.19e-7
measured, one ulp at 1; bit-exact where JAX falls back to cv2)."""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from t2onet_tpu.cli import test_fivek as jtest_fivek
from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.data.synthetic import SyntheticFiveK as JSyntheticFiveK
from t2onet_tpu.evals import bucketing as jbucketing
from t2onet_tpu.evals import html as jhtml
from t2onet_tpu.evals import metrics as jmetrics
from t2onet_tpu_torch import precision, serve
from t2onet_tpu_torch.cli import common, test_fivek, test_gier, train_fivek
from t2onet_tpu_torch.data import fivek, text
from t2onet_tpu_torch.data.synthetic import SyntheticFiveK, synthetic_vocab
from t2onet_tpu_torch.evals import bucketing, html, metrics
from tests._torch_port import jax_actor, jax_train_state, port_actor

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2H = os.path.join(ROOT, "data_real_h2h")
GIER_DATA = os.path.join(ROOT, "data_real_gier")
GIER_NPY = os.path.join(ROOT, "data_real_gier_acts",
                        "GIER_vocabs_glove_feat_3.npy")
TOL = 1e-5


def _fivek_test():
    return fivek.FiveK(os.path.join(H2H, "FiveK", "images"),
                       os.path.join(H2H, "FiveK", "annotations"), "test")


@pytest.fixture(scope="module")
def pairs():
    """The first 3 FiveK test pairs at native 600 x 600, (1, 3, H, W)."""
    ds = _fivek_test()
    return [(ds[i][0][None], ds[i][1][None]) for i in range(3)]


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL, err_msg=err_msg)


# ---------------------------------------------------------------------------
# metrics and bucketing
# ---------------------------------------------------------------------------

def test_l1_and_ssim_match_jax(pairs):
    x = np.concatenate([p[0] for p in pairs])
    y = np.concatenate([p[1] for p in pairs])
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    _close(float(metrics.l1_distance(tx, ty)),
           float(jmetrics.l1_distance(x, y)))
    per_pair = jmetrics.ssim(x, y, size_average=False)
    _close(metrics.ssim(tx, ty, size_average=False).numpy(), per_pair)
    _close(float(metrics.ssim(tx, ty)), float(np.mean(per_pair)))
    # the host version is the JAX package's code: equal to the bit
    assert metrics.ssim_np(*pairs[0]) == jmetrics.ssim_np(*pairs[0])
    assert metrics.TEST_TXTS == jmetrics.TEST_TXTS


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3, 40, 6))
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in feats]
    # a singular covariance takes the eps-offset retry
    low = np.outer(np.arange(6.0), np.arange(6.0))
    for (m1, s1), (m2, s2) in ((stats[0], stats[1]), (stats[1], stats[2]),
                               ((stats[0][0], low), stats[2])):
        got = metrics.calculate_frechet_distance(m1, s1, m2, s2)
        want = jmetrics.calculate_frechet_distance(m1, s1, m2, s2)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert metrics.calculate_frechet_distance(*stats[0], *stats[0]) < 1e-6


@pytest.mark.parametrize("host_metrics", [True, False])
def test_image_evaluator_matches_jax(pairs, host_metrics):
    port = metrics.ImageEvaluator(host_metrics=host_metrics)
    ref = jmetrics.ImageEvaluator(host_metrics=host_metrics)
    for x, y in pairs:
        out = np.clip(x * 1.1 - 0.02, 0, 1).astype(np.float32)
        args = (x, out, y) if host_metrics else tuple(
            torch.from_numpy(v) for v in (x, out, y))
        one = port.update(*args)
        ref.update(x, out, y)
    _close(one["out_L1"], np.abs(out - y).mean())
    got, want = port.eval(), ref.eval()
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)


def test_bucketing_matches_jax():
    rng = np.random.default_rng(1)
    for shape in ((3, 700, 1500), (3, 1100, 600), (3, 500, 900)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        got, want = bucketing.fit_within(img), jbucketing.fit_within(img)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
        assert max(got.shape[1:]) <= 1024
    assert bucketing.fit_within(img) is img          # it fits: unchanged
    padded, hw = bucketing.pad_to_bucket(img)
    assert padded.shape == (3, 512, 960) and hw == (500, 900)
    np.testing.assert_array_equal(bucketing.crop_valid(padded, hw), img)
    np.testing.assert_array_equal(bucketing.crop_valid(padded, hw),
                                  jbucketing.crop_valid(padded, hw))
    other = np.clip(padded + 0.1, 0, 1)
    _close(bucketing.masked_l1(padded, other, hw),
           jbucketing.masked_l1(padded, other, hw))
    _close(bucketing.masked_l1(torch.from_numpy(padded),
                               torch.from_numpy(other), hw),
           jbucketing.masked_l1(padded, other, hw))


def test_html_matches_jax(tmp_path):
    pages = []
    for mod, name in ((html, "port"), (jhtml, "jax")):
        page = mod.HTML(str(tmp_path / name), "trial <1>", refresh=5)
        page.add_header("[0] make it <brighter>")
        page.add_images(["a.jpg", "b.jpg"], ["input", "tone [1.0]"])
        page.save()
        pages.append((tmp_path / name / "index.html").read_text())
        assert (tmp_path / name / "images").is_dir()
    assert pages[0] == pages[1]


# ---------------------------------------------------------------------------
# the eval loops against JAX's, from one converted init
# ---------------------------------------------------------------------------

def _spy_programs(monkeypatch, programs):
    """Record the op rows of every JAX eval rollout."""
    real = jtest_fivek.make_eval_episode

    def make(actor):
        fn = real(actor)

        def run(state, batch):
            pred, out = fn(state, batch)
            programs.append(np.asarray(out["ops"]).tolist())
            return pred, out

        return run

    monkeypatch.setattr(jtest_fivek, "make_eval_episode", make)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """`test_native_res` on the first 2 FiveK test pairs (600 x 600 in a
    640 x 640 bucket) with the gallery on: JAX's (greedy rollout through
    the bank), then the port's through the bank and through
    `fused_exec`, from one tiny converted init over the real 918-token
    vocabulary."""
    ds = _fivek_test()
    sub = [ds[i] for i in range(2)]
    id2op = text.load_vocab(os.path.join(H2H, "language"), "FiveK", 1)[3]
    cfg = JModelConfig.tiny()
    ja, params, stats = jax_actor(cfg, 918, sub[0][2][None].astype(np.int32),
                                  np.zeros((1, 3, 16, 16), np.float32),
                                  seed=3, knots_near_one=True)
    a = argparse.Namespace(trial=1)
    tmp = tmp_path_factory.mktemp("native")
    jprog = []
    with pytest.MonkeyPatch.context() as mp:
        _spy_programs(mp, jprog)
        jres = jtest_fivek.test_native_res(
            ja, jax_train_state(params, stats, 1e-3), sub, a, id2op,
            run_dir=str(tmp / "jax"), visualize=True)
    actor = port_actor(cfg, 918, params, stats)
    port = {}
    for fused in (False, True):
        records = []
        run_dir = str(tmp / f"port{int(fused)}")
        res = test_fivek.test_native_res(actor, sub, a, id2op,
                                         run_dir=run_dir, visualize=True,
                                         fused_exec=fused, records=records)
        port[fused] = (res, records, run_dir)
    return jres, [p[0] for p in jprog], str(tmp / "jax"), port


@pytest.mark.parametrize("fused", [False, True], ids=["bank", "fused"])
def test_native_res_matches_jax(native, fused):
    jres, jprog, _, port = native
    res, records, _ = port[fused]
    assert [r["ops"] for r in records] == jprog
    assert any(op not in (0, 1, 2) for p in jprog for op in p)
    assert sorted(res) == sorted(jres)
    for k in jres:
        _close(res[k], jres[k], k)
    for r in records:
        assert all(r[k] >= 0 for k in ("load_s", "rollout_s", "metrics_s",
                                       "gallery_s"))


def test_native_res_gallery_matches_jax(native):
    """The same gallery file names and index.html rows as JAX's for the
    pair the gallery shows (pair 0: every 25th)."""
    _, _, jdir, port = native
    pdir = port[False][2]
    names = sorted(os.listdir(os.path.join(pdir, "test", "web", "images")))
    assert names == sorted(os.listdir(os.path.join(jdir, "test", "web",
                                                   "images")))
    assert "00000_attn.png" in names and "00000_gt.jpg" in names
    with open(os.path.join(pdir, "test", "web", "index.html")) as f:
        got = f.read()
    with open(os.path.join(jdir, "test", "web", "index.html")) as f:
        assert got == f.read()


def test_attention_heatmap_without_matplotlib(tmp_path, monkeypatch,
                                              capsys):
    """On a host without matplotlib the heatmap is drawn with cv2, and
    the run says so."""
    import cv2

    from t2onet_tpu_torch.evals import visualize

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    path = str(tmp_path / "00000_attn.png")
    attn = np.random.default_rng(2).uniform(size=(5, 17))
    visualize.show_attention(["<s>", "increase", "brightness", "</s>"],
                             ["tone", "<END>", "contrast"], attn, path)
    assert "drawn with cv2" in capsys.readouterr().out
    img = cv2.imread(path)
    # a 40-px cell per (op, token) below and beside the labels
    assert img.shape[0] > 3 * 40 and img.shape[1] > 4 * 40


@pytest.fixture(scope="module")
def synthetic():
    """The synthetic test set (16 items at 16 px) and one converted tiny
    init in both packages."""
    cfg = JModelConfig.tiny(encoder_max_len=12, decoder_max_len=3)
    kw = dict(n=16, img_size=16, seed=2, req_max_len=12, op_max_len=3)
    jds, ds = JSyntheticFiveK(**kw), SyntheticFiveK(**kw)
    vocab = synthetic_vocab()
    nb = next(ds.batches(2, 1, shuffle=False))
    ja, params, stats = jax_actor(cfg, len(vocab), nb["x"], nb["img_x"],
                                  seed=4, knots_near_one=True)
    return (cfg, jds, ds, vocab, ja, jax_train_state(params, stats, 1e-3),
            port_actor(cfg, len(vocab), params, stats))


@pytest.mark.parametrize("fused", [False, True], ids=["bank", "fused"])
def test_batched_test_and_variance_match_jax(synthetic, fused):
    cfg, jds, ds, vocab, ja, jstate, actor = synthetic
    a = argparse.Namespace(trial=1, encoder_max_len=cfg.encoder_max_len)
    id2op = dict(common.SYNTHETIC_ID2OP)
    jres = jtest_fivek.test(ja, jstate, jds, a, id2op)
    res = test_fivek.test(actor, ds, a, id2op, fused_exec=fused)
    for k in jres:
        _close(res[k], jres[k], k)
    jvar = jtest_fivek.test_variance(ja, jstate, jds, a, vocab, n_images=2)
    recs = []
    var = test_fivek.test_variance(actor, ds, a, vocab, n_images=2,
                                   fused_exec=fused, records=recs)
    assert jvar > 0
    _close(var, jvar)
    assert [len(r["ops"]) for r in recs] == [10, 10]
    _close(np.mean([r["variance"] for r in recs]), var)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

MODEL = ["--device", "cpu", "--synthetic", "--synthetic_n", "16",
         "--img_size", "16", "--encoder_max_len", "12", "--decoder_max_len",
         "3", "--hidden_size", "8", "--word_vec_dim", "8", "--operator_fc_dim",
         "8", "--resnet_widths", "4,4,8,8", "--vis_feat_dim", "8"]


def test_test_fivek_reads_the_trainers_checkpoint(tmp_path, capsys):
    """`test_fivek.main --synthetic` on a run dir of a tiny `train_fivek`
    run reads its checkpoint_best.pt: the metrics are those of the
    trained actor; a run dir without one evaluates the random init."""
    run = str(tmp_path / "run")
    state = train_fivek.main(MODEL + [
        "--run_dir", run, "--batch_size", "4", "--num_iters", "2",
        "--print_every", "2", "--checkpoint_every", "2", "--val_batches",
        "1"])
    assert (tmp_path / "run" / "seq2seqL1_model" / "checkpoint_best.pt") \
        .exists()
    capsys.readouterr()
    res = test_fivek.main(MODEL + ["--run_dir", run, "--visualize", "1"])
    out = capsys.readouterr().out
    assert "loaded checkpoint (best)" in out and "avg var:" in out
    assert "'out_SSIM'" in out and "'variance'" in out
    assert (tmp_path / "run" / "test" / "web" / "images" /
            "00010_attn.png").exists()
    a = test_fivek.eval_parser().parse_args(MODEL)
    ds = common.build_dataset_and_vocab(a, "test")[0]
    want = test_fivek.test(state.actor.eval(), ds, a,
                           dict(common.SYNTHETIC_ID2OP))
    for k in want:
        assert res[k] == want[k], k
    fresh = test_fivek.main(MODEL + ["--run_dir", str(tmp_path / "none"),
                                     "--skip_variance"])
    assert "no checkpoint found" in capsys.readouterr().out
    assert fresh["out_L1"] != res["out_L1"] and "variance" not in fresh


def test_test_gier_runs_on_real_data(tmp_path, monkeypatch):
    """`test_gier.main` with GIER's defaults on the real test split
    (global+shapeAlign: 57 requests at native 600 x 600), through the
    fused step's plain version; the first 2 pairs are rolled out."""
    seen = {}
    real = test_fivek.test_native_res

    def first_two(actor, ds, a, id2op, **kw):
        seen.update(n=len(ds), a=a, records=[])
        return real(actor, [ds[i] for i in range(2)], a, id2op,
                    records=seen["records"], **kw)

    monkeypatch.setattr(test_fivek, "test_native_res", first_two)
    res = test_gier.main(["--device", "cpu", "--data_dir", GIER_DATA,
                          "--glove_path", GIER_NPY, "--hidden_size", "8",
                          "--operator_fc_dim", "8", "--resnet_widths",
                          "4,4,8,8", "--vis_feat_dim", "8", "--n_layers",
                          "1", "--fused_exec", "1", "--skip_variance",
                          "--run_dir", str(tmp_path / "run")])
    a = seen["a"]
    assert (seen["n"], a.dataset, a.session, a.decoder_max_len,
            a.data_mode) == (57, "GIER", 3, 8, "global+shapeAlign")
    assert [len(r["ops"]) for r in seen["records"]] == [8, 8]
    assert all(np.isfinite(v) for v in res.values())
    assert not (tmp_path / "run" / "opt.json").exists()   # read-only


def test_set_cuda_precision_turns_tf32_off(monkeypatch):
    """The entry points' precision switch: TF32 off for matmuls and
    cuDNN, set by `resolve_device` for a CUDA device and by
    `ServingEngine(device="cuda")` (the flags can be set on a CPU
    build)."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        precision.set_cuda_precision()
        assert [f.allow_tf32 for f in flags] == [False, False]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for f in flags:
            f.allow_tf32 = True
        assert common.resolve_device("cuda").type == "cuda"
        assert [f.allow_tf32 for f in flags] == [False, False]
        for f in flags:
            f.allow_tf32 = True
        assert common.resolve_device("cpu").type == "cpu"
        assert [f.allow_tf32 for f in flags] == [True, True]
        calls = []
        monkeypatch.setattr(serve, "set_cuda_precision",
                            lambda: calls.append(1))
        actor = torch.nn.Linear(1, 1)
        monkeypatch.setattr(actor, "to", lambda device: actor)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        serve.ServingEngine(actor, {}, device="cuda")
        assert calls == [1]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_eval_imports_no_jax(tmp_path):
    """The eval modules and CLIs, run end to end, load neither JAX nor
    the JAX package."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import t2onet_tpu_torch.evals.html, t2onet_tpu_torch.evals.metrics\n"
        "import t2onet_tpu_torch.evals.visualize\n"
        "import t2onet_tpu_torch.evals.bucketing, t2onet_tpu_torch.precision\n"
        "import t2onet_tpu_torch.data.fivek, t2onet_tpu_torch.data.gier\n"
        "from t2onet_tpu_torch.cli import test_fivek, test_gier\n"
        f"res = test_fivek.main({MODEL!r} + ['--run_dir', {str(tmp_path)!r},"
        " '--visualize', '1'])\n"
        "assert 'variance' in res\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 't2onet_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
