"""The port's tools and API gaps against the JAX package's:

- `convert.load_torch_checkpoint` and `cli.convert` on a reference
  seq2seqL1 model.pth (tests/test_torch_parity.py's, narrow language
  widths, nonzero second LSTM biases): the restored weights are the
  folded reference bit for bit, the run directory's checkpoint holds
  them, and its greedy rollout equals the actor that JAX's `cli.convert`
  writes for the same file (its `load_torch_checkpoint`: ops equal,
  images within 1e-5); `--kind gan` with a
  reference discriminator, whose `disc/` twin equals JAX's conversion;
- `scripts/torch_export_jax_run.py`: a JAX `create_train_state` saved
  by JAX's CheckpointManager, exported and restored by the port: the
  JAX weights bit for bit (rollouts equal to an actor loaded from JAX's
  arrays in memory), the step, the Adam state;
- `data.preprocess`'s three functions write JAX's files byte for byte;
- `cli.train_supervisor` restarts a crashing command with `--resume`;
- `python -m t2onet_tpu_torch`: JAX's command keys, each a module with
  a main, help and an unknown command's exit code 2;
- the API gaps: `fivek_config`, `gier_config`, `Config.to_json`; GIER's
  COCO-style maps, `OpId2OpIdx`, `load_mask`, `load_mask_feature` (a tiny
  .h5) and `collate`; the one-hot `fit_op_params` and
  `execute_candidates` (params and dists within 1e-5);
- the inpaint fillers' loaders default to the card.
"""

import argparse
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.models.actor import Actor as JActor
from t2onet_tpu_torch.cli import common
from t2onet_tpu_torch.train.checkpoint import restore_actor
from tests.test_torch_parity import build_reference_state_dict

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 23
DIMS = ["--hidden_size", "32", "--word_vec_dim", "32", "--img_size", "32"]


def _port_actor(argv, vocab):
    p = argparse.ArgumentParser()
    common.add_base_args(p)
    return common.build_actor(p.parse_args(argv), vocab)[0]


def _rollouts_close(actor, jax_actor, variables, x, img):
    """Greedy eval rollouts: ops equal, images within 1e-5."""
    want = jax.jit(lambda v, xx, im: jax_actor.apply(
        v, xx, im, sample=False, train=False, method=JActor.episode))(
        variables, jnp.asarray(x), jnp.asarray(img))
    with torch.no_grad():
        got = actor.eval().episode(torch.from_numpy(x.astype(np.int64)),
                                   torch.from_numpy(img))
    np.testing.assert_array_equal(got["ops"].numpy(), np.asarray(want["ops"]))
    np.testing.assert_allclose(got["imgs"].numpy(), np.asarray(want["imgs"]),
                               atol=1e-5, rtol=0)


def _request(b=2, length=17):
    x = np.zeros((b, length), np.int32)
    x[:, :5] = [[1, 5, 9, 7, 2], [1, 12, 2, 0, 0]][:b]
    img = np.random.default_rng(4).uniform(0, 1, (b, 3, 32, 32)).astype(
        np.float32)
    return x, img


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    sd = {k: v.detach().clone() for k, v in
          build_reference_state_dict(VOCAB, wv=32, hid=32).items()}
    assert any(float(v.abs().max()) > 0 for k, v in sd.items()
               if ".rnn.bias_hh_" in k)
    path = str(tmp_path_factory.mktemp("ref") / "model.pth")
    torch.save(sd, path)
    return sd, path


def _assert_folded(actor_sd, ref):
    for k, v in ref.items():
        if ".rnn.bias_hh_" in k:
            assert float(actor_sd[k].abs().max()) == 0.0, k
        elif ".rnn.bias_ih_" in k:
            hh = ref[k.replace("bias_ih_", "bias_hh_")]
            assert torch.equal(actor_sd[k], v + hh), k
        else:
            assert torch.equal(actor_sd[k], v), k


def test_convert_actor_matches_jax(reference_pth, tmp_path):
    """Bit for bit the folded reference; rollouts within 1e-5 of the
    actor JAX's cli.convert writes for the same file."""
    from t2onet_tpu.cli import common as jcommon
    from t2onet_tpu.convert.torch_checkpoint import (
        load_torch_checkpoint as jax_load_torch_checkpoint)
    from t2onet_tpu_torch.cli import convert as convert_cli
    from t2onet_tpu_torch.convert import load_torch_checkpoint

    sd, pth = reference_pth
    actor = _port_actor(DIMS, VOCAB)
    load_torch_checkpoint(pth, actor)
    _assert_folded(actor.state_dict(), sd)

    run = str(tmp_path / "port")
    os.makedirs(os.path.join(run, "seq2seqL1_model"))
    for stale in ("stats.json", "checkpoint_best.pt"):     # an old run's
        with open(os.path.join(run, "seq2seqL1_model", stale), "w") as f:
            f.write("{}")
    argv = ["--torch_ckpt", pth, "--vocab_size", str(VOCAB), "--run_dir",
            run] + DIMS
    with pytest.raises(RuntimeError, match="--device cpu"):
        convert_cli.main(argv)
    convert_cli.main(argv + ["--device", "cpu"])
    restored = _port_actor(DIMS, VOCAB)
    restore_actor(restored, os.path.join(run, "seq2seqL1_model"), "best")
    _assert_folded(restored.state_dict(), sd)

    # the params JAX's cli.convert writes for this file (its CLI run
    # end to end is JAX's slow-tier test_convert_cli_roundtrip)
    params, stats = jax_load_torch_checkpoint(pth)
    p = argparse.ArgumentParser()
    jcommon.add_base_args(p)
    ja, _ = jcommon.build_actor(p.parse_args(DIMS), VOCAB)
    _rollouts_close(restored, ja, {"params": params, "batch_stats": stats},
                    *_request())


def test_convert_gan_writes_the_disc_twin(reference_pth, tmp_path):
    """--kind gan: the actor folded bit for bit, disc/ the reference
    discriminator's state_dict, equal to JAX's conversion of the file."""
    from t2onet_tpu.convert.torch_checkpoint import convert_gan_state_dict
    from t2onet_tpu_torch.cli import convert as convert_cli
    from t2onet_tpu_torch.cli.train_gan import build_disc
    from t2onet_tpu_torch.convert import disc_variables_to_state_dict
    from t2onet_tpu_torch.train.checkpoint import StateCheckpointer

    sd, _ = reference_pth
    ns = argparse.Namespace(n_layers=2, hidden_size=32, n_layers_D=3,
                            num_D=2, manual_seed=3)
    bundle = build_disc(ns, "cpu")
    gan_sd = {f"actor.{k}": v for k, v in sd.items()}
    gan_sd.update({k: v.clone() for k, v in bundle.state_dict().items()})
    pth = str(tmp_path / "gan.pth")
    torch.save(gan_sd, pth)
    run = str(tmp_path / "run")
    convert_cli.main(["--torch_ckpt", pth, "--kind", "gan", "--vocab_size",
                      str(VOCAB), "--run_dir", run, "--device", "cpu"]
                     + DIMS)
    ckpt = os.path.join(run, "seq2seqGAN_model")
    actor = _port_actor(DIMS, VOCAB)
    restore_actor(actor, ckpt, "best")
    _assert_folded(actor.state_dict(), sd)
    disc = StateCheckpointer(os.path.join(ckpt, "disc")).restore("best")
    _, (dp, ds) = convert_gan_state_dict(
        {k: v.numpy() for k, v in gan_sd.items()}, num_D=2, n_layers_D=3)
    want = disc_variables_to_state_dict(dp, ds)
    for k, v in bundle.state_dict().items():
        assert torch.equal(disc[k], v), k
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(want[k], v.numpy()), k
    with pytest.raises(SystemExit, match="no actor weights"):
        torch.save({k: v for k, v in gan_sd.items()
                    if not k.startswith("actor.")}, pth)
        convert_cli.main(["--torch_ckpt", pth, "--kind", "gan",
                          "--vocab_size", str(VOCAB), "--run_dir", run,
                          "--device", "cpu"] + DIMS)


TINY = ["--synthetic", "--img_size", "16", "--hidden_size", "8",
        "--word_vec_dim", "8", "--operator_fc_dim", "8", "--resnet_widths",
        "4,4,8,8", "--vis_feat_dim", "8"]


def test_export_jax_run_restores_in_the_port(tmp_path):
    """An untrained JAX state saved by JAX's CheckpointManager, exported:
    the port restores the JAX weights bit for bit (so its rollouts equal
    those of an actor loaded from JAX's arrays in memory, bit for bit),
    the step, the Adam state and stats.json."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_export_jax_run as export

    from t2onet_tpu.cli import common as jcommon
    from t2onet_tpu.data.synthetic import synthetic_vocab
    from t2onet_tpu.train.checkpoint import CheckpointManager
    from t2onet_tpu.train.loop import create_train_state
    from t2onet_tpu_torch.convert import load_jax_variables
    from t2onet_tpu_torch.train.checkpoint import CheckpointManager as PCM
    from t2onet_tpu_torch.train.loop import TrainState

    vocab = len(synthetic_vocab())
    p = argparse.ArgumentParser()
    jcommon.add_base_args(p)
    ja, _ = jcommon.build_actor(p.parse_args(TINY), vocab)
    js = create_train_state(ja, jax.random.PRNGKey(1),
                            jnp.zeros((1, 17), jnp.int32),
                            jnp.zeros((1, 3, 16, 16)))
    jrun = str(tmp_path / "jax")
    CheckpointManager(os.path.join(jrun, "seq2seqL1_model")).save(
        js, 0, val_dist=0.25)
    out = export.main(["--run_dir", jrun, "--out_dir",
                       str(tmp_path / "port")] + TINY)
    ckpt = str(tmp_path / "port" / "seq2seqL1_model")
    assert sorted(out[ckpt]) == ["checkpoint_best.pt",
                                 "checkpoint_iter00000000.pt"]
    with open(os.path.join(ckpt, "stats.json")) as f:
        assert json.load(f)["best_val_dist"] == 0.25
    actor = _port_actor(TINY + ["--device", "cpu"], vocab)
    state = PCM(ckpt).restore(TrainState(actor), "latest")
    assert state.step == 0
    assert len(state.opt.state) == len(state.params)
    assert all(float(st["exp_avg"].abs().max()) == 0.0
               for st in state.opt.state.values())
    direct = _port_actor(TINY + ["--device", "cpu"], vocab)
    load_jax_variables(direct, jax.tree_util.tree_map(np.array, js.params),
                       jax.tree_util.tree_map(np.array, js.batch_stats))
    for k, v in direct.state_dict().items():
        assert torch.equal(actor.state_dict()[k], v), k
    x, img = _request()
    x, img = torch.from_numpy(x.astype(np.int64)), torch.from_numpy(
        img[:, :, :16, :16].copy())
    with torch.no_grad():
        a, b = actor.eval().episode(x, img), direct.eval().episode(x, img)
    assert torch.equal(a["ops"], b["ops"]) and torch.equal(a["imgs"],
                                                           b["imgs"])


def test_preprocess_writes_jax_files(tmp_path):
    """define_split, build_vocab and save_txt2idx: byte-equal files."""
    from t2onet_tpu.data import preprocess as jpre
    from t2onet_tpu_torch.data import preprocess

    reqs = ["Brighten the image!", "darken the sky", "add some contrast",
            "make it warmer", "x y z"]
    data = [{"input": f"img{i % 9}.jpg", "output": f"out{i}.jpg",
             "request": reqs[i % len(reqs)]} for i in range(30)]
    src = tmp_path / "all.json"
    src.write_text(json.dumps(data))
    vocab = preprocess.build_vocab(reqs)
    assert vocab == jpre.build_vocab(reqs)
    assert preprocess.build_vocab(reqs, 2) == jpre.build_vocab(reqs, 2)
    for mod, name in ((jpre, "jax"), (preprocess, "port")):
        mod.define_split(str(src), str(tmp_path / name / "splits"), 1)
        mod.save_txt2idx(str(tmp_path / name / "splits"),
                         str(tmp_path / name / "anno"), vocab, 1, max_len=6)
    for sub in ("splits", "anno"):
        for phase in ("train", "val", "test"):
            f = f"{phase}_sess_1.json"
            assert ((tmp_path / "port" / sub / f).read_bytes()
                    == (tmp_path / "jax" / sub / f).read_bytes()), (sub, f)


def test_supervisor_restarts_with_resume(tmp_path):
    marker = tmp_path / "count"
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        p = {str(marker)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, 'w').write(str(n + 1))
        # crash twice, succeed the third time, with --resume on retries
        if n < 2:
            sys.exit(1)
        assert '--resume' in sys.argv
    """))
    r = subprocess.run(
        [sys.executable, "-m", "t2onet_tpu_torch.cli.train_supervisor",
         "--backoff", "0.05", "--max_restarts", "3", "--",
         sys.executable, str(script)],
        capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert marker.read_text() == "3"
    assert r.stdout.count("--resume") == 2
    marker.write_text("0")
    r = subprocess.run(
        [sys.executable, "-m", "t2onet_tpu_torch", "train-supervisor",
         "--backoff", "0.01", "--max_restarts", "1", "--",
         sys.executable, str(script)],
        capture_output=True, text=True, cwd=ROOT)
    assert r.returncode == 1 and "giving up after 1 restarts" in r.stdout


def test_dispatcher_matches_jax(capsys):
    import importlib

    from t2onet_tpu.__main__ import COMMANDS as JCOMMANDS
    from t2onet_tpu_torch.__main__ import COMMANDS, main

    assert list(COMMANDS) == list(JCOMMANDS)
    for cmd, (mod_path, desc) in COMMANDS.items():
        assert (mod_path, desc) == JCOMMANDS[cmd]
        mod = importlib.import_module(f"t2onet_tpu_torch.{mod_path}")
        assert callable(mod.main), cmd
    assert main(["help"]) == 0
    out = capsys.readouterr().out
    assert all(cmd in out for cmd in COMMANDS)
    assert main(["frobnicate"]) == 2
    assert "unknown command" in capsys.readouterr().err


def test_config_gaps_match_jax():
    from t2onet_tpu import config as jconfig
    from t2onet_tpu_torch import config

    assert config.fivek_config().to_json() == jconfig.fivek_config().to_json()
    assert (config.gier_config(session=4).to_json()
            == jconfig.gier_config(session=4).to_json())


@pytest.fixture(scope="module")
def gier_pair():
    from t2onet_tpu.data.gier import GIER as JGIER
    from t2onet_tpu_torch.data.gier import GIER

    args = (os.path.join(ROOT, "data_real_gier", "GIER"),
            os.path.join(ROOT, "data_real_gier", "language"), "train")
    return (JGIER(*args, data_mode="shapeAlign"),
            GIER(*args, data_mode="shapeAlign"))


def test_gier_index_and_masks_match_jax(gier_pair, tmp_path):
    h5py = pytest.importorskip("h5py")
    jg, g = gier_pair
    for name in ("getOp", "getOpReq", "OpId2PairId", "OpReqId2ReqId",
                 "OpReqId2OpId", "ImgId2PairId", "ReqId2PairId",
                 "PairId2ReqId"):
        assert getattr(g, name) == getattr(jg, name), name
    assert [g.OpId2OpIdx(i) for i in g.getOp] == [jg.OpId2OpIdx(i)
                                                  for i in jg.getOp]
    pid = next(i for i, d in enumerate(g.op_data) if os.path.exists(
        os.path.join(g.mask_dir, d["input"].split(".")[0] + "_mask.json")))
    got, want = g.load_mask(pid), jg.load_mask(pid)
    assert len(got) == len(want) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))

    rng = np.random.default_rng(0)
    for grier in (g, jg):
        grier.feature_dir = str(tmp_path)
    name = g.op_data[pid]["input"].split(".")[0] + ".h5"
    with h5py.File(tmp_path / name, "w") as f:
        for key, shape in (("pan_feat", (2, 4)), ("rcnn_feat", (3, 5)),
                           ("cls_inds", (3,)), ("inst_inds", (3,)),
                           ("inst_ids", (3,))):
            f[key] = rng.normal(size=shape).astype(np.float32)
    for a, b in zip(g.load_mask_feature(pid), jg.load_mask_feature(pid)):
        assert np.array_equal(a, b)


def test_load_mask_feature_without_h5py(gier_pair, monkeypatch):
    _, g = gier_pair
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        g.load_mask_feature(0)


def test_collate_matches_jax():
    from t2onet_tpu.data.gier import GIERDataset as JDS
    from t2onet_tpu_torch.data.gier import GIERDataset

    items = [{"input": np.full((3, 2, 2), i, np.float32), "request": f"r{i}",
              "ops": [i, 1], "meta": {"i": i}, "idx": np.arange(3) + i}
             for i in range(3)]
    got, want = GIERDataset.collate(items), JDS.collate(items)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(got[k], want[k]) and got[k].dtype == \
                want[k].dtype
        else:
            assert got[k] == want[k]


def test_one_hot_fit_matches_jax():
    """fit_op_params / execute_candidates against JAX's: params and dists
    within 1e-5 (20 Adam steps, f32)."""
    from t2onet_tpu.planner import fit as jfit
    from t2onet_tpu_torch.planner import fit, fit_op_params

    assert fit_op_params is fit.fit_op_params
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0.1, 0.9, (2, 3, 12, 12)).astype(np.float32)
    tgt = np.clip(imgs * 1.2 + 0.03, 0, 1).astype(np.float32)
    slots = [0, 1, 2, 6]
    onehot = np.eye(9, dtype=np.float32)[np.array(slots) + 1]
    init = fit.init_candidates(slots, 1)
    masks = rng.uniform(0, 1, (len(slots), 1, 12, 12)).astype(np.float32)
    for m in (None, masks):
        for dist in ("l1", "l2"):
            jp, jd = jfit.fit_op_params(
                jnp.asarray(imgs), jnp.asarray(tgt), jnp.asarray(onehot),
                jnp.asarray(init), n_iters=20, dist=dist,
                masks=None if m is None else jnp.asarray(m))
            tp, td = fit.fit_op_params(
                torch.from_numpy(imgs), torch.from_numpy(tgt),
                torch.from_numpy(onehot), torch.from_numpy(init),
                n_iters=20, dist=dist,
                masks=None if m is None else torch.from_numpy(m))
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
            np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
    want = jfit.execute_candidates(jnp.asarray(imgs), jnp.asarray(onehot),
                                   jp)
    got = fit.execute_candidates(torch.from_numpy(imgs),
                                 torch.from_numpy(onehot),
                                 torch.from_numpy(np.array(jp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_filler_loaders_default_to_the_card(tmp_path, monkeypatch):
    """load_inpaint, load_generator and load_edgeconnect called without a
    device raise where PyTorch finds no card; device='cpu' loads."""
    from t2onet_tpu_torch.models import edgeconnect, inpaint

    net = inpaint.InpaintNet(features=4)
    inpaint.save_inpaint(str(tmp_path / "fill"), net)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: inpaint.load_inpaint(str(tmp_path / "fill")),
                 lambda: edgeconnect.load_generator({}, "edge"),
                 lambda: edgeconnect.load_edgeconnect("e.pth", "i.pth",
                                                      None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    loaded = inpaint.load_inpaint(str(tmp_path / "fill"), device="cpu")
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
