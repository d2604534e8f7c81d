"""The rest of the port's serving (t2onet_tpu_torch.serve: submit / flush,
the launch / readback pipeline, MicroBatcher, decode_native, the bank
executor, device_compute_probe; cli.serve; cli.demo) against the JAX
package's, on the CPU at tiny widths, loaded with the same weights.

Tolerances: the same op names; params within 1e-5; images within 1e-5
(f32 wire), or 1 LSB on the u8 wire (the batcher against edit_batch:
other micro-batches, other rounding); the demo's program.json params within 1e-4
(rounded to 4 places, so values 1e-6 apart can round 1e-4 apart) and its
JPEGs within 1 level."""

import argparse
import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from t2onet_tpu import config as jconfig
from t2onet_tpu.cli import common as jcommon
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.serve import ServingEngine as JaxEngine
from t2onet_tpu_torch.cli import demo, serve as serve_cli
from t2onet_tpu_torch.serve import MicroBatcher, ServingEngine
from t2onet_tpu_torch.train.checkpoint import CheckpointManager
from t2onet_tpu_torch.train.loop import TrainState
from tests._torch_port import (jax_actor, jax_train_state, jpeg_images,
                               port_actor)

torch.set_num_threads(2)

ATOL = 1e-5
L = 12
CFG = jconfig.ModelConfig.tiny(encoder_max_len=L, decoder_max_len=5)
REQUESTS = ["increase the brightness", "improve contrast",
            "increase saturation", "sharpen the image", "fix the tone",
            "make it brighter and warmer", "reduce the contrast"]
KW = dict(decode_size=32, quantum=32, max_batch=4, encoder_max_len=L)
JAX_FLAGS = {"plain": {}, "decode_native": {"decode_native": True},
             "no_pallas": {"use_pallas": False}}


def _images():
    """Five 32x32 (two micro-batches of one bucket) and two 40x72
    (bucket 64x96); uniform-random and real JPEG pixels."""
    rng = np.random.default_rng(0)
    small = list(rng.uniform(0.05, 0.95, (3, 3, 32, 32)).astype(np.float32))
    small += list(jpeg_images(32, 32)[:2])
    big = [rng.uniform(0.05, 0.95, (3, 40, 72)).astype(np.float32),
           jpeg_images(40, 72)[0]]
    return small + big


@pytest.fixture(scope="module")
def weights():
    """One random init (tests/test_torch_serve.py's seed: five-op
    programs, knots near 1) and the JAX engines, compiled on first use."""
    vocab = synthetic_vocab()
    x = np.zeros((2, L), np.int32)
    x[:, 0] = 1
    img = np.zeros((2, 3, 32, 32), np.float32)
    ja, params, stats = jax_actor(CFG, len(vocab), x, img, seed=2,
                                  knots_near_one=True)
    variables = {"params": params, "batch_stats": stats}
    engines = {name: JaxEngine(ja, variables, vocab, u8_wire=False, **KW,
                               **flags)
               for name, flags in JAX_FLAGS.items()}
    return vocab, params, stats, engines


def _port(weights, **kw):
    vocab, params, stats, _ = weights
    opts = dict(KW, u8_wire=False)
    opts.update(kw)
    return ServingEngine(port_actor(CFG, len(vocab), params, stats), vocab,
                         device="cpu", **opts)


def _same(got, want, img_atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ops == w.ops
        assert g.bucket == w.bucket
        assert len(g.params) == len(w.params)
        for pg, pw in zip(g.params, w.params):
            np.testing.assert_allclose(pg, pw, atol=ATOL, rtol=0)
        assert g.image.shape == w.image.shape and g.image.dtype == np.float32
        np.testing.assert_allclose(g.image, w.image, atol=img_atol, rtol=0)


def test_submit_flush_matches_jax(weights):
    jax_eng, port = weights[3]["plain"], _port(weights)
    imgs = _images()
    jp = [jax_eng.submit(im, r) for im, r in zip(imgs, REQUESTS)]
    jax_eng.flush()
    pp = [port.submit(im, r) for im, r in zip(imgs, REQUESTS)]
    assert port.queue_depth() == len(imgs)
    assert port.oldest_submit() == pp[0].t_submit
    assert port.flush() == len(imgs)
    assert port.queue_depth() == 0 and port.oldest_submit() is None
    assert all(p.done.is_set() and p.error is None for p in pp)
    _same([p.result for p in pp], [p.result for p in jp])
    st = port.stats_snapshot()
    assert (st["requests"], st["batches"]) == (7, 3)
    assert st["launch_s"] > 0 and st["sync_s"] > 0
    assert max(len(p.result.ops) for p in pp) >= 4


@pytest.mark.parametrize("io_threads", [1, 8])
def test_microbatcher_matches_edit_batch(weights, io_threads):
    """Four threads submit; the batcher's results are edit_batch's. Its
    micro-batches may hold other requests than edit_batch's, and the
    CPU's convolutions round by batch, so images within 1 LSB."""
    port = _port(weights, u8_wire=True, io_threads=io_threads)
    imgs = _images()
    want = port.edit_batch(imgs, REQUESTS)
    batcher = MicroBatcher(port, linger_ms=5, pipeline_depth=2).start()
    pending = [None] * len(imgs)

    def client(k):
        for i in range(k, len(imgs), 4):
            pending[i] = port.submit(imgs[i], REQUESTS[i])

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(p.done.wait(timeout=60) for p in pending)
    finally:
        batcher.stop()
    assert not batcher._thread.is_alive()
    assert port.queue_depth() == 0
    got = [p.result for p in pending]
    _same(got, want, img_atol=1.0 / 255 + 1e-6)


@pytest.mark.parametrize("flag", ["decode_native", "no_pallas"])
def test_engine_flags_match_jax(weights, flag):
    """decode_native (the decode on the padded native stack) and the bank
    executor against the JAX engine with the same flag."""
    kw = dict(JAX_FLAGS[flag])
    port = _port(weights, **kw)
    imgs = _images()
    _same(port.edit_batch(imgs, REQUESTS),
          weights[3][flag].edit_batch(imgs, REQUESTS))


def test_failures_mark_requests_and_keep_serving(weights):
    """A flush whose batch raises marks its requests and returns; a
    batcher whose launch raises marks that batch and serves the next."""
    port = _port(weights)
    real_process, real_launch = port._process, port.launch

    def boom(pending):
        raise RuntimeError("kaboom")

    port._process = boom
    p = port.submit(np.full((3, 32, 32), 0.5, np.float32), "brighten")
    assert port.flush() == 1
    assert p.done.is_set() and isinstance(p.error, RuntimeError)
    assert p.result is None
    port._process = real_process

    calls = []

    def launch_once_failing(pending):
        calls.append(len(pending))
        if len(calls) == 1:
            raise RuntimeError("kaboom")
        return real_launch(pending)

    port.launch = launch_once_failing
    batcher = MicroBatcher(port, linger_ms=1).start()
    try:
        bad = port.submit(np.full((3, 32, 32), 0.5, np.float32), "brighten")
        assert bad.done.wait(timeout=60)
        good = port.submit(np.full((3, 32, 32), 0.5, np.float32), "brighten")
        assert good.done.wait(timeout=60)
    finally:
        batcher.stop()
    assert isinstance(bad.error, RuntimeError) and bad.result is None
    assert good.error is None and good.result.image.shape == (3, 32, 32)


def test_device_compute_probe_keys(weights):
    port = _port(weights)
    got = port.device_compute_probe(size=32, iters=1)
    want = weights[3]["plain"].device_compute_probe(size=32, iters=1)
    assert set(got) == set(want)
    assert got["probe_batch"] == want["probe_batch"] == KW["max_batch"]
    assert got["img"] == want["img"] == "32px"
    assert 0 < got["device_ms_per_req"] <= got["device_ms_per_batch"]


def _png_b64(img_chw):
    from PIL import Image

    arr = (np.clip(img_chw.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _call(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body
                                 is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_handler(weights):
    """POST /edit on an ephemeral port behind the batcher: 200 with a PNG
    of the input's shape; 404 for other paths; 400 for a bad body;
    /healthz counts the request."""
    from PIL import Image

    port = _port(weights)
    server, batcher = serve_cli.make_server(port, 0, linger_ms=2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        img = _images()[5]
        code, out = _call(f"{base}/edit", json.dumps(
            {"request": "increase the brightness",
             "image_b64": _png_b64(img)}).encode())
        assert code == 200, out
        png = Image.open(io.BytesIO(base64.b64decode(out["image_b64"])))
        assert png.size == (img.shape[2], img.shape[1])
        assert all(op in demo.OP_NAMES for op in out["ops"])
        assert _call(f"{base}/nope")[0] == 404
        assert _call(f"{base}/other", b"{}")[0] == 404
        assert _call(f"{base}/edit", b"not json")[0] == 400
        code, health = _call(f"{base}/healthz")
        assert code == 200 and health["stats"]["requests"] == 1
    finally:
        server.shutdown()
        batcher.stop()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


TINY = ["--synthetic", "--encoder_max_len", "12", "--decoder_max_len", "5",
        "--hidden_size", "8", "--word_vec_dim", "8", "--operator_fc_dim", "8",
        "--resnet_widths", "4,4,8,8", "--vis_feat_dim", "8"]


def test_serve_cli_bench(tmp_path, capsys):
    """`cli.serve --bench` prints the JAX CLI's JSON line; without a card
    the default device raises."""
    argv = TINY + ["--run_dir", str(tmp_path), "--bench", "4", "--img_size",
                   "32", "--max_batch", "2", "--decode_size", "32"]
    serve_cli.main(argv + ["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "32px serving requests/sec/chip"
    assert line["unit"] == "req/s" and line["value"] > 0
    assert set(line["detail"]) == {"n", "batch", "io_threads", "launch_s",
                                   "sync_s", "mean_program_len",
                                   "device_compute"}
    assert line["detail"]["device_compute"]["probe_batch"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve_cli.main(argv)


def _jax_demo_weights(argv):
    """The config JAX's demo builds from argv, a random init for it in
    both packages."""
    p = argparse.ArgumentParser()
    jcommon.add_base_args(p)
    a, _ = p.parse_known_args(argv)
    _, cfg = jcommon.build_actor(a, len(synthetic_vocab()), None)
    x = np.zeros((1, a.encoder_max_len), np.int32)
    x[:, 0] = 1
    img = np.zeros((1, 3, a.img_size, a.img_size), np.float32)
    return cfg.model, jax_actor(cfg.model, len(synthetic_vocab()), x, img,
                                seed=2, knots_near_one=True)


def _jpeg_levels(a, b):
    from PIL import Image

    return int(np.abs(np.asarray(Image.open(a), np.int32)
                      - np.asarray(Image.open(b), np.int32)).max())


def test_demo_matches_jax(tmp_path, monkeypatch):
    """cli.demo in decode mode (the run dir's checkpoint) and in --program
    mode with --mask and --inpaint_ckpt, against the JAX demo."""
    from PIL import Image

    import jax

    from t2onet_tpu.cli import demo as jdemo
    from t2onet_tpu.models import inpaint as jinpaint
    from t2onet_tpu_torch.convert import load_jax_inpaint
    from t2onet_tpu_torch.models import inpaint

    argv = TINY + ["--img_size", "16", "--request", "increase the brightness"]
    cfg, (_, params, stats) = _jax_demo_weights(argv)
    monkeypatch.setattr(jdemo, "create_train_state",
                        lambda *a, **k: jax_train_state(params, stats, 1e-3))
    run = tmp_path / "run"
    actor = port_actor(cfg, len(synthetic_vocab()), params, stats)
    CheckpointManager(str(run / "seq2seqL1_model")).save(
        TrainState(actor), 0, val_dist=0.0)
    jdemo.main(argv + ["--run_dir", str(tmp_path / "jrun"), "--out_dir",
                       str(tmp_path / "jax")])
    steps = demo.main(argv + ["--device", "cpu", "--run_dir", str(run),
                              "--out_dir", str(tmp_path / "port")])
    with open(tmp_path / "port" / "program.json") as f:
        assert json.load(f)["steps"] == steps and len(steps) >= 2

    # --program with a mask and a trained filler, from one init
    net = jinpaint.InpaintNet(features=4, dilations=(2, 2))
    fparams = jax.tree_util.tree_map(np.asarray, net.init(
        jax.random.PRNGKey(0), np.zeros((1, 3, 16, 16), np.float32),
        np.zeros((1, 1, 16, 16), np.float32)))
    jinpaint.save_inpaint(str(tmp_path / "jck"), net, fparams)
    pnet = inpaint.InpaintNet(features=4, dilations=(2, 2))
    load_jax_inpaint(pnet, fparams)
    inpaint.save_inpaint(str(tmp_path / "pck"), pnet)
    mask = np.zeros((16, 16), np.uint8)
    mask[4:12, 3:11] = 255
    Image.fromarray(mask).save(tmp_path / "mask.png")
    prog = ["--program", json.dumps([["brightness", [0.2]], ["inpaint", []],
                                     ["tone", [1.2, 0.8, 1.0, 1.1, 0.9, 1.0,
                                               1.3, 0.7]]]),
            "--mask", str(tmp_path / "mask.png")]
    jdemo.main(argv + prog + ["--run_dir", str(tmp_path / "jrun"),
                              "--out_dir", str(tmp_path / "jprog"),
                              "--inpaint_ckpt", str(tmp_path / "jck")])
    demo.main(argv + prog + ["--device", "cpu", "--run_dir", str(run),
                             "--out_dir", str(tmp_path / "pprog"),
                             "--inpaint_ckpt", str(tmp_path / "pck")])

    for jdir, pdir, key in (("jax", "port", "steps"),
                            ("jprog", "pprog", "program")):
        with open(tmp_path / jdir / "program.json") as f:
            want = json.load(f)[key]
        with open(tmp_path / pdir / "program.json") as f:
            got = json.load(f)[key]
        assert [s["op"] for s in got] == [s["op"] for s in want]
        for g, w in zip(got, want):
            assert g.get("vocab_token") == w.get("vocab_token")
            np.testing.assert_allclose(g["params"], w["params"], atol=1e-4,
                                       rtol=0)
        names = ["input.jpg", "output.jpg"] + [f"step{i}.jpg"
                                               for i in range(len(got))]
        for name in names:
            assert _jpeg_levels(tmp_path / jdir / name,
                                tmp_path / pdir / name) <= 1, (jdir, name)
    # the filler changed the hole
    s0 = np.asarray(Image.open(tmp_path / "pprog" / "step0.jpg"), np.float32)
    s1 = np.asarray(Image.open(tmp_path / "pprog" / "step1.jpg"), np.float32)
    assert np.abs(s1[4:12, 3:11] - s0[4:12, 3:11]).max() > 1.0


@pytest.mark.parametrize("cli", ["demo", "train_inpaint"])
def test_entry_points_default_to_the_card(cli, tmp_path):
    """--device defaults to cuda; without a card the CLI raises rather than
    run on the CPU."""
    from t2onet_tpu_torch.cli import train_inpaint

    mod = {"demo": demo, "train_inpaint": train_inpaint}[cli]
    parser = demo.demo_parser() if cli == "demo" else mod.build_parser()
    assert parser.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main(TINY + ["--run_dir", str(tmp_path)])
