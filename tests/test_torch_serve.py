"""The port's serving engine (t2onet_tpu_torch.serve) against the JAX
package's ServingEngine, built as tests/test_serve.py builds it and
loaded with the same weights: same op names, params within 1e-5, float
images within 1e-5 and u8 images within 1 LSB, over two shape buckets
and more requests than one micro-batch. Also the pieces the engine is
made of: the probe resize, the buckets, the tokenizer and the config."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from t2onet_tpu import config as jconfig
from t2onet_tpu.data.synthetic import synthetic_vocab
from t2onet_tpu.data.text import txt2idx as jax_txt2idx
from t2onet_tpu.evals import bucketing as jbucketing
from t2onet_tpu.serve import ServingEngine as JaxEngine
from t2onet_tpu_torch import config as pconfig
from t2onet_tpu_torch.data.text import txt2idx
from t2onet_tpu_torch.evals import bucketing
from t2onet_tpu_torch.serve import ServingEngine, resize_bilinear
from tests._torch_port import jax_actor, jpeg_images, port_actor

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
L = 12
CFG = jconfig.ModelConfig.tiny(encoder_max_len=L, decoder_max_len=5)
REQUESTS = ["increase the brightness", "improve contrast",
            "increase saturation", "sharpen the image", "fix the tone",
            "make it brighter and warmer", "reduce the contrast"]
KW = dict(decode_size=32, quantum=32, max_batch=4, encoder_max_len=L)


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
def engines():
    vocab = synthetic_vocab()
    x = np.zeros((2, L), np.int32)
    x[:, 0] = 1
    img = np.zeros((2, 3, 32, 32), np.float32)
    # seed 2: five-op programs with color, contrast, sharpness, brightness
    # and saturation; knots near 1 keep the curves well conditioned
    ja, params, stats = jax_actor(CFG, len(vocab), x, img, seed=2,
                                  knots_near_one=True)
    variables = {"params": params, "batch_stats": stats}
    jax_f32 = JaxEngine(ja, variables, vocab, u8_wire=False, **KW)
    jax_u8 = JaxEngine(ja, variables, vocab, u8_wire=True, **KW)
    port = port_actor(CFG, len(vocab), params, stats)
    port_f32 = ServingEngine(port, vocab, device="cpu", u8_wire=False, **KW)
    port_u8 = ServingEngine(port, vocab, device="cpu", u8_wire=True, **KW)
    return jax_f32, jax_u8, port_f32, port_u8


@pytest.mark.parametrize("wire", ("f32", "u8"))
def test_engine_matches_jax_engine(engines, wire):
    jax_eng, port_eng = ((engines[0], engines[2]) if wire == "f32"
                         else (engines[1], engines[3]))
    imgs = _images()
    expect = jax_eng.edit_batch(imgs, REQUESTS)
    before = dict(port_eng.stats)
    got = port_eng.edit_batch(imgs, REQUESTS)
    assert port_eng.stats["batches"] - before["batches"] == 3
    atol = ATOL if wire == "f32" else 1.0 / 255 + 1e-6
    for im, e, g in zip(imgs, expect, got):
        assert g.ops == e.ops
        assert g.bucket == e.bucket
        assert len(g.params) == len(e.params)
        for pg, pe in zip(g.params, e.params):
            np.testing.assert_allclose(pg, pe, atol=ATOL, rtol=0)
        assert g.image.shape == im.shape == e.image.shape
        assert g.image.dtype == np.float32
        np.testing.assert_allclose(g.image, e.image, atol=atol, rtol=0)
    assert max(len(g.ops) for g in got) >= 4


@pytest.mark.parametrize("src", [(512, 512), (384, 640), (40, 56)])
def test_probe_resize_matches_native(src):
    """F.interpolate(bilinear, half-pixel, no antialias) samples as
    cv2's INTER_LINEAR, which the JAX engine's native resize follows;
    the native code weighs in double, torch in f32: 1e-6."""
    from t2onet_tpu.native import resize_bilinear as native_resize

    img = jpeg_images(*src)[0]
    expect = native_resize(np.ascontiguousarray(img.transpose(1, 2, 0)),
                           128, 128).transpose(2, 0, 1)
    got = resize_bilinear(torch.from_numpy(img)[None], 128, 128)[0].numpy()
    np.testing.assert_allclose(got, expect, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(32, 32), (33, 64), (40, 72), (100, 150),
                                (1024, 1)])
def test_bucketing_matches_jax(hw):
    img = np.random.default_rng(1).uniform(0, 1, (3,) + hw).astype(
        np.float32)
    for q, m in ((32, 1024), (64, 128)):
        assert bucketing.bucket_shape(*hw, q, m) == \
            jbucketing.bucket_shape(*hw, q, m)
        if max(hw) > m:
            with pytest.raises(ValueError):
                bucketing.pad_to_bucket(img, q, m)
            continue
        got, valid = bucketing.pad_to_bucket(img, q, m)
        want, want_valid = jbucketing.pad_to_bucket(img, q, m)
        assert valid == want_valid
        np.testing.assert_array_equal(got, want)


def test_tokenizer_and_config_match_jax():
    vocab = synthetic_vocab()
    for req in REQUESTS + ["", "A, b!! Brightness??", "x " * 30]:
        np.testing.assert_array_equal(txt2idx(req, vocab, 17),
                                      jax_txt2idx(req, vocab, 17))
    for p, j in ((pconfig.ModelConfig(), jconfig.ModelConfig()),
                 (pconfig.ModelConfig.tiny(), jconfig.ModelConfig.tiny()),
                 (pconfig.OperatorConfig(), jconfig.OperatorConfig())):
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert pconfig.FIVEK_VOCAB_SIZE == jconfig.Config().vocab_size


def test_oversize_image_downscaled(engines):
    port_eng = engines[2]
    eng = ServingEngine(port_eng.actor, port_eng.vocab2id, device="cpu",
                        u8_wire=False, decode_size=32, quantum=32,
                        max_batch=2, encoder_max_len=L, max_side=64)
    img = np.tile(np.linspace(0.1, 0.9, 150, dtype=np.float32), (3, 100, 1))
    [r] = eng.edit_batch([img], ["increase the brightness"])
    assert r.image.shape == (3, 43, 64)
    assert float(r.image[:, :, -1].mean()) > float(r.image[:, :, 0].mean())


def test_cuda_engine_without_card_raises(engines):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        ServingEngine(engines[2].actor, {}, device="cuda")


def test_port_imports_no_jax():
    """Importing every module of the port, and running its serving path
    (the batcher too), the actor's other modes and the inpaint fillers,
    loads neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys, numpy as np, torch\n"
        "import t2onet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "t2onet_tpu_torch.__path__, 't2onet_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "assert 't2onet_tpu_torch.models.edgeconnect' in mods\n"
        "from t2onet_tpu_torch.config import ModelConfig, OperatorConfig\n"
        "from t2onet_tpu_torch.models.actor import Actor\n"
        "from t2onet_tpu_torch.models import edgeconnect, inpaint\n"
        "from t2onet_tpu_torch.serve import MicroBatcher, ServingEngine\n"
        "torch.set_num_threads(1)\n"
        "f = inpaint.make_inpaint_fn(inpaint.InpaintNet(4, (2,)),"
        " torch.ones(1, 1, 8, 8))\n"
        "assert f(torch.rand(2, 3, 8, 8)).shape == (2, 3, 8, 8)\n"
        "assert edgeconnect.canny_edges(np.eye(8)).shape == (8, 8)\n"
        "m = Actor(ModelConfig.tiny(resnet_depth=50, vis_bf16=True,"
        " discrete_param=True), OperatorConfig(), 10,"
        " generator=torch.Generator().manual_seed(0))\n"
        "m.episode(torch.ones(2, 3, dtype=torch.long), torch.rand(2, 3, 16,"
        " 16), sample=True, param_noise=0.6, probe_size=8,"
        " generator=torch.Generator().manual_seed(1))\n"
        "a = Actor(ModelConfig.tiny(encoder_max_len=8), OperatorConfig(), 10,"
        " generator=torch.Generator().manual_seed(0))\n"
        "e = ServingEngine(a, {'bright': 4}, device='cpu', decode_size=16,"
        " quantum=16, max_batch=2, encoder_max_len=8)\n"
        "[r] = e.edit_batch([np.full((3, 20, 24), 0.5, np.float32)],"
        " ['bright'])\n"
        "assert r.image.shape == (3, 20, 24)\n"
        "b = MicroBatcher(e, linger_ms=1).start()\n"
        "p = e.submit(np.full((3, 20, 24), 0.5, np.float32), 'bright')\n"
        "assert p.done.wait(60) and p.error is None\n"
        "b.stop()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'flax', 't2onet_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
