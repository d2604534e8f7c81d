"""The port's HSV pair, extra operators, reverse fits, color names and
operator sweeps against the JAX package's, on the same seeded inputs.

- `rgb_to_hsv` / `hsv_to_rgb` on random images and on built ties (two
  equal largest channels, gray, black, white) and hues at 0, 1/6, 1,
  above 1 and below 0: forward within 1e-6, vector-Jacobian products
  within 1e-5.
- exposure, bnw, blur, hue and white balance, and `OP_FNS`'s keys:
  forward 1e-6, the image's VJP 1e-5, the parameter's VJP (a sum over
  the image's 3·H·W f32 terms, in another order) 1e-4 relative.
- `get_param_naive` / `get_reverse` on JAX's three reverse cases
  (tests/test_operators.py:301-345: brightness, the sharpness <-> blur
  pair, the strong-brightness plateau) plus contrast: the same success
  flag, parameters within 1e-4.
- `get_color_from_name` equal, with and without a map file.
- `cli.op_sweep`: the file list of JAX's main, and its arrays (captured
  before the JPEG) within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2onet_tpu.ops import color as jcolor
from t2onet_tpu.ops import operators as jops
from t2onet_tpu.ops import reverse as jrev
from t2onet_tpu_torch.ops import color, operators as ops, reverse
from tests._torch_port import tie_images

torch.set_num_threads(2)

FWD, VJP = 1e-6, 1e-5
PARAM_VJP_RTOL = 1e-4
B, H, W = 3, 16, 24


def _images():
    rng = np.random.default_rng(0)
    rand = rng.uniform(0, 1, (B, 3, H, W)).astype(np.float32)
    return np.concatenate([rand, tie_images(B, H, W)])


def _vjp_jax(fn, args, cot):
    out, pull = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return out, pull(cot)


def _vjp_port(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    grads = torch.autograd.grad(outs, ts, [torch.as_tensor(np.asarray(c))
                                           for c in cots])
    return out, grads


def _check(jfn, tfn, args, rng, param_args=()):
    """Forward within FWD; the VJP of each argument within VJP, or for
    the indices in `param_args` (per-image parameters) within
    PARAM_VJP_RTOL relative."""
    jout, _ = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jouts = jout if isinstance(jout, tuple) else (jout,)
    cot = tuple(rng.normal(size=o.shape).astype(np.float32) for o in jouts)
    cot_j = cot if isinstance(jout, tuple) else cot[0]
    _, jgrads = _vjp_jax(jfn, args, cot_j)
    tout, tgrads = _vjp_port(tfn, args, cot_j)
    touts = tout if isinstance(tout, tuple) else (tout,)
    for a, b in zip(jouts, touts):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   atol=FWD, rtol=0)
    for i, (a, b) in enumerate(zip(jgrads, tgrads)):
        tol = dict(atol=VJP, rtol=PARAM_VJP_RTOL if i in param_args else 0)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **tol)


def test_rgb_to_hsv_matches_jax():
    _check(jcolor.rgb_to_hsv, color.rgb_to_hsv, [_images()],
           np.random.default_rng(1))


def test_hsv_to_rgb_matches_jax_on_sextant_edges():
    rng = np.random.default_rng(2)
    h = rng.uniform(-1.5, 2.5, (2, 1, H, W)).astype(np.float32)
    edges = np.array([0.0, 1 / 6, 2 / 6, 0.5, 4 / 6, 5 / 6, 1.0, 2.0, -0.25,
                      -1e-3, -1 / 6, 1.0 - 1e-7], np.float32)
    h.reshape(-1)[:edges.size] = edges
    s = rng.uniform(0, 1, h.shape).astype(np.float32)
    v = rng.uniform(0, 1, h.shape).astype(np.float32)
    s.reshape(-1)[:3] = [0.0, 1.0, 0.5]
    _check(jcolor.hsv_to_rgb, color.hsv_to_rgb, [h, s, v], rng)


def test_hsv_round_trip_is_identity():
    img = torch.from_numpy(_images())
    back = color.hsv_to_rgb(*color.rgb_to_hsv(img))
    np.testing.assert_allclose(back.numpy(), img.numpy(), atol=1e-6)


EXTRA = {"exposure": 1, "bnw": 1, "blur": 1, "hue": 1, "whitebalance": 3}


def test_op_fns_keys_match_jax():
    assert list(ops.OP_FNS) == list(jops.OP_FNS)
    from t2onet_tpu import ops as jpkg
    from t2onet_tpu_torch import ops as tpkg

    public = [n for n in dir(jpkg) if not n.startswith("_")
              and not isinstance(getattr(jpkg, n), type(jpkg))]
    assert [n for n in public if not hasattr(tpkg, n)] == []


@pytest.mark.parametrize("name", sorted(EXTRA))
def test_extra_operator_matches_jax(name):
    rng = np.random.default_rng(3)
    lo, hi = (0.5, 1.5) if name == "whitebalance" else (-0.8, 1.2)
    p = rng.uniform(lo, hi, (2 * B, EXTRA[name])).astype(np.float32)
    _check(lambda i, q: jops.mask_blend(jops.OP_FNS[name](i, q), i),
           lambda i, q: ops.mask_blend(ops.OP_FNS[name](i, q), i),
           [_images(), p], rng, param_args=(1,))


def _smooth(size):
    from t2onet_tpu_torch.cli.op_sweep import procedural_image

    return procedural_image(size)


def _reverse_cases():
    """(img, edited, forward param, forward op): JAX's three cases (the
    sharpness <-> blur pair both ways, on a smooth image that blur can
    undo) and contrast."""
    img7 = np.clip(np.random.default_rng(7).uniform(0.2, 0.8, (1, 3, 16, 16)),
                   0, 1).astype(np.float32)
    img0 = np.random.default_rng(0).uniform(0.05, 0.4, (1, 3, 24, 24)).astype(
        np.float32)
    smooth = _smooth(16)
    out = []
    for img, p, name in ((img7, 0.3, "brightness"), (img0, 1.5, "brightness"),
                         (img7, 0.4, "contrast"), (smooth, 0.5, "sharpness"),
                         (smooth, 0.6, "blur")):
        edited = np.asarray(jrev.apply_operator(jnp.asarray(img), None, [p],
                                                name))
        out.append((img, edited, [p], name))
    return out


@pytest.mark.parametrize("case", range(5))
def test_reverse_fit_matches_jax(case):
    """Same success flag, parameters within 1e-4 of JAX's."""
    img, edited, p, name = _reverse_cases()[case]
    assert reverse.rev_ops_dict == jrev.rev_ops_dict
    assert reverse.get_rev_param0(p, name) == jrev.get_rev_param0(p, name)
    rev, p0 = jrev.rev_ops_dict[name], jrev.get_rev_param0(p, name)
    want, ok_want = jrev.get_param_naive(edited, img, None, p0, rev)
    got, ok_got = reverse.get_param_naive(edited, img, None, p0, rev,
                                          device="cpu")
    assert ok_got == ok_want
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if ok_want:
        got_p, got_name = reverse.get_reverse(
            torch.from_numpy(img), torch.from_numpy(edited), None, p, name)
        assert got_name == rev and got_p == got
        back = reverse.apply_operator(torch.from_numpy(edited), None, got_p,
                                      got_name)
        assert float((back - torch.from_numpy(img)).abs().mean()) < 0.02
    else:
        with pytest.raises(AssertionError, match="reverse operation failed"):
            reverse.get_reverse(img, edited, None, p, name, device="cpu")


def test_numpy_inputs_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((1, 3, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reverse.apply_operator(img, None, [0.1], "brightness")


def test_color_names_match_jax(tmp_path):
    from t2onet_tpu.ops import color_names as jnames
    from t2onet_tpu_torch.ops import color_names

    assert color_names.NAME_HSV_MAP == jnames.NAME_HSV_MAP
    for name in ("blue", "dark", "gr", "nothing"):
        assert (color_names.get_color_from_name(name)
                == jnames.get_color_from_name(name))
    path = tmp_path / "map.json"
    path.write_text(json.dumps({"sky blue": [0.55, 0.4, 0.9],
                                "blood red": [0.0, 1.0, 0.5]}))
    assert (color_names.get_color_from_name("blue", str(path))
            == jnames.get_color_from_name("blue", str(path)))


def test_op_sweep_matches_jax(tmp_path, monkeypatch):
    """JAX's file list; each array within 1e-6 of JAX's (before the JPEG:
    one 8-bit level becomes six after it)."""
    from t2onet_tpu.cli import op_sweep as jsweep
    from t2onet_tpu_torch.cli import op_sweep

    want = {}

    def capture(img, path):
        want[os.path.relpath(path, str(tmp_path / "jax"))] = np.asarray(img)

    monkeypatch.setattr(jsweep, "save_img", capture)
    jsweep.main(["--cpu", "--img_size", "16", "--out_dir",
                 str(tmp_path / "jax")])
    written = op_sweep.main(["--device", "cpu", "--img_size", "16",
                             "--out_dir", str(tmp_path / "port")])
    got = {os.path.relpath(p, str(tmp_path / "port")): a for p, a in written}
    assert list(got) == list(want)
    for rel, arr in want.items():
        assert os.path.exists(tmp_path / "port" / rel)
        np.testing.assert_allclose(got[rel], arr, atol=FWD, rtol=0,
                                   err_msg=rel)
