"""EdgeConnect's inpainting stage in the port (`train.edgeconnect`,
`models.edgeconnect`, `models.vgg`, `ops.hysteresis`, `cli.train_inpaint
--backend edgeconnect`) against the benchmark's plain reference
(`benchmark/reference/edgeconnect.py`), on the CPU at full widths on tiny
inputs (b2 x 32 x 32: D's five layers need 32 px), from one dict of
weights made from a seed (`benchmark.weights_edgeconnect`).

Tolerances: each loss term within 1e-5 relatively and each network's
first gradient within 1e-4 of its norm (f32 on the CPU in two orders of
summation: the reference writes instance norm and BCE out); every
spectral-normed layer's sigma after its power iterations within 1e-5;
after two Adam steps each leaf's change within 5e-3 of its norm, but the
biases before an instance norm, whose true gradient is 0 (Adam's first
steps move each value by about the learning rate whatever its gradient,
so the few values whose gradient is rounding noise may step either way);
the edge maps equal, pixel for pixel. D is held to the reference on the
port's own fakes: its gradient moves by ~4e-3 when the fakes move by
their last bits (5e-6 at 32 px, the generators' two orders of
summation), more than any rounding of D's own. Tests marked `card` hold
the hysteresis kernel and the edges on the card to the plain versions;
they skip without one."""

import ast
import importlib.util
import os

import numpy as np
import pytest
import torch

from benchmark.reference import edgeconnect as R
from benchmark.weights_edgeconnect import copy, make_edgeconnect_weights
from t2onet_tpu_torch.cli import train_inpaint
from t2onet_tpu_torch.models import edgeconnect as E
from t2onet_tpu_torch.models.vgg import Vgg19Features
from t2onet_tpu_torch.ops import hysteresis as H
from t2onet_tpu_torch.train import edgeconnect as T
from t2onet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the shared fixtures by path: the card's host has a `tests` package of
# its own installed, which `tests._torch_port` would resolve to
_spec = importlib.util.spec_from_file_location(
    "_torch_port", os.path.join(ROOT, "tests", "_torch_port.py"))
_port = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_port)
jpeg_images = _port.jpeg_images
SEED, B, SIZE = 2 ** 31 + 91, 2, 32
CFG = {"lr": 1e-4, "d2g_lr": 0.1, "beta1": 0.0, "beta2": 0.9, "sigma": 2.0}
RTOL = 1e-5
TERMS = ("G_adv", "G_l1", "G_content", "G_style")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches():
    """Two batches of JPEG crops with a block and a free-form hole."""
    crops = jpeg_images(SIZE, 2 * SIZE)
    imgs = torch.from_numpy(np.concatenate([crops[..., :SIZE],
                                            crops[..., SIZE:]])[:2 * B])
    rng = np.random.default_rng(4)
    out = []
    for i in range(2):
        m = np.zeros((B, 1, SIZE, SIZE), np.float32)
        m[0, 0] = T.random_block(rng, SIZE)
        m[1, 0, 5:14, 3:27] = 1.0
        m[1, 0, 14:30, 20:26] = 1.0
        out.append({"images": imgs[i * B:(i + 1) * B],
                    "masks": torch.from_numpy(m)})
    return out


def port_state(W):
    e, g = E.EdgeGenerator(spectral=True), E.InpaintGenerator()
    d, v = E.Discriminator(), Vgg19Features(T.VGG_END)
    for net, part in ((e, "edge"), (g, "inpaint"), (d, "disc"), (v, "vgg")):
        net.load_state_dict(W[part], strict=True)
    return T.EdgeConnectState(e, g, d, v, lr=CFG["lr"])


def _sigmas(net, W0):
    """{layer: u . (W0 v)} of the spectral-normed layers, with the seed's
    weights W0 and the layer's vectors now."""
    out = {}
    for name, m in E.spectral_layers(net):
        if name.startswith("features."):
            continue
        mat = E.weight_matrix(W0[f"{name}.weight_orig"], m.sn_dim)
        out[name] = float(torch.dot(m.weight_u, torch.mv(mat, m.weight_v)))
    return out


def _ref_sigmas(P, specs, W0):
    out = {}
    for name in R.spectral_names(specs):
        tr = name in ("decoder.0", "decoder.3")
        out[name] = float(R.sigma({f"{name}.weight_orig":
                                   W0[f"{name}.weight_orig"]}, name,
                                  (P[f"{name}.weight_u"],
                                   P[f"{name}.weight_v"]), tr))
    return out


@pytest.fixture(scope="module")
def run():
    """The port's two steps (spans recorded) and the reference's two
    iterations from the same weights and batches."""
    torch.set_num_threads(2)
    W = make_edgeconnect_weights(SEED, "cpu")
    batches = _batches()
    st = port_state(copy(W))
    seen, fakes = [], []
    hooks = [st.edge_g.register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0][:, 1].bool(),
                                           out.detach().clone()))),
             st.inpaint_g.register_forward_hook(
        lambda mod, inp, out: fakes.append(out.detach().clone()))]
    profiling.start_spans()
    try:
        p1 = T.edgeconnect_inpaint_step(st, batches[0])
        port = {"losses": [{k: float(v) for k, v in p1.items()}],
                "g_grad": {n: st.g_opt.state[p]["exp_avg"].clone()
                           for n, p in st.inpaint_g.named_parameters()},
                "d_grad": {n: st.d_opt.state[p]["exp_avg"].clone()
                           for n, p in st.disc.named_parameters()},
                "sigma": {**_sigmas(st.edge_g, W["edge"]),
                          **_sigmas(st.disc, W["disc"])}}
        p2 = T.edgeconnect_inpaint_step(st, batches[1])
        port["losses"].append({k: float(v) for k, v in p2.items()})
    finally:
        spans, _ = profiling.take_spans()
        for h in hooks:
            h.remove()
    port.update(edges=seen, spans=spans, steps=st.stats["steps"],
                g=dict(st.inpaint_g.state_dict()),
                d=dict(st.disc.state_dict()))

    R.set_precision("f32", "cpu")
    Wr = copy(W)
    ad_g, ad_d = {}, {}
    ref = {"losses": [], "edges": []}
    for i, b in enumerate(batches):
        got = R.iteration(Wr["edge"], Wr["inpaint"], Wr["disc"], Wr["vgg"],
                          b["images"], b["masks"], ad_g, ad_d, CFG)
        ref["losses"].append({**got["terms"], "D_loss": got["d_loss"]})
        ref["edges"].append((got["edges"][:, 0], got["pred"]))
        if i == 0:
            ref.update(g_grad=got["g_grads"], d_grad=got["d_grads"],
                       sigma={**_ref_sigmas(Wr["edge"],
                                            R.generator_specs("edge"),
                                            W["edge"]),
                              **_ref_sigmas(Wr["disc"], R.disc_specs(),
                                            W["disc"])})
    ref.update(g=Wr["inpaint"], d=_disc_on(W, batches, fakes))
    return W, port, ref


def _disc_on(W, batches, fakes):
    """The reference's D updates of the two iterations on the port's
    fakes: {"grad": the first gradient, "params": after the two}."""
    D, adam, out = copy(W)["disc"], {}, {}
    names = R.trainable_names(R.disc_specs())
    for b, fake in zip(batches, fakes):
        uvs = [R.disc_vectors(D) for _ in range(3)]
        for n in names:
            D[n].requires_grad_(True)
        loss = (R.bce(R.discriminate(D, b["images"], uvs[0]), True)
                + R.bce(R.discriminate(D, fake, uvs[1]), False)) / 2
        grads = R._grads(loss, D, names)
        out.setdefault("grad", grads)
        R.adam_step(D, names, grads, adam, CFG["lr"] * CFG["d2g_lr"],
                    CFG["beta1"], CFG["beta2"])
    out["params"] = D
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_losses_of_two_steps(run):
    _, port, ref = run
    for p, r in zip(port["losses"], ref["losses"]):
        for k in TERMS + ("D_loss",):
            assert _rel(p[k], r[k]) < RTOL, (k, p[k], r[k])
        assert _rel(p["G_loss"], sum(r[k] for k in TERMS)) < RTOL


@pytest.mark.parametrize("net", ["g_grad", "d_grad"])
def test_first_gradients(run, net):
    """Each network's first gradient, as its Adam holds it (beta1 = 0:
    the first moment is the gradient)."""
    _, port, ref = run
    want = ref[net] if net == "g_grad" else ref["d"]["grad"]
    names = sorted(want)
    diff = torch.sqrt(sum(((port[net][n] - want[n]) ** 2).sum()
                          for n in names))
    norm = torch.sqrt(sum((want[n] ** 2).sum() for n in names))
    assert float(diff / norm) < 1e-4
    for n in names:
        assert float((port[net][n] - want[n]).norm()) \
            < 1e-4 * max(float(want[n].norm()), 1e-2 * float(norm)), n


def test_sigma_after_power_iterations(run):
    """One power iteration a forward: 21 of the edge G's layers once, D's
    five three times (the real, fake and G's passes)."""
    _, port, ref = run
    assert len(port["sigma"]) == len(ref["sigma"]) == 21 + 5
    for name, r in ref["sigma"].items():
        assert _rel(port["sigma"][name], r) < RTOL, name


def test_two_adam_steps(run):
    W, port, ref = run
    noise = {n for n in ref["g"] if n.endswith(".bias")
             and not n.startswith("decoder.7")}
    for key, part, want in (("g", "inpaint", ref["g"]),
                            ("d", "disc", ref["d"]["params"])):
        for n in R.trainable_names(R.generator_specs("inpaint") if key == "g"
                                   else R.disc_specs()):
            moved = port[key][n] - W[part][n]
            assert float(moved.abs().max()) > 0, n
            if n in noise:
                continue
            gap = (moved - (want[n] - W[part][n])).norm() / moved.norm()
            assert float(gap) < 5e-3, (n, float(gap))


def test_edges_of_the_step_equal_the_references(run):
    """The edge G's edge channel equal to the reference's host canny, and
    its output within 1e-5 of the reference's."""
    _, port, ref = run
    for (pe, pp), (re_, rp) in zip(port["edges"], ref["edges"]):
        assert torch.equal(pe, re_)
        assert float((pp - rp).norm() / rp.norm()) < RTOL


def test_spans_and_counter(run):
    _, port, _ = run
    assert port["steps"] == 2
    steps = [s for s in port["spans"] if s.name == "train.step"]
    assert [s.attrs["kind"] for s in steps] == ["inpaint", "inpaint"]
    inner = [s.name for s in port["spans"]
             if s.parent in {x.id for x in steps}]
    assert inner == ["train.inpaint.edges", "train.inpaint.gen",
                     "train.inpaint.disc"] * 2


def test_edge_maps_equal_canny_edges():
    """The trainer's edge function (the CPU's plain hysteresis) against
    the host's `canny_edges`: JPEG crops, noise, flat and drawn shapes."""
    crops = jpeg_images(32, 40)
    gray = list(E.image_gray(torch.from_numpy(crops)).numpy())
    gray.append(np.random.default_rng(3).uniform(0, 1, (24, 24))
                .astype(np.float32))
    gray.append(np.zeros((16, 16), np.float32))
    yy, xx = np.mgrid[0:40, 0:40]
    gray.append(((np.hypot(yy - 20, xx - 20) < 12) * 0.8).astype(np.float32))
    for g in gray:
        for sigma in (1.5, 2.0):
            got = E.edge_maps(torch.from_numpy(g)[None], sigma)[0].numpy()
            np.testing.assert_array_equal(got, E.canny_edges(g, sigma))
            np.testing.assert_array_equal(got, R.canny(g, sigma))


def test_inpaint_fn_takes_the_trainers_edges(monkeypatch):
    """`make_edgeconnect_inpaint_fn` makes its edges with `edge_maps`, on
    the images' device: its fill equals the pipeline written out with it."""
    W = make_edgeconnect_weights(SEED + 1, "cpu")
    e, g = E.EdgeGenerator(), E.InpaintGenerator()
    e.load_state_dict(E.edgeconnect_state_dict(W["edge"]))
    g.load_state_dict(W["inpaint"])
    e.eval(), g.eval()
    mask = np.zeros((SIZE, SIZE), np.float32)
    mask[8:20, 10:22] = 1.0
    img = torch.from_numpy(jpeg_images(SIZE, SIZE)[:2].copy())
    calls = []
    edge_maps = E.edge_maps
    monkeypatch.setattr(E, "edge_maps",
                        lambda *a: calls.append(1) or edge_maps(*a))
    got = E.make_edgeconnect_inpaint_fn(e, g, mask)(img)
    assert calls == [1]
    m = torch.from_numpy(mask)
    with torch.no_grad():
        gray = E.image_gray(img)
        edges = torch.from_numpy(np.stack([E.canny_edges(x) for x in
                                           gray.numpy()])) * (1 - m)
        pred = e(torch.stack([gray * (1 - m) + m, edges,
                              m.expand_as(gray)], 1))
        pred = pred * m + edges[:, None] * (1 - m)
        want = torch.clamp(g(torch.cat([img * (1 - m) + m, pred], 1)) * m
                           + img * (1 - m), 0, 1)
    assert torch.equal(got, want)


def test_checkpoint_round_trip(tmp_path):
    """`train-inpaint --backend edgeconnect` writes EdgeConnect's three
    files; the generators load through `load_generator` into
    `make_edgeconnect_inpaint_fn` and fill as the trained nets do, and
    the discriminator's state_dict loads back."""
    state, m = train_inpaint.main([
        "--backend", "edgeconnect", "--synthetic", "--device", "cpu",
        "--img_size", str(SIZE), "--batch_size", "2", "--num_iters", "1",
        "--synthetic_n", "16", "--run_dir", str(tmp_path)])
    assert np.isfinite(m["hole_l1"]) and state.stats["steps"] == 1
    d = tmp_path / "edgeconnect_model"
    files = [torch.load(d / f, weights_only=True) for f in T.CHECKPOINTS]
    assert files[0]["iteration"] == files[1]["iteration"] == 1
    assert "middle.0.conv_block.1.bias" not in files[0]["generator"]
    e = E.load_generator(files[0], "edge", device="cpu")
    g = E.load_generator(files[1], "inpaint", device="cpu")
    disc = E.Discriminator()
    disc.load_state_dict(files[2]["discriminator"])
    mask = np.zeros((SIZE, SIZE), np.float32)
    mask[4:20, 6:18] = 1.0
    img = torch.rand(2, 3, SIZE, SIZE, generator=torch.Generator()
                     .manual_seed(1))
    for net in (state.edge_g, state.inpaint_g):
        net.eval()
    got = E.make_edgeconnect_inpaint_fn(e, g, mask)(img)
    with torch.no_grad():
        mm = torch.from_numpy(mask)
        edges = T.composed_edges(state, img, mm.expand(2, 1, SIZE, SIZE))
        want = torch.clamp(state.inpaint_g(torch.cat(
            [img * (1 - mm) + mm, edges], 1)) * mm + img * (1 - mm), 0, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend,want", [
    ("gated", (128, 16, 2e-4)), ("edgeconnect", (256, 8, 1e-4))])
def test_cli_defaults_by_backend(backend, want):
    """The flags left out take the backend's defaults: the gated filler's
    as before, EdgeConnect's published ones; a flag given wins."""
    a = train_inpaint.parse_args(["--backend", backend])
    assert (a.img_size, a.batch_size, a.learning_rate) == want
    a = train_inpaint.parse_args(["--backend", backend, "--batch_size", "3"])
    assert (a.img_size, a.batch_size, a.learning_rate) == (want[0], 3,
                                                           want[2])


def test_discriminator_layout():
    """EdgeConnect's names: conv1..conv5 with `features` as conv1's second
    name, spectral norm's weight_orig / weight_u / weight_v, no bias; the
    published sizes (2.76 M parameters; each generator 10.8 M)."""
    d = E.Discriminator()
    keys = list(d.state_dict())
    assert keys[:6] == ["conv1.0.weight_orig", "conv1.0.weight_u",
                        "conv1.0.weight_v", "features.0.weight_orig",
                        "features.0.weight_u", "features.0.weight_v"]
    assert not any(k.endswith("bias") for k in keys)
    assert sum(p.numel() for p in d.parameters()) == 2_763_776
    assert sum(p.numel() for p in E.EdgeGenerator(True).parameters()) \
        == 10_761_089
    assert sum(p.numel() for p in E.InpaintGenerator().parameters()) \
        == 10_774_595


def test_reference_imports_nothing_of_the_port():
    path = os.path.join(ROOT, "benchmark", "reference", "edgeconnect.py")
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "numpy", "torch"}, names


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    """Skips the test where PyTorch finds no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_hysteresis_kernel_matches_plain(card):
    """Random classes and a spiral one pixel wide (a path of thousands of
    pixels, strong at one end) at b8 x 256^2: the kernel's edges equal
    the plain flood fill's, four launches a call."""
    n = 256
    rng = np.random.default_rng(1)
    r = rng.uniform(size=(8, n, n))
    cls = (r > 0.45).astype(np.uint8) + (r > 0.995)
    spiral = np.zeros((n, n), np.uint8)
    spiral[0, :] = 1
    for k in range(0, n // 2 - 2, 2):
        spiral[k:n - k, n - 1 - k] = 1
        spiral[n - 1 - k, k:n - k] = 1
        spiral[k + 2:n - k, k] = 1
        spiral[k + 2, k:n - 2 - k] = 1
    cls[0] = spiral
    cls[0, 0, 0] = 2
    t = torch.from_numpy(cls)
    before = H.LAUNCHES["hysteresis"]
    got = H.hysteresis(t.to(card))
    assert H.LAUNCHES["hysteresis"] == before + 1
    assert torch.equal(got.cpu(), H.hysteresis_reference(t))


@pytest.mark.card
def test_edge_maps_on_the_card_equal_canny_edges(card):
    crops = jpeg_images(256, 256)
    gray = E.image_gray(torch.from_numpy(crops))
    got = E.edge_maps(gray.to(card)).cpu().numpy()
    want = np.stack([E.canny_edges(g) for g in gray.numpy()])
    np.testing.assert_array_equal(got, want)
