"""Shared fixtures of the port's parity tests (tests/test_torch_*.py):
seeded inputs made with numpy, and one random init carried from the JAX
actor into the port's through `t2onet_tpu_torch.convert`."""

import os

import numpy as np

_IMAGES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data_real_h2h", "FiveK", "images")
# FiveK JPEGs holding exact 0 and 255 values (and mid-gray 127/128)
JPEGS = ("2340_B.jpg", "2546_E.jpg", "0092_E.jpg")


def uniform_images(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (b, 3, h, w)).astype(np.float32)


def jpeg_images(h, w, names=JPEGS):
    """(len(names), 3, h, w) f32 crops of real FiveK pixels, / 255."""
    from PIL import Image

    out = []
    for name in names:
        with Image.open(os.path.join(_IMAGES, name)) as im:
            a = np.asarray(im.convert("RGB"), np.float32) / 255.0
        a = np.tile(a, (-(-h // a.shape[0]), -(-w // a.shape[1]), 1))
        out.append(a[:h, :w].transpose(2, 0, 1))
    return np.ascontiguousarray(np.stack(out))


def fixtures(b, h, w, seed=0):
    """Both fixture kinds, by name."""
    return {"uniform": uniform_images(b, h, w, seed),
            "jpeg": jpeg_images(h, w, JPEGS[:b] if b <= 3 else
                                (JPEGS * b)[:b])}


def tie_images(b, h, w):
    """JPEG crops (`jpeg_images`, cycled to b) with patches where JAX's
    and torch's gradient tie rules differ: exact black and white pixels,
    gray pixels (three equal channels) and pixels whose two largest
    channels are equal. Needs h, w >= 8."""
    out = np.concatenate([jpeg_images(h, w)] * (-(-b // 3)))[:b].copy()
    out[:, :, 0:2, 0:2] = 0.0                   # black
    out[:, :, 2:4, 0:2] = 1.0                   # white
    out[:, :, 4:6, 0:2] = 128.0 / 255.0         # gray
    out[:, 0, 6:8, 0:2] = 200.0 / 255.0         # r == g > b
    out[:, 1, 6:8, 0:2] = 200.0 / 255.0
    out[:, 2, 6:8, 0:2] = 40.0 / 255.0
    return out


def _draw(path, shape, rng):
    """A seeded draw at the scale of torch's default init for the leaf."""
    name = path[-1]
    if name == "embedding":
        return rng.normal(0.0, 1.0, shape)
    if name in ("kernel", "w1", "w2"):
        fan_in = int(np.prod(shape[1:-1] if name != "kernel" else shape[:-1]))
    elif name in ("w_ih", "w_hh"):
        fan_in = shape[1] // 4
    else:                                   # biases
        fan_in = 100
    lim = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-lim, lim, shape)


def _fill(tree, stats, path, rng):
    out = {}
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            out[key] = _fill(sub, stats.get(key, {}) if stats else {},
                             path + (key,), rng)
        elif key == "scale":
            out[key] = rng.uniform(0.8, 1.2, sub.shape)
        elif key == "bias" and stats and "mean" in stats:
            out[key] = rng.normal(0.0, 0.1, sub.shape)
        else:
            out[key] = _draw(path + (key,), sub.shape, rng)
    return out


def _bn_stats(stats, rng):
    out = {}
    for key in sorted(stats):
        sub = stats[key]
        if "mean" in sub:
            n = sub["mean"].shape
            out[key] = {"mean": rng.normal(0.0, 0.1, n),
                        "var": rng.uniform(0.5, 1.5, n)}
        else:
            out[key] = _bn_stats(sub, rng)
    return out


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def jax_actor(cfg, vocab_size, x, img, seed=0, knots_near_one=False):
    """A JAX Actor and numpy variables for it: the variable tree is the
    one `Actor.init` makes (traced with eval_shape, which takes about a
    second where running the init takes tens), the values are seeded
    numpy draws at torch-default scales, and every BatchNorm gets a
    non-trivial scale, bias, mean and var so that the weights bridge is
    tested on each. The heads' fc2 columns past each op's parameter count
    (in the discrete mode past `fc2_widths`, which keeps the bin logits)
    are never read and the port has none: they are zero.

    knots_near_one adds 1 to the color and tone heads' fc2 bias, so the
    curve knots sit near 1 as a trained model's do (tone range 0.5-2,
    color 0.9-1.1). Random heads put them near 0, where the curve's
    division by the knot sum magnifies f32 rounding past 1e-5."""
    import jax
    import jax.numpy as jnp

    from t2onet_tpu.config import OperatorConfig
    from t2onet_tpu.models.actor import Actor
    from t2onet_tpu_torch.models.actor import fc2_widths

    actor = Actor(cfg=cfg, opcfg=OperatorConfig(), vocab_size=vocab_size)
    shapes = jax.eval_shape(actor.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(x), jnp.asarray(img))
    shapes = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes)
    shapes = {k: dict(v) for k, v in dict(shapes).items()}
    rng = np.random.default_rng(seed)
    stats = _f32(_bn_stats(_unfreeze(shapes["batch_stats"]), rng))
    params = _f32(_fill(_unfreeze(shapes["params"]), stats, (), rng))
    widths = fc2_widths(cfg.discrete_step if cfg.discrete_param else 0)
    for i, k in enumerate(widths):
        params["heads"]["w2"][i, :, k:] = 0.0
        params["heads"]["b2"][i, k:] = 0.0
    if knots_near_one:
        params["heads"]["b2"][3, :24] += 1.0          # color
        params["heads"]["b2"][5, :8] += 1.0           # tone
    return actor, params, stats


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return tree


def port_actor(cfg, vocab_size, params, stats):
    """The port's Actor at the same config, loaded from JAX variables."""
    import dataclasses

    import torch

    from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
    from t2onet_tpu_torch.convert import load_jax_variables
    from t2onet_tpu_torch.models.actor import Actor

    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    actor = Actor(pcfg, OperatorConfig(), vocab_size,
                  generator=torch.Generator().manual_seed(0))
    load_jax_variables(actor, params, stats)
    return actor.eval()


# ---------------------------------------------------------------------------
# one training step of each framework, compared
# ---------------------------------------------------------------------------

def jax_train_state(params, stats, lr):
    """A JAX TrainState from numpy variables, Adam as the trainer's."""
    import jax
    import jax.numpy as jnp
    import optax

    from t2onet_tpu.train import loop as jloop

    tx = optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jloop.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree_util.tree_map(
                                jnp.asarray, stats),
                            opt_state=tx.init(params), tx=tx)


def flat(tree):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_trees(actor, n_layers, grads=False):
    """convert_state_dict of the port's weights (or gradients: zeros for
    buffers and for parameters without one) -> flat (params, stats)."""
    from t2onet_tpu.convert import convert_state_dict

    sd = {k: v.detach().numpy().copy() for k, v in
          actor.state_dict().items()}
    if grads:
        sd = {k: np.zeros_like(v) for k, v in sd.items()}
        for n, p in actor.named_parameters():
            if p.grad is not None:
                sd[n] = p.grad.numpy()
    p, s = convert_state_dict(sd, n_layers)
    return flat(p), flat(s)


def check_train_step(pstate, jstate1, p_loss, j_loss, params0, n_layers, lr,
                     stats_rtol=0.0):
    """The port's state after one step against JAX's (see
    tests/test_torch_train.py for the tolerances): the loss, every
    gradient (JAX's recovered from Adam's first moment, mu = 0.1 g), the
    updated parameters and the BatchNorm statistics (atol 1e-5, plus
    `stats_rtol` of the value)."""
    import jax

    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    jg = flat(jax.tree_util.tree_map(lambda m: m / 0.1,
                                     jstate1.opt_state[0].mu))
    pg, _ = port_trees(pstate.actor, n_layers, grads=True)
    assert sorted(pg) == sorted(jg)
    new_p, new_s = port_trees(pstate.actor, n_layers)
    old = flat(params0)
    jp, js = flat(jstate1.params), flat(jstate1.batch_stats)
    for k in jg:
        gtol = 2e-3 * np.abs(jg[k]).max() + 1e-8
        np.testing.assert_allclose(pg[k], jg[k], rtol=1e-3, atol=gtol,
                                   err_msg=k)
        clear = np.abs(jg[k]) > max(10 * gtol, 1e-6)
        np.testing.assert_allclose(new_p[k][clear], jp[k][clear], atol=1e-6,
                                   rtol=0, err_msg=k)
        assert (np.abs(new_p[k] - old[k]) <= lr * 1.0001).all(), k
    for k in js:
        np.testing.assert_allclose(new_s[k], js[k], atol=1e-5,
                                   rtol=stats_rtol, err_msg=k)


def bridged(params, stats, cfg):
    """JAX variable trees (or gradient trees of the same shape) in the
    port's state_dict names, through the port's weights bridge: the
    comparison for modes JAX's `convert_state_dict` does not read (the
    Bottleneck ResNet, the discrete heads' wider fc2)."""
    import jax

    from t2onet_tpu_torch.convert import jax_variables_to_state_dict
    from t2onet_tpu_torch.models.resnet import blocks_per_stage

    def tree(t):
        return _unfreeze(jax.tree_util.tree_map(np.asarray, t))

    return jax_variables_to_state_dict(
        tree(params), tree(stats), cfg.n_layers,
        blocks_per_stage(cfg.resnet_depth),
        cfg.discrete_step if cfg.discrete_param else 0)


def check_train_step_bridged(pstate, jstate1, p_loss, j_loss, params0,
                             stats0, cfg, lr):
    """`check_train_step` in the port's names (`bridged`): the loss, each
    trainable tensor's gradient, the updated parameters and the BatchNorm
    statistics, with the same tolerances."""
    import jax

    np.testing.assert_allclose(float(p_loss), float(j_loss), rtol=1e-5)
    jg = bridged(jax.tree_util.tree_map(lambda m: m / 0.1,
                                        jstate1.opt_state[0].mu), stats0, cfg)
    jnew = bridged(jstate1.params, jstate1.batch_stats, cfg)
    old = bridged(params0, stats0, cfg)
    assert_grads_and_stats_match(pstate.actor, jg, jnew)
    for n, p in pstate.actor.named_parameters():
        if not p.requires_grad:
            continue
        gtol = 2e-3 * np.abs(jg[n]).max() + 1e-8
        new = p.detach().numpy()
        clear = np.abs(jg[n]) > max(10 * gtol, 1e-6)
        np.testing.assert_allclose(new[clear], jnew[n][clear], atol=1e-6,
                                   rtol=0, err_msg=n)
        assert (np.abs(new - old[n]) <= lr * 1.0001).all(), n


def assert_grads_and_stats_match(actor, jg, jsd):
    """Each trainable tensor's `.grad` against JAX's gradients `jg`, and
    the BatchNorm running statistics against `jsd` (both in the port's
    names, `bridged`), with `check_train_step`'s tolerances."""
    for n, p in actor.named_parameters():
        if not p.requires_grad:
            continue
        pg = (p.grad.numpy() if p.grad is not None
              else np.zeros(tuple(p.shape), np.float32))
        gtol = 2e-3 * np.abs(jg[n]).max() + 1e-8
        np.testing.assert_allclose(pg, jg[n], rtol=1e-3, atol=gtol,
                                   err_msg=n)
    for n, v in actor.state_dict().items():
        if "running" in n:
            np.testing.assert_allclose(v.numpy(), jsd[n], atol=1e-5,
                                       err_msg=n)


def draw_sequence(key, steps, b, n_cls, sample=True, discrete_step=0,
                  noise_shape=None):
    """The draws `Actor.episode` makes from `key`, in its order: per step
    (key, sub = split(key) before each) the op's Gumbel draw when
    `sample`, the bins' (b, 8, discrete_step) Gumbel draw when
    discrete_step and `sample`, and the parameter noise's normal draw of
    `noise_shape` when given. Returns (gumbels, normals) as lists of
    numpy arrays, each Gumbel shape checked once to be what
    `jax.random.categorical` adds to its logits."""
    import jax
    import jax.numpy as jnp

    gumbels, normals, checked = [], [], set()

    def gumbel(sub, shape):
        g = jax.random.gumbel(sub, shape)
        if shape not in checked:
            checked.add(shape)
            logits = jax.random.normal(jax.random.PRNGKey(7), shape)
            np.testing.assert_array_equal(
                np.asarray(jnp.argmax(logits + g, axis=-1)),
                np.asarray(jax.random.categorical(sub, logits, axis=-1)))
        gumbels.append(np.asarray(g))

    for _ in range(steps):
        if sample:
            key, sub = jax.random.split(key)
            gumbel(sub, (b, n_cls))
        if discrete_step and sample:
            key, sub = jax.random.split(key)
            gumbel(sub, (b, 8, discrete_step))
        if noise_shape is not None:
            key, sub = jax.random.split(key)
            normals.append(np.asarray(jax.random.normal(sub, noise_shape)))
    return gumbels, normals


def fed(arrays, device="cpu"):
    """fn(shape) handing out `arrays` in order as tensors, each checked
    against the shape asked for."""
    import torch

    it = iter(arrays)

    def fn(shape):
        a = next(it)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a.copy()).to(device)

    return fn


def gumbel_draws(key, shape, steps):
    """The draws `Actor.episode(sample=True)` makes: per step
    key, sub = split(key), then categorical(sub, ...) = argmax(logits +
    gumbel(sub))."""
    import jax
    import jax.numpy as jnp

    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        g = jax.random.gumbel(sub, shape)
        logits = jax.random.normal(jax.random.PRNGKey(7), shape)
        np.testing.assert_array_equal(
            np.asarray(jnp.argmax(logits + g, axis=-1)),
            np.asarray(jax.random.categorical(sub, logits, axis=-1)))
        draws.append(np.asarray(g))
    return draws


# ---------------------------------------------------------------------------
# GIER: one masked training step of each framework on real data
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIER_DATA = os.path.join(_ROOT, "data_real_gier")
GIER_ACTS = os.path.join(_ROOT, "data_real_gier_acts", "GIER_actions_set_1")
GIER_GLOVE_NPY = os.path.join(_ROOT, "data_real_gier_acts",
                              "GIER_vocabs_glove_feat_3.npy")
GIER_B, GIER_LR = 4, 1e-3


def every_op_masked(masks_vocab):
    """The batch's real local masks, shared out to the ops that edit
    globally, so that whatever op a rollout step picks, it is blended."""
    mv = masks_vocab.copy()
    local = [mv[i, o] for i in range(mv.shape[0])
             for o in range(mv.shape[1]) if (mv[i, o] < 1).any()]
    assert local
    j = 0
    for i in range(mv.shape[0]):
        for o in range(3, mv.shape[1]):
            if not (mv[i, o] < 1).any():
                mv[i, o] = local[j % len(local)]
                j += 1
    return mv


def gier_step_case(cfg):
    """(JAX actor, params, stats, batch, vocab size, GloVe rows): a real
    b4 GIER training batch at 16 px (JAX's GIERDatasetAct, shapeAlign,
    masks loaded, `every_op_masked`) and a seeded init whose word rows
    are the GloVe matrix."""
    from t2onet_tpu.data.gier import GIERDatasetAct

    ds = GIERDatasetAct(os.path.join(GIER_DATA, "GIER"),
                        os.path.join(GIER_DATA, "language"), GIER_ACTS,
                        "train", data_mode="shapeAlign", is_load_mask=True,
                        train_img_size=16)
    nb = next(ds.batches(GIER_B, 1, shuffle=True, seed=5))
    batch = {k: nb[k] for k in ("x", "y", "img_x", "img_y", "gt_params")}
    batch["gt_img"] = nb["img_y"][:, -1]
    batch["masks_vocab"] = every_op_masked(nb["masks_vocab"])
    vocab = len(ds.vocab2id)
    ja, params, stats = jax_actor(cfg, vocab, batch["x"], batch["img_x"],
                                  seed=8, knots_near_one=True)
    glove = np.load(GIER_GLOVE_NPY)
    params["lang_encoder"]["embedding"][cfg.n_spec_token:] = glove
    return ja, params, stats, batch, vocab, glove


def gier_train_step_parity(case, cfg, mode):
    """One step of both frameworks from `gier_step_case`: "supervised",
    or a masked episode step "greedy_bank", "greedy_fused" (the port's
    fused_step against JAX's pallas_exec) or "sampled_bank" (JAX's
    Gumbel draws fed to the port). Checks `check_train_step` and that
    the GloVe rows got no gradient and kept their values; returns the
    port's TrainState.

    BN statistics are held within 1e-5 plus 1e-5 of their value: `bn1`
    normalises 32 visual features over 4 real images per rollout step,
    and its running variances (~1.1) carry f32 rounding of the rollout
    images (which differ by at most 3.6e-7) at up to 1.17e-5 absolute
    (measured; 8.2e-6 through the bank)."""
    import jax
    import jax.numpy as jnp
    import torch

    from t2onet_tpu.train import loop as jloop
    from t2onet_tpu_torch.train import loop

    ja, params, stats, batch, vocab, glove = case
    jstate0 = jax_train_state(params, stats, GIER_LR)
    pstate = loop.TrainState(port_actor(cfg, vocab, params, stats),
                             learning_rate=GIER_LR)
    assert pstate.actor.lang_encoder.fix_embedding
    if mode == "supervised":
        keys = ("x", "y", "img_x", "img_y", "gt_params")
        jb = {k: jnp.asarray(batch[k]) for k in keys}
        jstate1, jm = jloop.make_supervised_step(ja, donate=False)(jstate0,
                                                                   jb)
        pm = loop.supervised_step(
            pstate, {k: torch.from_numpy(batch[k]) for k in keys})
        for k in ("op_loss", "param_loss"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
        p_loss, j_loss = pm["loss"], jm["loss"]
    else:
        sample = mode.startswith("sampled")
        fused = mode.endswith("fused")
        keys = ("x", "img_x", "gt_img", "masks_vocab")
        key = jax.random.PRNGKey(4)
        jstate1, jm = jloop.make_episode_step(
            ja, sample=sample, donate=False, with_masks=True,
            pallas_exec=fused)(jstate0, {k: jnp.asarray(batch[k])
                                         for k in keys}, key)
        noise_fn = None
        if sample:
            draws = iter(gumbel_draws(key, (GIER_B, cfg.op_vocab_size),
                                      cfg.decoder_max_len))

            def noise_fn(shape):
                return torch.from_numpy(next(draws).copy())

        pm = loop.episode_step(
            pstate, {k: torch.from_numpy(batch[k]) for k in keys},
            sample=sample, fused_exec=fused, noise_fn=noise_fn)
        p_loss, j_loss = pm["L1_loss"], jm["L1_loss"]
    check_train_step(pstate, jstate1, p_loss, j_loss, params, cfg.n_layers,
                     GIER_LR, stats_rtol=1e-5)
    spec = cfg.n_spec_token
    emb = pstate.actor.lang_encoder.embedding.weight
    assert not emb.grad[spec:].any()
    np.testing.assert_array_equal(emb.detach().numpy()[spec:], glove)
    np.testing.assert_array_equal(
        np.asarray(jstate1.params["lang_encoder"]["embedding"])[spec:],
        glove)
    return pstate
