"""The port's actor (t2onet_tpu_torch.models) against the JAX package's,
with one set of weights carried across by `t2onet_tpu_torch.convert`:
each module within 1e-5, and the greedy rollout with identical op ids,
params within 1e-5 and step images within 1e-4 (five steps of ResNet,
decoder and bank compound the modules' f32 rounding)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from t2onet_tpu.config import ModelConfig as JModelConfig
from t2onet_tpu.convert import convert_state_dict
from t2onet_tpu.models.actor import Actor as JActor
from t2onet_tpu.models.actor import select_end_images as jax_select_end
from t2onet_tpu_torch.models import actor as port_actor_mod
from tests._torch_port import jax_actor, jpeg_images, port_actor

torch.set_num_threads(2)

ATOL = 1e-5
V = 40                                   # request vocabulary
L = 12                                   # encoder_max_len
CFG = JModelConfig.tiny(encoder_max_len=L, decoder_max_len=5)


def _tokens():
    """Three requests of different lengths: START, words, END, padding."""
    rng = np.random.default_rng(0)
    x = np.zeros((3, L), np.int64)
    x[:, 0] = 1
    for i, n in enumerate((5, 9, 3)):
        x[i, 1:n] = rng.integers(4, V, n - 1)
        x[i, n] = 2
    return x


@pytest.fixture(scope="module")
def parts():
    x = _tokens()
    img = jpeg_images(32, 32)
    # seed 6: of seeds 0..11 the first whose rollout passes both guards
    # of test_greedy_episode_matches_jax (near-uniform random heads give
    # small knot sums and close top-two probabilities)
    ja, params, stats = jax_actor(CFG, V, x.astype(np.int32), img, seed=6)
    pa = port_actor(CFG, V, params, stats)
    return ja, {"params": params, "batch_stats": stats}, pa, x, img


def _jax(parts, fn, *args):
    ja, variables = parts[0], parts[1]
    return jax.tree_util.tree_map(
        np.asarray, ja.apply(variables, *args, method=fn))


def _close(got, expect, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect),
                               atol=atol, rtol=0)


def test_encoder_matches_jax(parts):
    pa, x = parts[2], parts[3]
    out_j, (h_j, c_j), valid_j = _jax(parts, lambda m, x: m.lang_encoder(x),
                                      jnp.asarray(x.astype(np.int32)))
    with torch.no_grad():
        out_t, (h_t, c_t), valid_t = pa.lang_encoder(torch.from_numpy(x))
    _close(out_t, out_j)
    _close(h_t, h_j)
    _close(c_t, c_j)
    _close(valid_t, valid_j, atol=0)


def test_decoder_step_matches_jax(parts):
    pa = parts[2]
    rng = np.random.default_rng(1)
    hd = CFG.decoder_hidden
    ops = np.array([1, 4, 9], np.int32)
    carry = [(rng.normal(0, 0.5, (3, hd)).astype(np.float32),
              rng.normal(0, 0.5, (3, hd)).astype(np.float32))
             for _ in range(CFG.n_layers)]
    enc = rng.normal(0, 0.5, (3, L, hd)).astype(np.float32)
    valid = (np.arange(L)[None] < np.array([[5], [9], [3]])).astype(
        np.float32)
    feat = rng.normal(0, 1, (3, CFG.vis_feat_dim)).astype(np.float32)
    lp_j, carry_j, attn_j, ctx_j = _jax(
        parts, lambda m, *a: m.decoder(*a), jnp.asarray(ops),
        tuple((jnp.asarray(h), jnp.asarray(c)) for h, c in carry),
        jnp.asarray(enc), jnp.asarray(valid), jnp.asarray(feat))
    t = torch.from_numpy
    with torch.no_grad():
        lp_t, carry_t, attn_t, ctx_t = pa.decoder(
            t(ops).long(), tuple((t(h), t(c)) for h, c in carry), t(enc),
            t(valid), t(feat))
    _close(lp_t, lp_j)
    _close(attn_t, attn_j)
    _close(ctx_t, ctx_j)
    for (ht, ct), (hj, cj) in zip(carry_t, carry_j):
        _close(ht, hj)
        _close(ct, cj)


def test_resnet_and_vis_feat_match_jax(parts):
    pa, img = parts[2], parts[4]
    feat_j, vis_j = _jax(
        parts, lambda m, i: (m.vis_encoder(i, train=False),
                             m.vis_feat(i, False)), jnp.asarray(img))
    with torch.no_grad():
        _close(pa.vis_encoder(torch.from_numpy(img)), feat_j)
        _close(pa.vis_feat(torch.from_numpy(img)), vis_j)


def test_param_heads_match_jax(parts):
    pa = parts[2]
    ctx = np.random.default_rng(2).normal(
        0, 1, (4, CFG.decoder_hidden)).astype(np.float32)
    expect = _jax(parts, lambda m, c: m.heads(c), jnp.asarray(ctx))
    with torch.no_grad():
        _close(pa.executor(torch.from_numpy(ctx)), expect)


def test_greedy_episode_matches_jax(parts):
    ja, variables, pa, x, img = parts
    out_j = jax.tree_util.tree_map(np.asarray, ja.apply(
        variables, jnp.asarray(x.astype(np.int32)), jnp.asarray(img),
        sample=False, train=False, method=JActor.episode))
    with torch.no_grad():
        out_t = pa.episode(torch.from_numpy(x), torch.from_numpy(img))

    # Guards for this seed: a flip of an op id or a blown-up curve below
    # means a bug, not rounding. Every step's top two masked
    # probabilities stand more than 1e-4 apart, and every tone or color
    # step's knot sums stay at least 0.05 from 0.
    explore = pa.explore_prob
    mask = np.broadcast_to(port_actor_mod.EPISODE_OP_MASK, (3, 11)).copy()
    for s in range(CFG.decoder_max_len):
        probs = np.exp(out_j["logprobs"][:, s]) * (1 - explore) + explore
        probs = probs * mask
        probs = probs / probs.sum(1, keepdims=True)
        top2 = np.sort(probs, axis=1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] > 1e-4).all(), s
        op = out_j["ops"][:, s]
        mask[np.arange(3), op] = 0.0
        for b in range(3):
            p = out_j["params"][b, s]
            if op[b] == 8:                               # tone
                assert abs(p[:8].sum()) >= 0.05
            if op[b] == 6:                               # color
                assert (np.abs(p.reshape(3, 8).sum(1)) >= 0.05).all()

    np.testing.assert_array_equal(out_t["ops"].numpy(), out_j["ops"])
    _close(out_t["params"], out_j["params"])
    _close(out_t["logprobs"], out_j["logprobs"])
    _close(out_t["imgs"], out_j["imgs"], atol=1e-4)
    _close(out_t["attn"], out_j["attn"])
    end_j = np.asarray(jax_select_end(jnp.asarray(out_j["imgs"]),
                                      jnp.asarray(out_j["ops"])))
    end_t = port_actor_mod.select_end_images(out_t["imgs"], out_t["ops"])
    _close(end_t, end_j, atol=1e-4)


def test_state_dict_round_trip_is_exact(parts):
    """convert_state_dict(port.state_dict()) gives back the JAX variables
    the port was loaded from, bit for bit."""
    variables, pa = parts[1], parts[2]
    params, stats = convert_state_dict(pa.state_dict())

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_renorm_masked_probs_end_fallback():
    probs = torch.tensor([[0.1, 0.2, 0.3, 0.4], [0.5, 0.2, 0.2, 0.1]])
    mask = torch.tensor([[0.0, 0.0, 0.0, 0.0], [1.0, 0.0, 1.0, 0.0]])
    out = port_actor_mod._renorm_masked_probs(probs, mask, 4)
    np.testing.assert_array_equal(out[0].numpy(), [0, 0, 1, 0])
    np.testing.assert_allclose(out[1].numpy(), [5 / 7, 0, 2 / 7, 0],
                               rtol=1e-6)


def test_attend_batch_max_mask_matches_jax(parts):
    """attend_batch_max: attention over every position up to the batch's
    longest request, as the reference's unmasked attention."""
    import dataclasses

    ja, variables, pa = parts[0], parts[1], parts[2]
    valid = (np.arange(L)[None] < np.array([[5], [9], [3]])).astype(
        np.float32)
    for flag in (False, True):
        jcfg = dataclasses.replace(CFG, attend_batch_max=flag)
        ja_flag = ja.clone(cfg=jcfg)
        expect = np.asarray(ja_flag.apply(
            variables, jnp.asarray(valid),
            method=lambda m, v: m._attn_mask(v)))
        pa.cfg = dataclasses.replace(pa.cfg, attend_batch_max=flag)
        try:
            got = pa._attn_mask(torch.from_numpy(valid)).numpy()
        finally:
            pa.cfg = dataclasses.replace(pa.cfg, attend_batch_max=False)
        np.testing.assert_array_equal(got, expect)


# -- packing by host lengths ---------------------------------------------------

# (B, L) lengths: ties, a full-length row and a one-token row
LENGTH_CASES = {
    "ties": [3, 5, 3, 5, 1, 3],
    "full_and_one_token": [L, 1, 7, L, 1, 4],
    "all_equal": [6, 6, 6, 6],
}


def _encoder_and_tokens(lengths, fix_embedding=False, seed=0):
    from t2onet_tpu_torch.models.encoder import RNNEncoder

    torch.manual_seed(seed)
    enc = RNNEncoder(30, word_vec_dim=8, hidden_size=6, n_layers=2,
                     fix_embedding=fix_embedding)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, 30, (len(lengths), L))
    tokens[np.arange(L)[None] >= np.array(lengths)[:, None]] = 0
    return enc, torch.from_numpy(tokens)


def _encoded_and_grads(enc, tokens, host_lengths):
    """The encoder's outputs and every parameter's gradient of a loss that
    reaches the outputs, h and c."""
    enc.zero_grad(set_to_none=True)
    out, (h, c), valid = enc(tokens, host_lengths)
    w = torch.linspace(-1, 1, out.shape[-1])
    (out * w).sum().backward(retain_graph=True)
    (h.square().sum() + c.sum()).backward()
    return ([out.detach(), h.detach(), c.detach(), valid],
            [p.grad.clone() for p in enc.parameters() if p.grad is not None])


def _torch_helpers_encoded(enc, tokens, lengths):
    """The encoder as `pack_padded_sequence` / `pad_packed_sequence` pack
    and unpack it: what the port computed before it packed by itself."""
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    packed = pack_padded_sequence(enc.embed(tokens), lengths,
                                  batch_first=True, enforce_sorted=False)
    out, (h, c) = enc.rnn(packed)
    out, _ = pad_packed_sequence(out, batch_first=True,
                                 total_length=tokens.shape[1])
    return out, h, c


@pytest.mark.parametrize("fix_embedding", [False, True])
@pytest.mark.parametrize("case", sorted(LENGTH_CASES))
def test_host_lengths_encoder_is_bit_equal(case, fix_embedding):
    """Packed by host lengths, the encoder's outputs, (h, c), valid mask
    and gradients are bit-equal to the encoder that counts the lengths on
    the device, and its outputs to torch's own pack/pad helpers."""
    lengths = LENGTH_CASES[case]
    enc, tokens = _encoder_and_tokens(lengths, fix_embedding)
    host = torch.tensor(lengths)
    assert torch.equal(host, (tokens != 0).sum(1))
    dev_outs, dev_grads = _encoded_and_grads(enc, tokens, None)
    host_outs, host_grads = _encoded_and_grads(enc, tokens, host)
    assert len(dev_grads) == len(host_grads) > 0
    for a, b in zip(dev_outs + dev_grads, host_outs + host_grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        out, h, c = _torch_helpers_encoded(enc, tokens, host)
    assert torch.equal(out, host_outs[0])
    assert torch.equal(h.view(2, 2, len(lengths), -1).transpose(1, 2)
                       .reshape(2, len(lengths), -1), host_outs[1])
    assert torch.equal(c.view(2, 2, len(lengths), -1).transpose(1, 2)
                       .reshape(2, len(lengths), -1), host_outs[2])
    assert torch.equal(out[host_outs[3] == 0], torch.zeros_like(
        out[host_outs[3] == 0]))


def test_encoder_stats_count_each_path():
    enc, tokens = _encoder_and_tokens(LENGTH_CASES["ties"])
    assert enc.stats == {"calls": 0, "host_packed": 0}
    with torch.no_grad():
        enc(tokens)
        assert enc.stats == {"calls": 1, "host_packed": 0}
        enc(tokens, (tokens != 0).sum(1))
        enc(tokens, (tokens != 0).sum(1))
    assert enc.stats == {"calls": 3, "host_packed": 2}
