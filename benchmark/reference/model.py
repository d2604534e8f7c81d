"""The T2ONet actor, frozen in plain PyTorch for the benchmark's reference.

A functional copy over a flat dict of tensors named as the system names
its parameters (the reference checkpoint's names), so that one dict of
weights made by the benchmark feeds both sides:

- the vision encoder: ResNet-18 (BasicBlocks, a 3x3 stride-2 stem, no
  max-pool, every stage starting at stride 2), BatchNorm after every
  convolution, mean pool, fc, then BatchNorm1d and ReLU;
- the request encoder: a 2-layer bidirectional LSTM over each request's
  true length (outputs zero at padding), written out step by step;
- the decoder step: op embedding and the visual feature into a 2-layer
  LSTM, dot-product attention over the encoder outputs, the op head;
- the eight parameter heads (fc1, LeakyReLU 0.01, fc2) and their
  squashing.

BatchNorm in training normalises with the batch's biased statistics; in
evaluation with the running ones. The running statistics are not moved
here: no number that the benchmark compares reads them.

Precision: `set_precision("f32")` runs every product in float32 with TF32
off; `"tf32"` is the benchmark's control, the nearest precision below the
configuration's: for the convolutions and matrix products TF32 (on a
CUDA device PyTorch's TF32 flags, on the CPU the operands rounded to
TF32's 10-bit mantissa first), and for the chain's element-wise float32
work bfloat16 (`ops.CHAIN_DTYPE`).

This file imports nothing of the system under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import ops as R

_EMULATE_TF32 = False

# ops the rollout may pick, by decoder vocab id: not <NONE>, <START>,
# inpaint (7) or white (10)
EPISODE_OP_MASK = (0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0)
END_ID = 2
START_ID = 1
OP_NAMES = ("brightness", "contrast", "saturation", "color", "inpaint",
            "tone", "sharpness", "white")


def set_precision(mode: str, device) -> None:
    """"f32" or "tf32" for every later product on `device`."""
    global _EMULATE_TF32
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _EMULATE_TF32 = tf32 and torch.device(device).type != "cuda"
    R.CHAIN_DTYPE = torch.bfloat16 if tf32 else torch.float32


def _t(x):
    """x rounded to TF32 (10 explicit mantissa bits, nearest) when the
    CPU emulates it, else x; the gradient passes the rounding as it is."""
    if not _EMULATE_TF32:
        return x
    with torch.no_grad():
        i = x.detach().contiguous().view(torch.int32)
        rounded = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def linear(x, w, b=None):
    return F.linear(_t(x), _t(w), b)


def conv2d(x, w, stride, padding):
    return F.conv2d(_t(x), _t(w), None, stride, padding)


def einsum(eq, a, b):
    return torch.einsum(eq, _t(a), _t(b))


# ---------------------------------------------------------------------------
# the parameters: names, shapes and torch's default initialisation
# ---------------------------------------------------------------------------

def param_specs(cfg: dict, vocab_size: int):
    """[(name, shape, init)] of every parameter and buffer, in the
    system's order; init is ("uniform", limit), ("normal", 1.0),
    ("const", value) or ("count", 0) for BatchNorm's counters."""
    specs = []

    def lin(name, fan_in, fan_out, bias=True):
        lim = 1.0 / math.sqrt(fan_in)
        specs.append((f"{name}.weight", (fan_out, fan_in), ("uniform", lim)))
        if bias:
            specs.append((f"{name}.bias", (fan_out,), ("uniform", lim)))

    def conv(name, cin, cout, k):
        lim = 1.0 / math.sqrt(cin * k * k)
        specs.append((f"{name}.weight", (cout, cin, k, k), ("uniform", lim)))

    def bn(name, c):
        specs.extend([(f"{name}.weight", (c,), ("const", 1.0)),
                      (f"{name}.bias", (c,), ("const", 0.0)),
                      (f"{name}.running_mean", (c,), ("const", 0.0)),
                      (f"{name}.running_var", (c,), ("const", 1.0)),
                      (f"{name}.num_batches_tracked", (), ("count", 0))])

    def lstm(name, in_dim, hidden, layers, bidirectional):
        lim = 1.0 / math.sqrt(hidden)
        for layer in range(layers):
            width = in_dim if layer == 0 else hidden * (
                2 if bidirectional else 1)
            for sfx in (("", "_reverse") if bidirectional else ("",)):
                s = f"l{layer}{sfx}"
                specs.extend([
                    (f"{name}.weight_ih_{s}", (4 * hidden, width),
                     ("uniform", lim)),
                    (f"{name}.weight_hh_{s}", (4 * hidden, hidden),
                     ("uniform", lim)),
                    (f"{name}.bias_ih_{s}", (4 * hidden,), ("uniform", lim)),
                    (f"{name}.bias_hh_{s}", (4 * hidden,), ("const", 0.0))])

    widths = cfg["resnet_widths"]
    conv("vis_encoder.conv1", 3, widths[0], 3)
    bn("vis_encoder.bn1", widths[0])
    cin = widths[0]
    for s, planes in enumerate(widths, 1):
        for i in range(2):
            p = f"vis_encoder.layer{s}.{i}"
            conv(f"{p}.conv1", cin, planes, 3)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            if i == 0:        # every stage starts at stride 2
                conv(f"{p}.shortcut.0", cin, planes, 1)
                bn(f"{p}.shortcut.1", planes)
            cin = planes
    lin("vis_encoder.fc", cin, cfg["vis_feat_dim"])
    bn("bn1", cfg["vis_feat_dim"])
    specs.append(("lang_encoder.embedding.weight",
                  (vocab_size, cfg["word_vec_dim"]), ("normal", 1.0)))
    lstm("lang_encoder.rnn", cfg["word_vec_dim"], cfg["hidden_size"],
         cfg["n_layers"], True)
    dec = 2 * cfg["hidden_size"]
    specs.append(("decoder.embedding.weight",
                  (cfg["op_vocab_size"], cfg["word_vec_dim"]),
                  ("normal", 1.0)))
    lstm("decoder.rnn", cfg["word_vec_dim"] + dec, dec, cfg["n_layers"],
         False)
    lin("decoder.vis_linear", cfg["vis_feat_dim"], dec)
    lin("decoder.out_linear", dec, cfg["op_vocab_size"])
    lin("decoder.attention.linear_out", 2 * dec, dec)
    for name, k in zip(OP_NAMES, R.PARAM_COUNTS):
        lin(f"executor.{name}_op.fc1", dec, cfg["operator_fc_dim"])
        lin(f"executor.{name}_op.fc2", cfg["operator_fc_dim"], k)
    return specs


def trainable_names(specs):
    """The names an optimizer steps: not BatchNorm's statistics, and not
    the LSTMs' second bias, which the system holds at zero."""
    return [n for n, _, init in specs
            if init[0] != "count" and not n.endswith(("running_mean",
                                                       "running_var"))
            and ".bias_hh_" not in n]


# ---------------------------------------------------------------------------
# the vision encoder
# ---------------------------------------------------------------------------

def batch_norm(P, name, x, train: bool, eps: float = 1e-5):
    if train:
        return F.batch_norm(x, None, None, P[f"{name}.weight"],
                            P[f"{name}.bias"], True, 0.0, eps)
    return F.batch_norm(x, P[f"{name}.running_mean"],
                        P[f"{name}.running_var"], P[f"{name}.weight"],
                        P[f"{name}.bias"], False, 0.0, eps)


def resnet(P, cfg, img, train: bool):
    x = conv2d(img, P["vis_encoder.conv1.weight"], 2, 1)
    x = F.relu(batch_norm(P, "vis_encoder.bn1", x, train))
    for s in range(1, len(cfg["resnet_widths"]) + 1):
        for i in range(2):
            p = f"vis_encoder.layer{s}.{i}"
            stride = 2 if i == 0 else 1
            y = conv2d(x, P[f"{p}.conv1.weight"], stride, 1)
            y = F.relu(batch_norm(P, f"{p}.bn1", y, train))
            y = conv2d(y, P[f"{p}.conv2.weight"], 1, 1)
            y = batch_norm(P, f"{p}.bn2", y, train)
            if i == 0:
                x = batch_norm(P, f"{p}.shortcut.1", conv2d(
                    x, P[f"{p}.shortcut.0.weight"], stride, 0), train)
            x = F.relu(y + x)
    x = torch.mean(x, dim=(2, 3))
    return linear(x, P["vis_encoder.fc.weight"], P["vis_encoder.fc.bias"])


def vis_feat(P, cfg, img, train: bool):
    return F.relu(batch_norm(P, "bn1", resnet(P, cfg, img, train), train))


# ---------------------------------------------------------------------------
# the request encoder and the decoder step
# ---------------------------------------------------------------------------

def lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    gates = linear(x, w_ih, b_ih) + linear(h, w_hh, b_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def encode_request(P, cfg, tokens):
    """tokens (B, L), zero after each request -> (outputs (B, L, 2H), zero
    at padding; per layer (h, c) (B, 2H), the two directions' final
    states side by side; valid (B, L) float)."""
    b, length = tokens.shape
    n_valid = (tokens != 0).sum(dim=1)
    valid = (torch.arange(length, device=tokens.device)[None]
             < n_valid[:, None]).to(torch.float32)
    x = F.embedding(tokens, P["lang_encoder.embedding.weight"])
    hid = cfg["hidden_size"]
    finals = []
    for layer in range(cfg["n_layers"]):
        outs = []
        states = []
        for sfx, order in (("", range(length)),
                           ("_reverse", range(length - 1, -1, -1))):
            w = [P[f"lang_encoder.rnn.{k}_l{layer}{sfx}"] for k in
                 ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            h = x.new_zeros((b, hid))
            c = x.new_zeros((b, hid))
            out = [None] * length
            for t in order:
                h2, c2 = lstm_cell(x[:, t], h, c, *w)
                keep = valid[:, t:t + 1]
                h = keep * h2 + (1.0 - keep) * h
                c = keep * c2 + (1.0 - keep) * c
                out[t] = h2 * keep
            outs.append(torch.stack(out, dim=1))
            states.append((h, c))
        x = torch.cat(outs, dim=-1)
        finals.append((torch.cat([states[0][0], states[1][0]], dim=-1),
                       torch.cat([states[0][1], states[1][1]], dim=-1)))
    return x, finals, valid


def decoder_step(P, cfg, op_ids, carry, enc_out, enc_valid, feat):
    """-> (log-probs (B, n_ops), new carry, context (B, 2H))."""
    vis = F.relu(linear(feat, P["decoder.vis_linear.weight"],
                        P["decoder.vis_linear.bias"]))
    x = torch.cat([F.embedding(op_ids, P["decoder.embedding.weight"]), vis],
                  dim=-1)
    new = []
    for layer in range(cfg["n_layers"]):
        h, c = lstm_cell(x, *carry[layer], *[
            P[f"decoder.rnn.{k}_l{layer}"] for k in
            ("weight_ih", "weight_hh", "bias_ih", "bias_hh")])
        new.append((h, c))
        x = h
    scores = einsum("bh,blh->bl", x, enc_out)
    scores = torch.where(enc_valid > 0, scores, torch.full_like(scores, -1e9))
    attn = torch.softmax(scores, dim=-1)
    mix = einsum("bl,blh->bh", attn, enc_out)
    context = torch.tanh(linear(torch.cat([mix, x], dim=-1),
                                P["decoder.attention.linear_out.weight"],
                                P["decoder.attention.linear_out.bias"]))
    logits = linear(context, P["decoder.out_linear.weight"],
                    P["decoder.out_linear.bias"])
    return F.log_softmax(logits, dim=-1), new, context


def heads(P, op_cfg, context):
    """Every op's squashed parameters (B, 8, 24)."""
    raw = []
    for name in OP_NAMES:
        h = F.leaky_relu(linear(context, P[f"executor.{name}_op.fc1.weight"],
                                P[f"executor.{name}_op.fc1.bias"]), 0.01)
        out = linear(h, P[f"executor.{name}_op.fc2.weight"],
                     P[f"executor.{name}_op.fc2.bias"])
        raw.append(F.pad(out, (0, R.MAX_PARAM - out.shape[1])))
    return R.squash_params(torch.stack(raw, dim=1), op_cfg)


def pick(per_op, op_vocab_ids):
    """The chosen op's parameter row (B, 24); zeros for special ids."""
    idx = (op_vocab_ids - 3).clamp(0, R.N_OPS - 1)
    row = per_op[torch.arange(per_op.shape[0], device=per_op.device), idx]
    return torch.where((op_vocab_ids >= 3)[:, None], row,
                       torch.zeros_like(row))


def rollout_probs(logprob, op_mask, explore_prob: float):
    """The decode's distribution: explore smoothing, the hard mask and a
    renormalisation; a row the mask empties takes <END>."""
    probs = torch.exp(logprob) * (1.0 - explore_prob) + explore_prob
    probs = probs * op_mask
    total = probs.sum(dim=1, keepdim=True)
    end = F.one_hot(torch.full((probs.shape[0],), END_ID,
                               device=probs.device),
                    probs.shape[1]).to(probs.dtype)
    return torch.where(total > 0.0, probs / (total + 1e-30), end)


# ---------------------------------------------------------------------------
# serving: the greedy decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode(P, cfg, op_cfg, tokens, probe, served_ops=None,
           explore_prob: float = 0.05):
    """The greedy decode at the probe resolution, in evaluation mode.

    With `served_ops` (B, S) (vocab ids, -1 past a request's <END>) the
    decode follows the served ops (teacher forcing) and returns, for each
    step, the gap by which the served op's log-probability lies below the
    best one (B, S) (0 past the end), with the reference's own parameters
    (B, S, 24). Without, it picks its own ops: (ops (B, S), params)."""
    b = tokens.shape[0]
    enc_out, finals, enc_valid = encode_request(P, cfg, tokens)
    carry = finals
    op_mask = torch.tensor(EPISODE_OP_MASK, device=tokens.device) \
        .expand(b, cfg["op_vocab_size"])
    prev = torch.full((b,), START_ID, dtype=torch.long, device=tokens.device)
    img = probe
    gaps, params, ops = [], [], []
    for s in range(cfg["decoder_max_len"]):
        logprob, carry, context = decoder_step(
            P, cfg, prev, carry, enc_out, enc_valid,
            vis_feat(P, cfg, img, train=False))
        probs = rollout_probs(logprob, op_mask, explore_prob)
        best = torch.argmax(probs, dim=-1)
        if served_ops is None:
            op = best
        else:
            live = served_ops[:, s] >= 0
            op = torch.where(live, served_ops[:, s], best)
            # a masked op (probability 0) reads a finite gap, ~69
            logp = torch.log(probs + 1e-30)
            gap = (logp.gather(1, best[:, None])
                   - logp.gather(1, op[:, None]))[:, 0]
            gaps.append(torch.where(live, gap, torch.zeros_like(gap)))
        op_mask = op_mask * (1.0 - F.one_hot(
            op, cfg["op_vocab_size"]).to(op_mask.dtype))
        chosen = pick(heads(P, op_cfg, context), op)
        img = R.execute_selected(img, op, chosen)
        params.append(chosen)
        ops.append(op)
        prev = op
    params = torch.stack(params, dim=1)
    if served_ops is None:
        return torch.stack(ops, dim=1), params
    return torch.stack(gaps, dim=1), params


def program_slots(ops):
    """Decoded vocab ids (B, S) -> chain slots, identity at and after each
    row's first <END>."""
    after = torch.cumsum((ops == END_ID).to(torch.int32), dim=1) > 0
    return torch.where(after, torch.zeros_like(ops), R.vocab_to_slot(ops))


# ---------------------------------------------------------------------------
# training: the two phases' losses
# ---------------------------------------------------------------------------

def supervised_loss(P, cfg, op_cfg, batch):
    """The teacher-forced phase: op NLL over the positions up to the
    batch's longest op sequence, plus the parameter MSE summed and
    divided by the number of nonzero ground-truth parameters. All the
    steps' images go through one ResNet forward (BatchNorm's statistics
    over B x steps images)."""
    x, y = batch["x"].long(), batch["y"].long()
    img_x, img_y, gt = batch["img_x"], batch["img_y"], batch["gt_params"]
    enc_out, carry, enc_valid = encode_request(P, cfg, x)
    n_dec = y.shape[1] - 1
    b = img_x.shape[0]
    steps = torch.cat([img_x[:, None], img_y[:, :n_dec - 1]], dim=1)
    feats = vis_feat(P, cfg, steps.reshape((b * n_dec,) + steps.shape[2:]),
                     train=True).reshape(b, n_dec, -1)
    logprobs, params = [], []
    for i in range(1, n_dec + 1):
        logprob, carry, context = decoder_step(
            P, cfg, y[:, i - 1], carry, enc_out, enc_valid, feats[:, i - 1])
        logprobs.append(logprob)
        if i < n_dec:
            params.append(pick(heads(P, op_cfg, context), y[:, i]))
    logprobs = torch.stack(logprobs, dim=1)
    params = torch.stack(params, dim=1)
    targets = y[:, 1:]
    pos = (targets != 0).any(dim=0).to(logprobs.dtype)
    nll = -torch.gather(logprobs, 2, targets[:, :, None])[..., 0]
    op_loss = (nll * pos[None]).sum() / (b * pos.sum())
    nnz = (gt != 0).sum()
    param_loss = ((params - gt) ** 2).sum() / torch.clamp_min(nnz, 1)
    return op_loss + param_loss


def episode_loss(P, cfg, op_cfg, batch, gumbel, explore_prob: float = 0.05):
    """The sampled rollout: at each step an op by Gumbel-max over
    log(probs + 1e-30) with the draw `gumbel(step, shape)`, its
    parameters, one chain step (through the predicted op's mask where
    the batch has masks); the mean L1 of each image at its first <END>
    (else the last) to the ground truth, with +1 as |.|'s slope at 0."""
    x = batch["x"].long()
    img = batch["img_x"]
    masks = batch.get("masks_vocab")
    b = x.shape[0]
    enc_out, carry, enc_valid = encode_request(P, cfg, x)
    op_mask = torch.tensor(EPISODE_OP_MASK, device=x.device) \
        .expand(b, cfg["op_vocab_size"])
    prev = torch.full((b,), START_ID, dtype=torch.long, device=x.device)
    imgs, ops = [], []
    rows = torch.arange(b, device=x.device)
    for s in range(cfg["decoder_max_len"]):
        logprob, carry, context = decoder_step(
            P, cfg, prev, carry, enc_out, enc_valid,
            vis_feat(P, cfg, img, train=True))
        probs = rollout_probs(logprob, op_mask, explore_prob)
        op = torch.argmax(gumbel(s, tuple(probs.shape))
                          + torch.log(probs.detach() + 1e-30), dim=-1)
        op_mask = op_mask * (1.0 - F.one_hot(
            op, cfg["op_vocab_size"]).to(op_mask.dtype))
        mask = None if masks is None else masks[rows, op].to(img.dtype)
        chosen = pick(heads(P, op_cfg, context), op)
        img = R.chain_step(img, R.vocab_to_slot(op), chosen, mask)
        imgs.append(img)
        ops.append(op)
        prev = op
    ops = torch.stack(ops, dim=1)
    is_end = ops == END_ID
    first = torch.argmax(is_end.to(torch.int32), dim=1)
    idx = torch.where(is_end.any(dim=1), first,
                      torch.full_like(first, ops.shape[1] - 1))
    pred = torch.stack(imgs, dim=1)[rows, idx]
    d = pred - batch["gt_img"]
    return torch.where(d >= 0, d, -d).mean()


def adam_step(P, names, grads, state, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step (PyTorch's form, no weight decay) of P[names] in
    place; `state` holds the moments and the count; a missing gradient
    counts as zero."""
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    with torch.no_grad():
        for n in names:
            g = grads.get(n)
            if g is None:
                g = torch.zeros_like(P[n])
            m = state.setdefault(("m", n), torch.zeros_like(P[n]))
            v = state.setdefault(("v", n), torch.zeros_like(P[n]))
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v.sqrt() / math.sqrt(1.0 - b2 ** t)).add_(eps)
            P[n].addcdiv_(m, denom, value=-lr / (1.0 - b1 ** t))
