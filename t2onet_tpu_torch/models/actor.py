"""The actor: request + image -> op program (counterpart of
`t2onet_tpu.models.actor`): the teacher-forced pass of supervised
training, the free rollout (greedy or sampled, executed through the bank
or through the fused step kernels, optionally decoded at a probe
resolution and with noise on the parameters) and the single RL step.
BatchNorm follows the module's mode: `actor.train()` for training,
`actor.eval()` for serving and validation.

The config's modes: a Bottleneck ResNet (resnet_depth 50, 101, 152), the
ResNet in bf16 (vis_bf16), and parameters classified over bins
(discrete_param, discrete_step).

Module names are the reference checkpoint's (`vis_encoder`, `bn1`,
`lang_encoder`, `decoder`, `executor.<op>_op.fc1/fc2`), so
`t2onet_tpu.convert.convert_state_dict(actor.state_dict())` reads a
port actor of the default modes as it reads a reference checkpoint.

Random draws (op choices, bins, parameter noise) come from a
`torch.Generator`, or are fed in: `noise_fn(shape)` gives Gumbel draws,
`normal_fn(shape)` standard-normal ones, in the order the JAX package
splits its key (each step: the op, then the bins, then the noise).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from t2onet_tpu_torch.config import ModelConfig, OperatorConfig
from t2onet_tpu_torch.models.common import FlaxBatchNorm1d, init_torch_defaults
from t2onet_tpu_torch.models.decoder import DecoderStep
from t2onet_tpu_torch.models.encoder import RNNEncoder
from t2onet_tpu_torch.models.resnet import ResNet
from t2onet_tpu_torch.ops import bank
from t2onet_tpu_torch.ops.bank import gumbel_noise
from t2onet_tpu_torch.ops.chain import vocab_ops_to_slots
from t2onet_tpu_torch.ops.operators import OP_NAMES, PARAM_COUNTS
from t2onet_tpu_torch.ops.step import fused_step
from t2onet_tpu_torch.parallel import mesh

# Ops the rollout may pick: blocks <NONE>, <START>, inpaint_obj, color_bg
# (vocab order <NONE> <START> <END> brightness contrast saturation hue
#  inpaint_obj tint sharpness color_bg).
EPISODE_OP_MASK = np.array(
    [0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 0.0], dtype=np.float32)

END_OP_ID = 2

_OP_MASKS = {}              # EPISODE_OP_MASK on each device, made once


def episode_op_mask(device):
    """EPISODE_OP_MASK as a tensor on `device`, made there once. Not a
    buffer, so the state_dict keys stay the reference's. Made outside
    inference mode, so a training step can save it for its backward
    after serving made it; never written in place. Copying it from
    pageable host memory on every episode would be a host-to-device copy
    that a CUDA graph's capture forbids."""
    device = torch.device(device)
    mask = _OP_MASKS.get(device)
    if mask is None:
        with torch.inference_mode(False):
            mask = torch.as_tensor(EPISODE_OP_MASK, device=device)
        _OP_MASKS[device] = mask
    return mask


def _renorm_masked_probs(probs, op_mask, n_vocab):
    """Hard-mask and renormalise; a row the mask empties entirely emits
    <END> (always legal and terminal) instead of a uniform draw."""
    probs = probs * op_mask
    total = probs.sum(dim=1, keepdim=True)
    end = F.one_hot(torch.full((probs.shape[0],), END_OP_ID,
                               device=probs.device), n_vocab).to(probs.dtype)
    return torch.where(total > 0.0, probs / (total + 1e-30), end)


def fc2_widths(discrete_step: int = 0):
    """fc2's outputs per op: its parameter count, and in the discrete mode
    (discrete_step > 0) at least discrete_step, whose first columns are
    the bin logits (the JAX package reads them from its 24-column head,
    so narrower heads would leave bins at a constant 0 logit)."""
    return tuple(max(k, discrete_step) for k in PARAM_COUNTS)


def _draws(generator, noise_fn, normal_fn):
    """draw(kind, shape): "gumbel" or "normal" draws from the fed
    functions, else from `generator`; raises where neither is given."""
    def draw(kind, shape):
        fn = noise_fn if kind == "gumbel" else normal_fn
        if fn is not None:
            return fn(shape)
        if generator is None:
            raise ValueError(f"a {kind} draw needs a generator or a fed "
                             f"noise function: no silent default "
                             f"randomness")
        if kind == "gumbel":
            return gumbel_noise(shape, generator)
        return torch.randn(shape, generator=generator,
                           device=generator.device)
    return draw


class _OpHead(nn.Module):
    def __init__(self, ctx_dim: int, fc_dim: int, n_param: int):
        super().__init__()
        self.fc1 = nn.Linear(ctx_dim, fc_dim)
        self.fc2 = nn.Linear(fc_dim, n_param)


class ParamHeads(nn.Module):
    """The eight per-op parameter heads (fc1 -> LeakyReLU -> fc2), run as
    two batched products over weights stacked and zero-padded to 24
    outputs, as `t2onet_tpu.ops.bank.raw_head_features` runs them. fc2
    has `fc2_widths(discrete_step)` outputs.

    Under a (data x model) grid (`parallel.mesh.make_2d_mesh`) a training
    forward computes only this rank's block of heads (`mesh.owned_heads`)
    and gathers the features of the others (`mesh.gather_heads`); the
    context's gradient is summed over the model group
    (`mesh.heads_input`). The other heads' weights go stale here until
    `TrainState.gather` brings them. An eval-mode forward computes every head locally, so it needs
    them gathered first."""

    def __init__(self, opcfg: OperatorConfig, ctx_dim: int = 512,
                 fc_dim: int = 512, discrete_step: int = 0):
        super().__init__()
        self.opcfg = opcfg
        for name, k in zip(OP_NAMES, fc2_widths(discrete_step)):
            setattr(self, f"{name}_op", _OpHead(ctx_dim, fc_dim, k))

    def stacked(self, ops=range(len(OP_NAMES))):
        """(w1, b1, w2, b2) of the heads `ops`, stacked in that order."""
        heads = [getattr(self, f"{OP_NAMES[i]}_op") for i in ops]
        w1 = torch.stack([h.fc1.weight.t() for h in heads])
        b1 = torch.stack([h.fc1.bias for h in heads])
        w2 = torch.stack([F.pad(h.fc2.weight.t(),
                                (0, bank.MAX_PARAM - h.fc2.out_features))
                          for h in heads])
        b2 = torch.stack([F.pad(h.fc2.bias,
                                (0, bank.MAX_PARAM - h.fc2.out_features))
                          for h in heads])
        return w1, b1, w2, b2

    def forward(self, context, with_raw: bool = False):
        """context (B, ctx) -> squashed per-op params (B, 8, 24), and with
        `with_raw` the raw features (B, 8, 24) too (the discrete mode's bin
        logits)."""
        if self.training and mesh.model_size() > 1:
            raw = mesh.gather_heads(bank.raw_head_features(
                *self.stacked(mesh.owned_heads()), mesh.heads_input(context)))
        else:
            raw = bank.raw_head_features(*self.stacked(), context)
        squashed = bank.squash_params(raw, self.opcfg)
        return (squashed, raw) if with_raw else squashed


class Actor(nn.Module):
    def __init__(self, cfg: ModelConfig, opcfg: OperatorConfig,
                 vocab_size: int, *, generator: torch.Generator,
                 explore_prob: float = 0.05, word2vec=None):
        """Weights are drawn on the CPU from `generator` by torch's
        default init; move the actor with `.to(device)`. `word2vec`
        (vocab_size - n_spec_token, word_vec_dim), the GloVe matrix,
        replaces the word rows of the request embedding; the special
        tokens' rows stay drawn from `generator`. With
        cfg.fix_input_embedding the word rows are not trained."""
        super().__init__()
        if cfg.discrete_param and not 2 <= cfg.discrete_step <= bank.MAX_PARAM:
            raise ValueError(f"discrete_step {cfg.discrete_step}: the bins "
                             f"are head columns, 2 to {bank.MAX_PARAM}")
        self.cfg = cfg
        self.opcfg = opcfg
        self.explore_prob = explore_prob
        with torch.device("meta"):
            self.vis_encoder = ResNet(cfg.resnet_depth, cfg.vis_feat_dim,
                                      cfg.resnet_widths, bf16=cfg.vis_bf16)
            self.bn1 = FlaxBatchNorm1d(cfg.vis_feat_dim, eps=1e-5,
                                       momentum=0.1)
            self.lang_encoder = RNNEncoder(
                vocab_size, cfg.word_vec_dim, cfg.hidden_size, cfg.n_layers,
                pad_id=cfg.null_id, n_spec_token=cfg.n_spec_token,
                fix_embedding=cfg.fix_input_embedding)
            self.decoder = DecoderStep(cfg.op_vocab_size, cfg.word_vec_dim,
                                       cfg.decoder_hidden, cfg.n_layers,
                                       cfg.use_attention, cfg.vis_feat_dim)
            self.executor = ParamHeads(
                opcfg, cfg.decoder_hidden, cfg.operator_fc_dim,
                cfg.discrete_step if cfg.discrete_param else 0)
        self.to_empty(device="cpu")
        init_torch_defaults(self, generator)
        if word2vec is not None:
            glove = torch.as_tensor(np.asarray(word2vec, np.float32))
            rows = (vocab_size - cfg.n_spec_token, cfg.word_vec_dim)
            if tuple(glove.shape) != rows:
                raise ValueError(f"word2vec is {tuple(glove.shape)}, the "
                                 f"embedding's word rows {rows}")
            with torch.no_grad():
                self.lang_encoder.embedding.weight[cfg.n_spec_token:] \
                    .copy_(glove)

    def _attn_mask(self, enc_valid):
        """Each request's true length, or with cfg.attend_batch_max every
        position up to the batch's longest request (the reference's
        unmasked attention over zero-padded encoder outputs). A training
        step under data parallelism takes the global batch's longest;
        evaluation (rank 0 alone) its own batch's."""
        if not self.cfg.attend_batch_max:
            return enc_valid
        longest = enc_valid.sum(dim=1).max()
        if self.training:
            longest = mesh.global_max(longest)
        pos = torch.arange(enc_valid.shape[1], device=enc_valid.device)
        return (pos < longest).to(enc_valid.dtype).expand_as(enc_valid)

    def vis_feat(self, img):
        """ResNet feature -> BN1d -> ReLU (BatchNorm in the module's mode)."""
        return F.relu(self.bn1(self.vis_encoder(img)))

    def _step_params(self, context, sample: bool = False, draw=None):
        """Per-op params from the decoder context: (params (B, 8, 24), bin
        log-probs (B, 8, discrete_step) in the discrete mode, else None).
        A sampled discrete step takes its Gumbel draw from `draw`."""
        if not self.cfg.discrete_param:
            return self.executor(context), None
        cont, raw = self.executor(context, with_raw=True)
        num = self.cfg.discrete_step
        gumbel = (draw("gumbel", (context.shape[0], bank.N_OPS, num))
                  if sample else None)
        return bank.select_discrete_params(
            raw, cont, sample, self.explore_prob, self.opcfg, num,
            gumbel=gumbel)

    def supervised(self, x, y, img_x, img_y, with_images: bool = False,
                   mask=None, step_masks=None, per_step_bn: bool = False):
        """Teacher-forced pass. By default all n_dec = T-1 visual encodings
        (img_x, then the teacher images) run as one batched ResNet
        forward, so in train mode BatchNorm's statistics are over
        B * n_dec images, as in the JAX package; `per_step_bn` runs one
        forward per decode step (the reference's statistics over B, the
        running averages chained over the n_dec calls).

        :param x: (B, L) request tokens.
        :param y: (B, T) op sequence [START, op*, END, NONE...].
        :param img_x: (B, 3, H, W); img_y (B, T-1, 3, H, W) teacher images.
        :param with_images: also execute each step's ground-truth op on
            its teacher input through the bank (no loss reads them).
        :param mask: optional (B, 1|3, H, W) mask blended at every step;
            step_masks (B, T-2, 1, H, W) per-step masks override it.
        :return: (pred_imgs (B, T-2, 3, H, W) or None, pred_params
            (B, T-2, 24), op_logprobs (B, T-1, n_cls)), and in the
            discrete mode a 4th element, the bin log-probs
            (B, T-2, 8, discrete_step).
        """
        return self.teacher_forced(
            self.lang_encoder(x), y, img_x, img_y, with_images=with_images,
            mask=mask, step_masks=step_masks, per_step_bn=per_step_bn)

    def teacher_forced(self, encoded, y, img_x, img_y,
                       with_images: bool = False, mask=None, step_masks=None,
                       per_step_bn: bool = False):
        """`supervised` from the request encoder's outputs on: `encoded`
        is `lang_encoder(x)`'s (outputs, (h, c), valid); the other
        arguments and the result are `supervised`'s. Its shapes follow the
        batch alone and it reads nothing back from the device: the
        supervised training step replays it, its losses and their
        backward as a CUDA graph (`utils.graphs`)."""
        enc_out, enc_hidden, enc_valid = encoded
        enc_valid = self._attn_mask(enc_valid)
        carry = self.decoder.init_carry(enc_hidden)
        n_dec = y.shape[1] - 1
        b = img_x.shape[0]
        steps = torch.cat([img_x[:, None], img_y[:, :n_dec - 1]], dim=1)
        if per_step_bn:
            feats = torch.stack([self.vis_feat(steps[:, i])
                                 for i in range(n_dec)], dim=1)
        else:
            feats = self.vis_feat(
                steps.reshape((b * n_dec,) + steps.shape[2:]))
            feats = feats.reshape(b, n_dec, -1)
        logprobs, params, imgs, bin_logps = [], [], [], []
        for i in range(1, n_dec + 1):
            logprob, carry, _, context = self.decoder(
                y[:, i - 1], carry, enc_out, enc_valid, feats[:, i - 1])
            logprobs.append(logprob)
            if i == n_dec:
                break
            per_op, bin_logp = self._step_params(context)
            bin_logps.append(bin_logp)
            if with_images:
                step_mask = (step_masks[:, i - 1] if step_masks is not None
                             else mask)
                out_img, chosen = bank.execute_bank(
                    steps[:, i - 1], y[:, i], per_op, mask=step_mask)
                imgs.append(out_img)
            else:
                chosen = bank.select_params(y[:, i], per_op)
            params.append(chosen)
        out = (torch.stack(imgs, dim=1) if with_images else None,
               torch.stack(params, dim=1), torch.stack(logprobs, dim=1))
        if self.cfg.discrete_param:
            out += (torch.stack(bin_logps, dim=1),)
        return out

    def _probe(self, img, probe_size):
        """The view the vis encoder sees: the image, or with `probe_size`
        a bilinear resize to probe_size x probe_size, antialiased when it
        shrinks, as `jax.image.resize(method="bilinear")` (gradients flow
        through it). The serving engine's probe is a different, plain
        resize: it matches the native C++ resize of the JAX engine."""
        if probe_size is None or probe_size == img.shape[-1]:
            return img
        return F.interpolate(img, size=(probe_size, probe_size),
                             mode="bilinear", align_corners=False,
                             antialias=True)

    def episode(self, x, img_x, sample: bool = False, generator=None,
                noise_fn=None, fused_exec: bool = False, masks=None,
                param_noise: float = 0.0, probe_size=None, normal_fn=None,
                host_lengths=None):
        """Free rollout of decoder_max_len steps. Each step encodes the
        current image (or its `probe_size` view), decodes one op (explore
        smoothing, hard mask, then argmax, or with `sample` a Gumbel-max
        draw over log(probs + 1e-30) as `jax.random.categorical` draws;
        no-repeat update), predicts its params (in the discrete mode the
        argmax bins, or sampled bins with `sample`; with `param_noise` > 0
        plus range-scaled noise, `bank.add_param_noise`) and executes it
        at full resolution: through the bank, or with `fused_exec`
        through `ops.step.fused_step` (only the selected op, forward and
        backward; the chain and step_bwd kernels on a CUDA tensor, their
        masked twins with `masks`).

        :param x: (B, L) request tokens; img_x (B, 3, H, W).
        :param generator: torch.Generator on the actor's device for the
            draws (sample=True, param_noise > 0).
        :param noise_fn: optional fn(shape) -> Gumbel noise in place of
            draws from `generator`: (B, n_cls) for the op, (B, 8,
            discrete_step) for the bins; `normal_fn` (B, 8, 24) normal
            draws for the parameter noise (tests feed JAX's draws).
        :param masks: optional (B, n_cls, 1, H, W) per-op ground-truth
            masks (GIER local edits): each step blends its op's result
            into the image through the mask of the op it predicted, the
            JAX package's einsum of one-hot(op) with `masks`, taken here
            as a gather (the same values, exactly).
        :param probe_size: decode at this resolution (`_probe`), execute
            and return images at the input's.
        :param host_lengths: the requests' token counts as a CPU tensor
            (`RNNEncoder.forward`), so that the rollout reads nothing back
            from the device.
        :return: dict with imgs (B, S, 3, H, W), ops (B, S),
            params (B, S, 24), logprobs (B, S, n_cls), attn (B, S, L).
        """
        return self.rollout(self.lang_encoder(x, host_lengths), img_x,
                            sample=sample, generator=generator,
                            noise_fn=noise_fn, fused_exec=fused_exec,
                            masks=masks, param_noise=param_noise,
                            probe_size=probe_size, normal_fn=normal_fn)

    def rollout(self, encoded, img_x, sample: bool = False, generator=None,
                noise_fn=None, fused_exec: bool = False, masks=None,
                param_noise: float = 0.0, probe_size=None, normal_fn=None):
        """`episode` from the request encoder's outputs on: `encoded` is
        `lang_encoder(x)`'s (outputs, (h, c), valid); the other arguments
        and the result are `episode`'s. Greedy, its shapes follow the rows
        and the image alone and it reads nothing back from the device: the
        serving engine replays it as a CUDA graph (`utils.graphs`)."""
        cfg = self.cfg
        b = img_x.shape[0]
        device = img_x.device
        draw = _draws(generator, noise_fn, normal_fn)
        enc_out, enc_hidden, enc_valid = encoded
        enc_valid = self._attn_mask(enc_valid)
        carry = self.decoder.init_carry(enc_hidden)
        op_mask = episode_op_mask(device).expand(b, cfg.op_vocab_size)
        pred_op = torch.full((b,), cfg.start_id, dtype=torch.long,
                             device=device)
        img = img_x
        ys = {"imgs": [], "ops": [], "params": [], "logprobs": [],
              "attn": []}
        for _ in range(cfg.decoder_max_len):
            feat = self.vis_feat(self._probe(img, probe_size))
            logprob, carry, attn, context = self.decoder(
                pred_op, carry, enc_out, enc_valid, feat)
            probs = (torch.exp(logprob) * (1.0 - self.explore_prob)
                     + self.explore_prob)
            probs = _renorm_masked_probs(probs, op_mask, cfg.op_vocab_size)
            if sample:
                pred_op = torch.argmax(
                    draw("gumbel", probs.shape)
                    + torch.log(probs.detach() + 1e-30), dim=-1)
            else:
                pred_op = torch.argmax(probs, dim=-1)
            op_mask = op_mask * (1.0 - F.one_hot(
                pred_op, cfg.op_vocab_size).to(op_mask.dtype))
            step_mask = None
            if masks is not None:
                step_mask = masks[torch.arange(b, device=masks.device),
                                  pred_op].to(img.dtype)
            per_op, _ = self._step_params(context, sample, draw)
            if param_noise > 0.0:
                per_op = bank.add_param_noise(
                    per_op, self.opcfg, param_noise,
                    normal=draw("normal", per_op.shape))
            if fused_exec:
                chosen = bank.select_params(pred_op, per_op)
                img = fused_step(img, vocab_ops_to_slots(pred_op[:, None])
                                 [:, 0], chosen, mask=step_mask)
            else:
                img, chosen = bank.execute_bank(img, pred_op, per_op,
                                                mask=step_mask)
            for key, val in (("imgs", img), ("ops", pred_op),
                             ("params", chosen), ("logprobs", logprob),
                             ("attn", attn)):
                ys[key].append(val)
        out = {k: torch.stack(v, dim=1) for k, v in ys.items()
               if k != "attn"}
        out["attn"] = (torch.stack(ys["attn"], dim=1)
                       if cfg.use_attention else None)
        return out

    def rl_step(self, x, img_x, carry, op, generator=None, noise_fn=None,
                normal_fn=None, masks=None, param_noise: float = 0.0,
                op_mask=None):
        """One RL step (the reference's `Actor.forward`): decode one op
        from the previous op `op` (B,) and the current image, sample it
        under the hard op mask, predict its params (sampled bins in the
        discrete mode; `param_noise` as in `episode`), execute it through
        the bank, and decode again on the result for the next context.
        The request encoder runs without gradient. Thread `op_mask`
        (returned updated) across calls to keep the no-repeat rule; None
        starts a fresh episode mask. Draws as in `episode`.

        :param carry: the decoder's carry, e.g.
            `decoder.init_carry(lang_encoder(x)[1])` to start.
        :return: (pred_img, op_logprob, entropy_penalty (B, 1), context,
            next_context, new_carry, pred_op, new_op_mask).
        """
        cfg = self.cfg
        b = x.shape[0]
        draw = _draws(generator, noise_fn, normal_fn)
        with torch.no_grad():
            enc_out, _, enc_valid = self.lang_encoder(x)
        enc_valid = self._attn_mask(enc_valid)
        logprob, carry, _, context = self.decoder(
            op, carry, enc_out, enc_valid, self.vis_feat(img_x))
        entropy_penalty = get_entropy_penalty(logprob)
        probs = (torch.exp(logprob) * (1.0 - self.explore_prob)
                 + self.explore_prob)
        if op_mask is None:
            op_mask = episode_op_mask(x.device).expand(b, cfg.op_vocab_size)
        probs = _renorm_masked_probs(probs, op_mask, cfg.op_vocab_size)
        pred_op = torch.argmax(draw("gumbel", probs.shape)
                               + torch.log(probs.detach() + 1e-30), dim=-1)
        step_mask = None
        if masks is not None:
            step_mask = masks[torch.arange(b, device=masks.device),
                              pred_op].to(img_x.dtype)
        per_op, _ = self._step_params(context, True, draw)
        if param_noise > 0.0:
            per_op = bank.add_param_noise(
                per_op, self.opcfg, param_noise,
                normal=draw("normal", per_op.shape))
        pred_img, _ = bank.execute_bank(img_x, pred_op, per_op,
                                        mask=step_mask)
        _, _, _, next_context = self.decoder(
            pred_op, carry, enc_out, enc_valid, self.vis_feat(pred_img))
        new_op_mask = op_mask * (1.0 - F.one_hot(
            pred_op, cfg.op_vocab_size).to(op_mask.dtype))
        return (pred_img, logprob, entropy_penalty, context, next_context,
                carry, pred_op, new_op_mask)


def get_entropy_penalty(logprobs):
    """log(n_cls) - H(p) per sample, (B, 1)."""
    entropy = -(torch.exp(logprobs) * logprobs).sum(dim=-1, keepdim=True)
    return float(np.log(float(logprobs.shape[-1]))) - entropy


def select_end_images(imgs, ops, end_id: int = END_OP_ID):
    """Each image at its first <END> step, else at the last step.
    imgs (B, S, 3, H, W); ops (B, S) -> (B, 3, H, W)."""
    s = ops.shape[1]
    is_end = ops == end_id
    first_end = torch.argmax(is_end.to(torch.int32), dim=1)
    idx = torch.where(is_end.any(dim=1), first_end,
                      torch.full_like(first_end, s - 1))
    return imgs[torch.arange(imgs.shape[0], device=imgs.device), idx]
