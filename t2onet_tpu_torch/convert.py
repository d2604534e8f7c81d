"""Weights bridge: a JAX `t2onet_tpu` actor's variables -> a port `Actor`
(and a JAX `InpaintNet`'s -> the port's, `load_jax_inpaint`).

The inverse of `t2onet_tpu/convert/torch_checkpoint.py:convert_state_dict`
(which reads the reference checkpoint's names, and so the port's):

- Dense kernels (in, out) and LSTM w_ih / w_hh (in, 4H) are transposed;
- conv kernels go from HWIO to OIHW;
- the one LSTM bias b becomes bias_ih = b, bias_hh = 0;
- the stacked per-op heads are unstacked and fc2 cut to the op's
  parameter count, or in the discrete mode to at least `discrete_step`
  columns (the bin logits);
- flax BatchNorm scale / bias / mean / var become torch weight / bias /
  running_mean / running_var.

Takes plain numpy arrays, so nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from t2onet_tpu_torch.models.actor import fc2_widths
from t2onet_tpu_torch.models.resnet import blocks_per_stage
from t2onet_tpu_torch.ops.operators import OP_NAMES


def _t(x):
    return np.ascontiguousarray(np.asarray(x, np.float32).T)


def _oihw(x):
    """HWIO -> OIHW."""
    x = np.asarray(x, np.float32)
    return np.ascontiguousarray(x.transpose(3, 2, 0, 1))


def _bn(sd, prefix, p, s):
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]
    sd[f"{prefix}.running_mean"] = s["mean"]
    sd[f"{prefix}.running_var"] = s["var"]


def _lstm(sd, prefix, suffix, p):
    sd[f"{prefix}.weight_ih_{suffix}"] = _t(p["w_ih"])
    sd[f"{prefix}.weight_hh_{suffix}"] = _t(p["w_hh"])
    sd[f"{prefix}.bias_ih_{suffix}"] = np.asarray(p["b"], np.float32)
    sd[f"{prefix}.bias_hh_{suffix}"] = np.zeros_like(
        np.asarray(p["b"], np.float32))


def jax_variables_to_state_dict(params: Dict, batch_stats: Dict,
                                n_layers: int = 2,
                                stage_blocks: Sequence[int] = (2, 2, 2, 2),
                                discrete_step: int = 0
                                ) -> Dict[str, np.ndarray]:
    """JAX actor (params, batch_stats) pytrees -> port state_dict arrays
    (the BatchNorm `num_batches_tracked` counters excepted). The ResNet's
    blocks are read as BasicBlocks or as Bottlenecks by their flax names
    (`BasicBlock_n`: Conv_0..1, BatchNorm_0..1, shortcut Conv_2 +
    BatchNorm_2; `Bottleneck_n`: Conv_0..2, BatchNorm_0..2, shortcut
    Conv_3 alone). `discrete_step` > 0 keeps that many of fc2's columns
    (`fc2_widths`)."""
    sd: Dict[str, np.ndarray] = {}

    enc = params["lang_encoder"]
    sd["lang_encoder.embedding.weight"] = enc["embedding"]
    for k in range(n_layers):
        _lstm(sd, "lang_encoder.rnn", f"l{k}", enc[f"lstm_l{k}_fwd"])
        _lstm(sd, "lang_encoder.rnn", f"l{k}_reverse", enc[f"lstm_l{k}_bwd"])

    dec = params["decoder"]
    sd["decoder.embedding.weight"] = dec["embedding"]
    for k in range(n_layers):
        _lstm(sd, "decoder.rnn", f"l{k}", dec[f"lstm_l{k}"])
    names = {"vis_linear": "vis_linear", "out_linear": "out_linear",
             "attn_out": "attention.linear_out"}
    for jax_name, port_name in names.items():
        if jax_name in dec:
            sd[f"decoder.{port_name}.weight"] = _t(dec[jax_name]["kernel"])
            sd[f"decoder.{port_name}.bias"] = dec[jax_name]["bias"]

    vp, vs = params["vis_encoder"], batch_stats["vis_encoder"]
    sd["vis_encoder.conv1.weight"] = _oihw(vp["Conv_0"]["kernel"])
    _bn(sd, "vis_encoder.bn1", vp["BatchNorm_0"], vs["BatchNorm_0"])
    sd["vis_encoder.fc.weight"] = _t(vp["Dense_0"]["kernel"])
    sd["vis_encoder.fc.bias"] = vp["Dense_0"]["bias"]
    places = [(s, i) for s, n in enumerate(stage_blocks, 1)
              for i in range(n)]
    bottleneck = "Bottleneck_0" in vp
    kind = "Bottleneck" if bottleneck else "BasicBlock"
    n_conv = 3 if bottleneck else 2
    for n, (stage, i) in enumerate(places):
        dst = f"vis_encoder.layer{stage}.{i}"
        bp, bs = vp[f"{kind}_{n}"], vs[f"{kind}_{n}"]
        for c in range(n_conv):
            sd[f"{dst}.conv{c + 1}.weight"] = _oihw(bp[f"Conv_{c}"]["kernel"])
            _bn(sd, f"{dst}.bn{c + 1}", bp[f"BatchNorm_{c}"],
                bs[f"BatchNorm_{c}"])
        if f"Conv_{n_conv}" in bp:
            sd[f"{dst}.shortcut.0.weight"] = _oihw(
                bp[f"Conv_{n_conv}"]["kernel"])
            if not bottleneck:
                _bn(sd, f"{dst}.shortcut.1", bp["BatchNorm_2"],
                    bs["BatchNorm_2"])

    _bn(sd, "bn1", params["bn1"], batch_stats["bn1"])

    heads = params["heads"]
    for i, (name, k) in enumerate(zip(OP_NAMES, fc2_widths(discrete_step))):
        pre = f"executor.{name}_op"
        sd[f"{pre}.fc1.weight"] = _t(heads["w1"][i])
        sd[f"{pre}.fc1.bias"] = heads["b1"][i]
        sd[f"{pre}.fc2.weight"] = _t(np.asarray(heads["w2"][i])[:, :k])
        sd[f"{pre}.fc2.bias"] = np.asarray(heads["b2"][i])[:k]
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@torch.no_grad()
def load_jax_variables(actor, params: Dict, batch_stats: Dict) -> None:
    """Fill a port `Actor` in place from a JAX actor's variables (numpy
    arrays). Every tensor of the actor must be covered, and every
    converted array must fit its tensor's shape."""
    cfg = actor.cfg
    sd = jax_variables_to_state_dict(
        params, batch_stats, cfg.n_layers,
        blocks_per_stage(cfg.resnet_depth),
        cfg.discrete_step if cfg.discrete_param else 0)
    own = actor.state_dict()
    missing = [k for k in own
               if k not in sd and not k.endswith("num_batches_tracked")]
    unknown = [k for k in sd if k not in own]
    if missing or unknown:
        raise KeyError(f"weights do not match the actor: missing "
                       f"{missing[:5]}, unknown {unknown[:5]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != v.shape:
            raise ValueError(f"{k}: actor has {tuple(own[k].shape)}, "
                             f"weights have {v.shape}")
        own[k].copy_(torch.from_numpy(v))


def inpaint_variables_to_state_dict(params: Dict) -> Dict[str, np.ndarray]:
    """A JAX `InpaintNet`'s params ({"params": ...} or its inside) -> the
    port's `models.inpaint.InpaintNet` state_dict arrays: GatedConv_i ->
    gated.{i}.conv, Conv_0 -> out, HWIO kernels to OIHW. The feature half
    of each gated conv's outputs comes first in both."""
    params = params.get("params", params)
    sd = {}
    i = 0
    while f"GatedConv_{i}" in params:
        conv = params[f"GatedConv_{i}"]["Conv_0"]
        sd[f"gated.{i}.conv.weight"] = _oihw(conv["kernel"])
        sd[f"gated.{i}.conv.bias"] = conv["bias"]
        i += 1
    sd["out.weight"] = _oihw(params["Conv_0"]["kernel"])
    sd["out.bias"] = params["Conv_0"]["bias"]
    return {k: np.array(v, np.float32) for k, v in sd.items()}


@torch.no_grad()
def load_jax_inpaint(net, params: Dict) -> None:
    """Fill a port `InpaintNet` in place from a JAX InpaintNet's params
    (numpy arrays); every tensor must be covered, shapes must fit."""
    sd = inpaint_variables_to_state_dict(params)
    own = net.state_dict()
    if set(sd) != set(own):
        raise KeyError(f"weights do not match the net: missing "
                       f"{sorted(set(own) - set(sd))[:5]}, unknown "
                       f"{sorted(set(sd) - set(own))[:5]}")
    for k, v in sd.items():
        if tuple(own[k].shape) != v.shape:
            raise ValueError(f"{k}: net has {tuple(own[k].shape)}, "
                             f"weights have {v.shape}")
        own[k].copy_(torch.from_numpy(v))
