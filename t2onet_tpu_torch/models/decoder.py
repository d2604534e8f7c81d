"""Action decoder step: LSTM + dot-product attention + op head
(counterpart of `t2onet_tpu.models.decoder`). Module names are the
reference checkpoint's: `embedding`, `rnn`, `vis_linear`, `out_linear`
and `attention.linear_out`."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from t2onet_tpu_torch.models.common import freeze_second_lstm_bias, lstm_step


class Attention(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.linear_out = nn.Linear(2 * hidden_size, hidden_size)


class DecoderStep(nn.Module):
    def __init__(self, op_vocab_size: int = 11, word_vec_dim: int = 300,
                 hidden_size: int = 512, n_layers: int = 2,
                 use_attention: bool = True, vis_dim: int = 512):
        super().__init__()
        self.n_layers = n_layers
        self.embedding = nn.Embedding(op_vocab_size, word_vec_dim)
        self.rnn = nn.LSTM(word_vec_dim + hidden_size, hidden_size,
                           num_layers=n_layers, batch_first=True)
        freeze_second_lstm_bias(self.rnn)
        self.vis_linear = nn.Linear(vis_dim, hidden_size)
        self.out_linear = nn.Linear(hidden_size, op_vocab_size)
        self.attention = Attention(hidden_size) if use_attention else None

    def init_carry(self, encoder_hidden):
        """Per-layer (h, c) from the encoder's final (h, c), each
        (n_layers, B, hidden)."""
        h, c = encoder_hidden
        return tuple((h[i], c[i]) for i in range(self.n_layers))

    def forward(self, op_ids, carry, encoder_outputs, encoder_valid,
                img_feat):
        """One decode step.

        :param op_ids: (B,) previous op token.
        :param carry: per-layer (h, c), each (B, hidden).
        :param encoder_outputs: (B, L, hidden); encoder_valid (B, L).
        :param img_feat: (B, vis_dim) feature of the current image.
        :return: (op_logprob (B, n_cls), new_carry, attn (B, L) or None,
                  context (B, hidden))
        """
        vis = F.relu(self.vis_linear(img_feat))
        x = torch.cat([self.embedding(op_ids), vis], dim=-1)
        new_carry = []
        for layer in range(self.n_layers):
            h, c = lstm_step(
                x, carry[layer],
                getattr(self.rnn, f"weight_ih_l{layer}"),
                getattr(self.rnn, f"weight_hh_l{layer}"),
                getattr(self.rnn, f"bias_ih_l{layer}"),
                getattr(self.rnn, f"bias_hh_l{layer}"))
            new_carry.append((h, c))
            x = h
        context = x

        attn = None
        if self.attention is not None:
            scores = torch.einsum("bh,blh->bl", context, encoder_outputs)
            scores = torch.where(encoder_valid > 0, scores,
                                 torch.full_like(scores, -1e9))
            attn = torch.softmax(scores, dim=-1)
            mix = torch.einsum("bl,blh->bh", attn, encoder_outputs)
            context = torch.tanh(self.attention.linear_out(
                torch.cat([mix, context], dim=-1)))

        logprob = F.log_softmax(self.out_linear(context), dim=-1)
        return logprob, tuple(new_carry), attn, context
