"""Bi-directional multi-layer LSTM request encoder (counterpart of
`t2onet_tpu.models.encoder`). `nn.LSTM` over a packed sequence gives the
same semantics as the JAX package's two masked scans per layer: the
forward final state is taken at each request's true last token, the
backward pass starts at its true end, and outputs at padding are zero.

With `fix_embedding` the word rows (all but the first `n_spec_token`,
the GloVe rows when the actor was built with them) get no gradient, as
the JAX package's `stop_gradient` gives: only the special tokens' rows
train."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from t2onet_tpu_torch.models.common import freeze_second_lstm_bias


class RNNEncoder(nn.Module):
    def __init__(self, vocab_size: int, word_vec_dim: int = 300,
                 hidden_size: int = 256, n_layers: int = 2, pad_id: int = 0,
                 n_spec_token: int = 4, fix_embedding: bool = False):
        super().__init__()
        self.pad_id = pad_id
        self.n_layers = n_layers
        self.n_spec_token = n_spec_token
        self.fix_embedding = fix_embedding
        self.embedding = nn.Embedding(vocab_size, word_vec_dim)
        self.rnn = nn.LSTM(word_vec_dim, hidden_size, num_layers=n_layers,
                           batch_first=True, bidirectional=True)
        freeze_second_lstm_bias(self.rnn)

    def forward(self, tokens, host_lengths=None):
        """tokens (B, L) int, zero-padded after the request.

        host_lengths: the requests' token counts (B,) as a CPU tensor,
        which packing needs on the host; without them they are counted on
        the device and read back, one device->host sync.

        Returns outputs (B, L, 2H) zero at padding; (h, c) each
        (n_layers, B, 2H) with the two directions concatenated; and the
        valid mask (B, L) float."""
        b, l = tokens.shape
        lengths = (tokens != self.pad_id).sum(dim=1)
        valid = (torch.arange(l, device=tokens.device)[None, :]
                 < lengths[:, None]).to(torch.float32)
        if host_lengths is None:
            host_lengths = lengths.cpu()
        packed = pack_padded_sequence(self.embed(tokens), host_lengths,
                                      batch_first=True, enforce_sorted=False)
        out, (h, c) = self.rnn(packed)
        out, _ = pad_packed_sequence(out, batch_first=True, total_length=l)

        def cat_directions(s):
            s = s.view(self.n_layers, 2, b, -1)
            return torch.cat([s[:, 0], s[:, 1]], dim=-1)

        return out, (cat_directions(h), cat_directions(c)), valid

    def embed(self, tokens):
        w = self.embedding.weight
        if self.fix_embedding:
            spec = torch.arange(w.shape[0], device=w.device) < self.n_spec_token
            w = torch.where(spec[:, None], w, w.detach())
        return F.embedding(tokens, w)
