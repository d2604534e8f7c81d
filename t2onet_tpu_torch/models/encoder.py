"""Bi-directional multi-layer LSTM request encoder (counterpart of
`t2onet_tpu.models.encoder`). `nn.LSTM` over a packed sequence gives the
same semantics as the JAX package's two masked scans per layer: the
forward final state is taken at each request's true last token, the
backward pass starts at its true end, and outputs at padding are zero.

With `fix_embedding` the word rows (all but the first `n_spec_token`,
the GloVe rows when the actor was built with them) get no gradient, as
the JAX package's `stop_gradient` gives: only the special tokens' rows
train.

Packing reads nothing back from the card when the caller knows the
requests' lengths on the host (the loader ships them beside `x`,
`data.loader.device_put_batch`; serving counts them as it stacks): the
order that `pack_padded_sequence(enforce_sorted=False)` takes, torch's
descending sort of the lengths, and its inverse are computed on the
host and sent in one non-blocking copy, and the outputs are put back in
the requests' order on the card. torch's two helpers would each stall
the stream: a blocking upload of the order, and a read of it back."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F
from torch.nn.utils.rnn import PackedSequence

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
        # calls, and of them those packed from host lengths (no device read)
        self.stats = {"calls": 0, "host_packed": 0}

    def forward(self, tokens, host_lengths=None):
        """tokens (B, L) int, zero-padded after the request.

        host_lengths: the requests' token counts (B,) as a CPU tensor,
        which packing needs on the host; without them they are counted on
        the device and read back, one device->host sync. Packing makes no
        other sync.

        Returns outputs (B, L, 2H) zero at padding; (h, c) each
        (n_layers, B, 2H) with the two directions concatenated; and the
        valid mask (B, L) float."""
        b, l = tokens.shape
        lengths = (tokens != self.pad_id).sum(dim=1)
        valid = (torch.arange(l, device=tokens.device)[None, :]
                 < lengths[:, None]).to(torch.float32)
        self.stats["calls"] += 1
        if host_lengths is None:
            host_lengths = lengths.cpu()
        else:
            self.stats["host_packed"] += 1
        sorted_lengths, order, inverse = _packing_order(host_lengths,
                                                        tokens.device)
        data, batch_sizes = torch._VF._pack_padded_sequence(
            self.embed(tokens).index_select(0, order), sorted_lengths, True)
        out, (h, c) = self.rnn(PackedSequence(data, batch_sizes, order,
                                              inverse))
        out, _ = torch._VF._pad_packed_sequence(out.data, batch_sizes, True,
                                                0.0, l)
        out = out.index_select(0, inverse)

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


def _packing_order(host_lengths, device):
    """(lengths sorted, order, inverse): `pack_padded_sequence`'s own
    descending sort of the CPU lengths, so the packed batch is the one it
    builds, and the order's inverse, both on `device` through one
    non-blocking copy (from pinned memory to a card) on the current
    stream."""
    lengths, order = torch.sort(host_lengths.to(torch.int64),
                                descending=True)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel())
    both = torch.stack([order, inverse])
    if device.type == "cuda":
        both = both.pin_memory()
    both = both.to(device, non_blocking=True)
    return lengths, both[0], both[1]
