"""Character and word LSTMs (port of fedml_tpu/models/rnn.py; reference
fedml_api/model/nlp/rnn.py).

RNNOriginalFedAvg: embed(vocab 90 -> 8) + 2 x LSTM(256) + dense, the
Shakespeare next-character model (`last_only`: one logit vector from the
final position, the LEAF mode).  RNNStackOverflow: embed(10,004 -> 96) +
LSTM(670) + dense(96) + dense(vocab), the StackOverflow next-word model.
Tokens [B, T] in, logits [B, T, vocab] (or [B, vocab]) out.

``OptimizedLSTMCell`` holds flax's parameters as flax names them: input
kernels ``ii/if/ig/io`` [in, H] without bias, hidden kernels
``hi/hf/hg/ho`` [H, H] with bias [H]; the carry (c, h) starts at zeros.
It runs the whole sequence through ``torch.lstm`` (cuDNN's LSTM on the
card) with PyTorch's gate order i, f, g, o, an input bias of zero and
flax's bias as the hidden bias.  The weights sit inside the trainer's flat
vector, where cuDNN cannot use them in place (its weight space must begin
its own storage), so each call packs them once into a fresh buffer in
cuDNN's layout [w_ih | w_hh | b_ih | b_hh] and hands cuDNN views of it:
cuDNN then copies nothing itself.  The LSTM computes in f32 whatever the
weights' dtype, as flax's cell does: its zero carry is f32, and f32 wins
the promotion.
"""
from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.layers import Dense, Embed

_GATES = "ifgo"


class OptimizedLSTMCell(nn.Module):
    def __init__(self, in_features: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        for g in _GATES:
            self.add_module("i" + g, Dense(in_features, hidden_size,
                                           use_bias=False))
            self.add_module("h" + g, Dense(hidden_size, hidden_size,
                                           kernel_init="orthogonal"))

    def cudnn_weights(self, dtype) -> list:
        """[w_ih, w_hh, b_ih, b_hh] as views of one fresh buffer."""
        gate = lambda k: [getattr(self, k + g) for g in _GATES]
        w_ih = torch.cat([m.kernel.t() for m in gate("i")])      # [4H, in]
        w_hh = torch.cat([m.kernel.t() for m in gate("h")])      # [4H, H]
        b_hh = torch.cat([m.bias for m in gate("h")])
        parts = (w_ih, w_hh, torch.zeros_like(b_hh), b_hh)
        buf = torch.cat([p.reshape(-1) for p in parts]).to(dtype)
        return [v.view(p.shape) for v, p in
                zip(torch.split(buf, [p.numel() for p in parts]), parts)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, in] -> [B, T, H], from a zero carry."""
        dtype = torch.promote_types(x.dtype, torch.float32)
        zeros = x.new_zeros((1, x.shape[0], self.hidden_size), dtype=dtype)
        out, _, _ = torch.lstm(x.to(dtype), (zeros, zeros),
                               self.cudnn_weights(dtype), True, 1, 0.0,
                               torch.is_grad_enabled(), False, True)
        return out


class RNNOriginalFedAvg(nn.Module):
    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256, last_only: bool = False):
        super().__init__()
        self.last_only = last_only
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim, hidden_size)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(hidden_size, hidden_size)
        self.Dense_0 = Dense(hidden_size, vocab_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        h = self.OptimizedLSTMCell_0(self.Embed_0(x))
        h = self.OptimizedLSTMCell_1(h)
        return self.Dense_0(h[:, -1] if self.last_only else h)


class RNNStackOverflow(nn.Module):
    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96,
                 hidden_size: int = 670):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embedding_dim, hidden_size)
        self.Dense_0 = Dense(hidden_size, embedding_dim)
        self.Dense_1 = Dense(embedding_dim, vocab_size)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        h = self.OptimizedLSTMCell_0(self.Embed_0(x))
        return self.Dense_1(self.Dense_0(h))
