"""Decoder-only transformer LM (port of fedml_tpu/models/transformer.py).

Pre-LN causal decoder: token embedding plus a learned ``pos_embed``
[max_len, d] (initialised N(0, 0.02^2)), N blocks of LayerNorm ->
multi-head self-attention -> residual -> LayerNorm -> Dense -> GELU ->
Dense -> residual, a final LayerNorm and the vocabulary projection.
Tokens [B, T] in (T at most max_len, else ValueError), logits
[B, T, vocab] (or [B, vocab] with `last_only`) out.

flax's numbers kept: LayerNorm epsilon 1e-6; ``nn.gelu``'s tanh
approximation; the attention projections ``query``/``key``/``value`` with
kernels [d, H, d/H] and biases [H, d/H], ``out`` with kernel [H, d/H, d];
queries divided by sqrt(d/H) (rounded to the activations' dtype first);
masked logits set to the dtype's lowest value; the softmax in the
activations' dtype.  The attention is plain matmuls and a softmax, as in
the JAX package, where XLA compiles it (no hand kernel there either).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, Embed, LayerNorm, in_dtype


class MultiHeadDotProductAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        hd = d_model // n_heads
        self.query = Dense(d_model, (n_heads, hd))
        self.key = Dense(d_model, (n_heads, hd))
        self.value = Dense(d_model, (n_heads, hd))
        self.out = Dense((n_heads, hd), d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query(x), self.key(x), self.value(x)    # [B, T, H, hd]
        q = q / in_dtype(math.sqrt(q.shape[-1]), q.dtype)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = w.masked_fill(~mask, torch.finfo(w.dtype).min).softmax(dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


class _Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(d_model)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            d_model, n_heads)
        self.LayerNorm_1 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, d_ff)
        self.Dense_1 = Dense(d_ff, d_model)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = h + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(h), mask)
        f = F.gelu(self.Dense_0(self.LayerNorm_1(h)), approximate="tanh")
        return h + self.Dense_1(f)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size: int = 10004, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 2, d_ff: int = 512,
                 max_len: int = 512, last_only: bool = False):
        super().__init__()
        self.max_len = max_len
        self.last_only = last_only
        self.Embed_0 = Embed(vocab_size, d_model)
        self.pos_embed = nn.Parameter(torch.zeros(max_len, d_model))
        self.blocks = []
        for i in range(n_layers):
            self.add_module(f"_Block_{i}", _Block(d_model, n_heads, d_ff))
            self.blocks.append(f"_Block_{i}")
        self.LayerNorm_0 = LayerNorm(d_model)
        self.Dense_0 = Dense(d_model, vocab_size)

    def flax_init(self, name: str, shape, generator) -> torch.Tensor:
        return torch.randn(shape, generator=generator) * 0.02   # pos_embed

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        T = x.shape[-1]
        if T > self.max_len:
            raise ValueError(
                f"sequence length {T} exceeds max_len={self.max_len}; "
                f"construct TransformerLM with a larger max_len")
        h = self.Embed_0(x)
        h = h + self.pos_embed[:T].to(h.dtype)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        for name in self.blocks:
            h = getattr(self, name)(h, causal)
        h = self.LayerNorm_0(h)
        return self.Dense_0(h[:, -1] if self.last_only else h)
