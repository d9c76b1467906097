"""Flax-equivalent building blocks for the port's model zoo.

The zoo keeps flax's layout where a layer owns its weights: ``Dense``
stores its kernel as flax does ([in..., out...], contracted over the
leading axes), ``Embed`` its ``embedding`` [vocab, dim], the norms their
``scale`` and ``bias``.  Convolutions are ``torch.nn.Conv2d`` (OIHW
weights, which cuDNN reads in place).  The models name their submodules
as flax auto-names its own (``Conv_0``, ``BatchNorm_1``, ``Dense_0``,
``BasicBlock_3``, ...), so ``fedml_tpu_torch.convert`` maps every path
one to one and only transposes conv kernels (HWIO <-> OIHW).

Where flax's numbers differ from PyTorch's defaults:
* ``Dense`` promotes its input, kernel and bias to one dtype first (flax's
  ``promote_dtype``): a bf16 kernel meets an f32 input in f32, and
  ``dtype=torch.float32`` computes in f32 whatever the inputs are.
* ``LayerNorm`` (and ``normalize``, shared with BatchNorm) reduces in f32
  with the fast variance E[x^2] - E[x]^2, clamped at 0, and rounds its
  output once to the dtype of x, scale and bias; flax's LayerNorm epsilon
  is 1e-6.
* ``Dropout`` keeps a unit with probability 1 - rate and scales it by
  1/(1 - rate), drawing from the ``torch.Generator`` the caller passes
  (the trainer's per-client generator), where flax draws from its
  "dropout" rng.
* Initializers (``flax_init``): flax's lecun-normal (truncated normal,
  fan-in scaling) for kernels, N(0, 1/dim) for embeddings, zeros for
  biases, ones for scales.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

FLAX_LN_EPS = 1e-6          # flax nn.LayerNorm's default epsilon


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype) -> float:
    """`value` rounded to `dtype`: a Python scalar in a JAX op with a bf16
    array is weakly typed and becomes bf16 first (0.9 is 0.8984375
    there), where PyTorch would apply it in f32."""
    return torch.tensor(value, dtype=dtype).item()


def promote(*tensors, dtype=None):
    """flax ``promote_dtype``: every tensor (None stays None) in `dtype`,
    or in the tensors' common type."""
    if dtype is None:
        dtype = tensors[0].dtype
        for t in tensors[1:]:
            if t is not None:
                dtype = torch.promote_types(dtype, t.dtype)
    return [None if t is None else t.to(dtype) for t in tensors]


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: variance_scaling(1, "fan_in",
    "truncated_normal"), a unit truncated normal on [-2, 2] rescaled."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def dense_lecun_normal(in_shape, out_shape, generator) -> torch.Tensor:
    """lecun_normal for a flax-layout kernel in_shape + out_shape, drawn in
    PyTorch's [out, in] order and transposed: the same draws as an
    ``nn.Linear`` weight of that size (ResNet-18-GN's head keeps the
    weights it had when it was one)."""
    n_in, n_out = math.prod(in_shape), math.prod(out_shape)
    return lecun_normal((n_out, n_in), n_in, generator).t().reshape(
        *in_shape, *out_shape).contiguous()


def orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    """flax ``initializers.orthogonal()`` for a square kernel."""
    return nn.init.orthogonal_(torch.empty(shape), generator=generator)


def default_init(name: str, shape, generator: torch.Generator) -> torch.Tensor:
    """The initial value of a parameter or buffer by its name, for layers
    without a ``flax_init`` of their own: conv weights (OIHW, fan-in
    I*kh*kw) lecun-normal, biases and running means zero, scales and
    running variances one."""
    if name in ("bias", "mean"):
        return torch.zeros(shape)
    if name in ("scale", "var"):
        return torch.ones(shape)
    if name == "weight" and len(shape) == 4:
        return lecun_normal(shape, math.prod(shape[1:]), generator)
    raise ValueError(f"no flax initializer for a leaf named {name!r}")


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral``: y = x . kernel + bias, contracting
    the last len(in_features) axes of x with the leading axes of a kernel
    of shape in_features + out_features.  `kernel_init` is "lecun" or
    "orthogonal" (the LSTM's recurrent kernels)."""

    def __init__(self, in_features, out_features, use_bias: bool = True,
                 dtype=None, kernel_init: str = "lecun"):
        super().__init__()
        self.in_shape = tuple(in_features) if isinstance(
            in_features, Sequence) else (in_features,)
        self.out_shape = tuple(out_features) if isinstance(
            out_features, Sequence) else (out_features,)
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.kernel = nn.Parameter(torch.zeros(self.in_shape + self.out_shape))
        self.bias = (nn.Parameter(torch.zeros(self.out_shape)) if use_bias
                     else None)

    def flax_init(self, name: str, shape, generator) -> torch.Tensor:
        if name == "bias":
            return torch.zeros(shape)
        if self.kernel_init == "orthogonal":
            return orthogonal(shape, generator)
        return dense_lecun_normal(self.in_shape, self.out_shape, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = math.prod(self.in_shape)
        lead = x.shape[:x.dim() - len(self.in_shape)]
        x, kernel, bias = promote(x, self.kernel, self.bias, dtype=self.dtype)
        y = F.linear(x.reshape(*lead, n_in), kernel.reshape(n_in, -1).t(),
                     None if bias is None else bias.reshape(-1))
        return y.reshape(*lead, *self.out_shape)


class Embed(nn.Module):
    """flax ``Embed``: rows of ``embedding`` [vocab, dim] by integer id."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def flax_init(self, name: str, shape, generator) -> torch.Tensor:
        # variance_scaling(1, "fan_in", "normal", out_axis=0) on [vocab,
        # dim] has fan-in dim
        return torch.randn(shape, generator=generator) / math.sqrt(shape[1])

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.embedding)


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """flax ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias
    in the statistics' dtype (f32, or f64 for f64 x), rounded once to the
    dtype of x, scale and bias.  All five broadcast against x as given."""
    out = torch.promote_types(torch.promote_types(x.dtype, scale.dtype),
                              bias.dtype)
    return ((x - mean) * (torch.rsqrt(var + eps) * scale) + bias).to(out)


def stats_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype flax reduces statistics in: x's, at least f32."""
    return torch.promote_types(x.dtype, torch.float32)


def fast_var_mean(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """flax ``_compute_stats`` with use_fast_variance: (E[x^2] - E[x]^2
    clamped at 0, E[x]) over `dims` of a tensor in stats_dtype."""
    mean = xf.mean(dim=dims)
    var = torch.clamp(xf.square().mean(dim=dims) - mean.square(), min=0.0)
    return var, mean


class LayerNorm(nn.Module):
    """flax ``LayerNorm`` over the last axis (epsilon 1e-6)."""

    def __init__(self, features: int, eps: float = FLAX_LN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = fast_var_mean(x.to(stats_dtype(x)), -1)
        return normalize(x, mean[..., None], var[..., None], self.scale,
                         self.bias, self.eps)


class Dropout(nn.Module):
    """flax ``Dropout``: in training, each unit is kept with probability
    1 - rate and scaled by 1/(1 - rate), else zeroed; the draw comes from
    `rng`, a torch.Generator on x's device.  Identity in eval, and at
    rate 0 (which then needs no generator)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(bernoulli(keep, x.shape, x.device, rng), x / keep,
                           x.new_zeros(()))


def bernoulli(keep: float, shape, device, rng: torch.Generator | None):
    """A bool mask, True with probability `keep`, drawn from `rng`."""
    if rng is None:
        raise ValueError("dropout in training needs a torch.Generator "
                         "(the trainer passes each client its own)")
    return torch.rand(shape, generator=rng, device=device) < keep


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] images -> the channels_last NCHW view the convs read
    (no copy)."""
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax's ``x.reshape((N, -1))`` of an NHWC activation, from its NCHW
    view: the features in (h, w, c) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
