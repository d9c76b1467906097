"""BatchNorm as flax computes it (port of fedml_tpu/models/norms.py).

``BatchNorm`` is flax's ``nn.BatchNorm`` over the channel axis of an NCHW
activation, and not PyTorch's:

* momentum is the share KEPT (flax 0.9 is torch's 0.1):
  ra = momentum * ra + (1 - momentum) * batch_stat;
* the running variance takes the BIASED batch variance (torch's takes
  the unbiased one);
* the statistics are reduced in f32 (f64 for f64 x) with the fast
  variance E[x^2] - E[x]^2 (clamped at 0); the output is rounded once to
  the dtype of x, scale and bias;
* the running statistics are buffers ``mean`` and ``var`` (flax's
  ``batch_stats``) that the training forward overwrites in place, in their
  own dtype, from an f32 update; the momentum is first rounded to that
  dtype, as JAX's weakly typed 0.9 is.  Every sample of the batch enters
  the statistics, padding rows included (flax's BatchNorm sees the whole
  batch).

``forward(x, train)`` uses the batch statistics and updates the buffers
when `train` is true, and the running statistics otherwise.  The
training forward and its backward are one autograd function with the
textbook BatchNorm gradient, computed in the statistics' dtype and
rounded to each input's dtype.

``sync_batch_norm(sync=True)``, the cross-replica statistics, needs
torch.distributed and arrives with slice 6 of the port; ``sync=False`` is
the plain BatchNorm.
"""
from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.layers import (fast_var_mean, in_dtype, normalize,
                                           stats_dtype)

_CHANNELS = (0, 2, 3)          # the reduced axes of an NCHW activation


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


class _BatchNormTrain(torch.autograd.Function):
    """y = (x - mu) * (rsqrt(var + eps) * scale) + bias with the batch's
    f32 statistics; returns (y, mu, var), the statistics without
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        var, mean = fast_var_mean(x.to(stats_dtype(x)), _CHANNELS)
        rstd = torch.rsqrt(var + eps)
        # normalize()'s arithmetic, with rstd kept for the backward
        y = ((x - _per_channel(mean)) * _per_channel(rstd * scale)
             + _per_channel(bias)).to(torch.promote_types(
                 torch.promote_types(x.dtype, scale.dtype), bias.dtype))
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.bias_dtype = bias.dtype
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)      # no zero grads for mean, var
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        if dy is None:
            return None, None, None, None
        x, mean, rstd, scale = ctx.saved_tensors
        m, dt = x.numel() // x.shape[1], mean.dtype
        xhat = (x.to(dt) - _per_channel(mean)) * _per_channel(rstd)
        dyf = dy.to(dt)
        dbias = dyf.sum(dim=_CHANNELS)
        dscale = (dyf * xhat).sum(dim=_CHANNELS)
        k = _per_channel(scale.to(dt) * rstd / m)
        dx = k * (m * dyf - _per_channel(dbias) - xhat * _per_channel(dscale))
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` on NCHW activations."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return normalize(x, _per_channel(self.mean), _per_channel(self.var),
                             _per_channel(self.scale), _per_channel(self.bias),
                             self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias, self.eps)
        with torch.no_grad():
            # ra = momentum * ra (in ra's dtype) + (1 - momentum) * stat,
            # the sum in f32 and rounded once to ra's dtype
            for ra, stat in ((self.mean, mean), (self.var, var)):
                ra.mul_(in_dtype(self.momentum, ra.dtype)).add_(
                    stat, alpha=1 - self.momentum)
        return y


def sync_batch_norm(features: int, sync: bool = True, momentum: float = 0.9,
                    epsilon: float = 1e-5) -> BatchNorm:
    """The JAX package's ``sync_batch_norm``: `sync=True` (statistics
    reduced across replicas) is slice 6 of the port and raises; the plain
    BatchNorm otherwise (which takes `train` per call)."""
    if sync:
        raise NotImplementedError(
            "sync_batch_norm(sync=True), cross-replica BatchNorm statistics, "
            "needs torch.distributed: slice 6 of the port")
    return BatchNorm(features, momentum, epsilon)
