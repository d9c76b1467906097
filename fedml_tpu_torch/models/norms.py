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
rounded to each input's dtype.  The channel axis is axis 1 ([N, C] or
[N, C, H, W]).

``sync_batch_norm(sync=True)`` is the cross-replica BatchNorm (the
reference's SynchronizedBatchNorm2d, flax's ``axis_name``): its training
forward folds [sum x, sum x^2, count] per channel over the ranks of its
mesh axis (``utils/axes.py``: the axis a mesh engine binds for the round;
unbound, it raises), in f32, left in mesh order, and normalizes by
mean = sum x / n and var = max(sum x^2 / n - mean^2, 0); its backward
folds [sum dy, sum dy * xhat] the same way, so dx is the unsplit batch's,
while the scale and bias gradients stay this rank's share (the trainer's
gradient fold adds them up).  flax instead averages each replica's
[E[x], E[x^2]] (``lax.pmean``), the same statistics for equal shards up
to rounding.  The default axis is "clients", as in the JAX package:
under a client mesh the statistics average over the ranks' clients.  The
parameter tree is plain BatchNorm's, so a model trained on one device
loads onto a mesh unchanged (and ``convert.py`` maps it as it is).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fedml_tpu_torch.utils import axes as mesh_axes
from fedml_tpu_torch.models.layers import (fast_var_mean, in_dtype, normalize,
                                           stats_dtype)

BATCH_AXIS = "clients"   # the JAX package's default axis of sync_batch_norm


def _reduced(x: torch.Tensor) -> tuple:
    """Every axis but the channel axis (1)."""
    return (0,) + tuple(range(2, x.dim()))


def _per_channel(t: torch.Tensor, ndim: int = 4) -> torch.Tensor:
    return t.view((1, -1) + (1,) * (ndim - 2))


def _fold_channels(env, sync_axes: tuple, parts: list) -> list:
    """Concatenate per-channel f32 vectors, fold them over `sync_axes` on
    the host and split them again, on the first part's device."""
    sizes = [p.numel() for p in parts]
    host = torch.cat([p.float().reshape(-1) for p in parts]).to("cpu")
    out = torch.from_numpy(env.fold(host.numpy(), sync_axes)).to(
        parts[0].device)
    return list(torch.split(out, sizes))


class _BatchNormTrain(torch.autograd.Function):
    """y = (x - mu) * (rsqrt(var + eps) * scale) + bias with the batch's
    f32 statistics; returns (y, mu, var), the statistics without
    gradient."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, env=None, sync_axes=None):
        """`env` and `sync_axes` (the synchronized form) fold the
        statistics and the backward's sums over the ranks of those axes."""
        nd = x.dim()
        xf = x.to(stats_dtype(x))
        m = x.numel() // x.shape[1]
        if env is None:
            var, mean = fast_var_mean(xf, _reduced(x))
        else:
            s1, s2, n = _fold_channels(env, sync_axes, [
                xf.sum(dim=_reduced(x)), xf.square().sum(dim=_reduced(x)),
                torch.full((1,), float(m), device=x.device)])
            m = float(n.item())
            mean = (s1 / m).to(xf.dtype)
            var = torch.clamp(s2.to(xf.dtype) / m - mean.square(), min=0.0)
        rstd = torch.rsqrt(var + eps)
        # normalize()'s arithmetic, with rstd kept for the backward
        y = ((x - _per_channel(mean, nd)) * _per_channel(rstd * scale, nd)
             + _per_channel(bias, nd)).to(torch.promote_types(
                 torch.promote_types(x.dtype, scale.dtype), bias.dtype))
        ctx.save_for_backward(x, mean, rstd, scale)
        ctx.bias_dtype = bias.dtype
        ctx.count = m
        ctx.env, ctx.sync_axes = env, sync_axes
        ctx.mark_non_differentiable(mean, var)
        ctx.set_materialize_grads(False)      # no zero grads for mean, var
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        if dy is None:
            return None, None, None, None, None, None
        x, mean, rstd, scale = ctx.saved_tensors
        nd, m, dt = x.dim(), ctx.count, mean.dtype
        xhat = (x.to(dt) - _per_channel(mean, nd)) * _per_channel(rstd, nd)
        dyf = dy.to(dt)
        dbias = dyf.sum(dim=_reduced(x))
        dscale = (dyf * xhat).sum(dim=_reduced(x))
        g_bias, g_scale = dbias, dscale
        if ctx.env is not None:        # dx of the unsplit batch
            g_bias, g_scale = (t.to(dt) for t in _fold_channels(
                ctx.env, ctx.sync_axes, [dbias, dscale]))
        k = _per_channel(scale.to(dt) * rstd / m, nd)
        dx = k * (m * dyf - _per_channel(g_bias, nd)
                  - xhat * _per_channel(g_scale, nd))
        return (dx.to(x.dtype), dscale.to(scale.dtype),
                dbias.to(ctx.bias_dtype), None, None, None)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, axis_name)`` on [N, C, ...]
    activations.  With `axis_name` the training statistics fold over that
    mesh axis (the module docstring); without it they are this batch's,
    unless the bound mesh names axes for every BatchNorm
    (``utils/axes.py::bound(batch_norm_axes=...)``)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, axis_name: Optional[str] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _sync(self) -> tuple:
        """(bound environment, axes) the statistics fold over, or (None,
        None) for this batch's own."""
        if self.axis_name is not None:
            axes = (self.axis_name,)
            return mesh_axes.lookup(axes), axes
        env = mesh_axes.current()
        if env is not None and env.batch_norm_axes:
            return env, env.check(env.batch_norm_axes)
        return None, None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        nd = x.dim()
        if not train:
            return normalize(x, _per_channel(self.mean, nd),
                             _per_channel(self.var, nd),
                             _per_channel(self.scale, nd),
                             _per_channel(self.bias, nd), self.eps)
        env, sync_axes = self._sync()
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.eps, env, sync_axes)
        with torch.no_grad():
            # ra = momentum * ra (in ra's dtype) + (1 - momentum) * stat,
            # the sum in f32 and rounded once to ra's dtype
            for ra, stat in ((self.mean, mean), (self.var, var)):
                ra.mul_(in_dtype(self.momentum, ra.dtype)).add_(
                    stat, alpha=1 - self.momentum)
        return y


def sync_batch_norm(features: int, sync: bool = True,
                    axis_name: str = BATCH_AXIS, momentum: float = 0.9,
                    epsilon: float = 1e-5) -> BatchNorm:
    """The JAX package's ``sync_batch_norm``: `sync=True` folds the
    training statistics over the mesh axis `axis_name` (a mesh engine must
    bind it: training outside one raises "unbound axis name"); `sync=False`
    is the plain BatchNorm.  Both have one parameter tree."""
    return BatchNorm(features, momentum, epsilon,
                     axis_name=axis_name if sync else None)
