"""GroupNorm over trailing-channel activations, with hand-written CUDA
kernels for the forward and the backward (``csrc/groupnorm.cu``).

Replaces fedml_tpu/ops/groupnorm.py: ``_fwd_kernel`` (driven by
``_pallas_fwd``) and ``_bwd_kernel`` (driven by ``_pallas_dx``), exposed
there as the ``group_norm`` custom VJP.

Layout: x is [N, ..., C] with channels last and contiguous, as in the JAX
package; channel c belongs to group c // (C / G).  A ResNet in PyTorch's
``channels_last`` memory format hands its NCHW activations here as a
``permute(0, 2, 3, 1)`` view, which is exactly this layout, with no copy.

Bound on the H100 (3.35 TB/s): bytes.  The forward reads x once and writes
y once; the backward reads x and dy and writes dx.  The kernels keep each
(sample, group)'s statistics inside one block and fold the dgamma/dbeta
channel sums into the backward's first pass (design notes in the CUDA
source).

On a CPU tensor the wrappers run the plain PyTorch version below; on a CUDA
tensor they launch the kernel or raise.  ``gn_forward.launches`` and
``gn_backward.launches`` count kernel launches.
"""
from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.ops import build
from fedml_tpu_torch.ops.build import on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 512      # kThreads in csrc/groupnorm.cu


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def _grouped(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    N, C = x.shape[0], x.shape[-1]
    return x.float().reshape(N, -1, num_groups, C // num_groups)


def gn_forward_plain(x, gamma, beta, num_groups: int, eps: float):
    """(y, mean [N, G], rstd [N, G]); stats in f32, two-pass variance."""
    xf = _grouped(x, num_groups)
    mean = xf.mean(dim=(1, 3))
    var = ((xf - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None])
    y = xhat.reshape(x.shape) * gamma.float() + beta.float()
    return y.to(x.dtype), mean, rstd


def gn_backward_plain(x, dy, gamma, mean, rstd, num_groups: int):
    """(dx, dgamma, dbeta) from the saved statistics; dgamma/dbeta in f32."""
    C = x.shape[-1]
    Cg = C // num_groups
    xg = _grouped(x, num_groups)
    xhat = (xg - mean[:, None, :, None]) * rstd[:, None, :, None]
    dyg = _grouped(dy, num_groups)
    dxhat = dyg * gamma.float().reshape(1, 1, num_groups, Cg)
    m = xg.shape[1] * Cg
    s1 = dxhat.sum(dim=(1, 3))
    s2 = (dxhat * xhat).sum(dim=(1, 3))
    dx = (dxhat - (s1[:, None, :, None] + xhat * s2[:, None, :, None]) / m) \
        * rstd[:, None, :, None]
    dgamma = (dyg * xhat).sum(dim=(0, 1)).reshape(C)
    dbeta = dyg.sum(dim=(0, 1)).reshape(C)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, num_groups: int, *others: torch.Tensor) -> tuple:
    """Validate what the CUDA kernels take; returns (N, S, C)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"group_norm needs [N, ..., C], got shape {tuple(x.shape)}")
    for t in (x, *others):
        if not t.is_contiguous():
            raise ValueError("group_norm kernel needs contiguous channels-last "
                             f"tensors; got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError("group_norm kernel inputs differ in device, "
                             "dtype or shape")
    N, C = x.shape[0], x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels ({C}) not divisible by groups ({num_groups})")
    return N, x.numel() // (N * C), C


def _check_side(x: torch.Tensor, shape: tuple, **tensors) -> None:
    """The per-channel and per-group operands lie beside x on its card,
    with the shapes the kernels index them by."""
    for name, t in tensors.items():
        if t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"group_norm kernel: {name} must have shape "
                             f"{shape} on {x.device}, got {tuple(t.shape)} "
                             f"on {t.device}")


def _vector_width(x: torch.Tensor, num_groups: int, *tensors) -> int:
    Cg = x.shape[-1] // num_groups
    vec = build.vector_width(x.element_size(), Cg,
                             *(t.data_ptr() for t in (x, *tensors)))
    if Cg // vec > THREADS:
        raise ValueError(f"group of {Cg} channels is wider than the kernel's "
                         f"{THREADS} threads x {vec} elements")
    return vec


def gn_forward(x, gamma, beta, num_groups: int, eps: float):
    """(y, mean, rstd): the forward kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not on_card(x):
        return gn_forward_plain(x, gamma, beta, num_groups, eps)
    N, S, C = _check(x, num_groups)
    _check_side(x, (C,), gamma=gamma, beta=beta)
    g = gamma.detach().to(torch.float32).contiguous()
    b = beta.detach().to(torch.float32).contiguous()
    y = torch.empty_like(x)
    mean = torch.empty(N, num_groups, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    vec = _vector_width(x, num_groups, y)
    with torch.cuda.device(x.device):
        rc = build.library().fedml_gn_fwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), N, S, C, num_groups, float(eps),
            _DTYPES[x.dtype], vec, torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gn_fwd")
    gn_forward.launches += 1
    return y, mean, rstd


gn_forward.launches = 0


def gn_backward(x, dy, gamma, mean, rstd, num_groups: int):
    """(dx, dgamma, dbeta): the backward kernel on a CUDA tensor (dgamma and
    dbeta from its [N, C] partials, summed over N here), the plain version
    on a CPU tensor."""
    if not on_card(x):
        return gn_backward_plain(x, dy, gamma, mean, rstd, num_groups)
    N, S, C = _check(x, num_groups, dy)
    _check_side(x, (C,), gamma=gamma)
    _check_side(x, (N, num_groups), mean=mean, rstd=rstd)
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("group_norm kernel: mean and rstd must be float32")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    g = gamma.detach().to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    part = torch.empty(2, N, C, device=x.device, dtype=torch.float32)
    vec = _vector_width(x, num_groups, dy, dx)
    with torch.cuda.device(x.device):
        rc = build.library().fedml_gn_bwd(
            x.data_ptr(), dy.data_ptr(), g.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), N, S, C, num_groups, _DTYPES[x.dtype], vec,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gn_bwd")
    gn_backward.launches += 1
    dgamma, dbeta = part.sum(dim=1)
    return dx, dgamma, dbeta


gn_backward.launches = 0


# ---------------------------------------------------------------------------
# public op and module
# ---------------------------------------------------------------------------

class _GroupNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps):
        y, mean, rstd = gn_forward(x, gamma, beta, num_groups, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.num_groups = num_groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        # autograd may hand a non-contiguous gradient; the kernel reads the
        # same layout as x (a no-op when it already matches)
        dx, dgamma, dbeta = gn_backward(x, dy.contiguous(), gamma, mean,
                                        rstd, ctx.num_groups)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int = 8, eps: float = 1e-5) -> torch.Tensor:
    """y = GN(x) * gamma + beta over trailing-channel x (groups split C);
    the signature of fedml_tpu.ops.group_norm."""
    return _GroupNormFn.apply(x, gamma, beta, num_groups, eps)


class GroupNorm(nn.Module):
    """GroupNorm module over trailing-channel input, parameters ``scale``
    and ``bias`` of shape [C] (the names of flax ``nn.GroupNorm``)."""

    def __init__(self, num_channels: int, num_groups: int = 8,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.scale, self.bias, self.num_groups, self.eps)
