"""GroupNorm over trailing-channel activations, with hand-written CUDA
kernels for the forward and the backward (``csrc/groupnorm.cu``).

Replaces fedml_tpu/ops/groupnorm.py: ``_fwd_kernel`` (driven by
``_pallas_fwd``) and ``_bwd_kernel`` (driven by ``_pallas_dx``), exposed
there as the ``group_norm`` custom VJP, and the dgamma/dbeta reduction
beside them (``_channel_grads``).

Layout: x is [N, ..., C] with channels last and contiguous, as in the JAX
package; channel c belongs to group c // (C / G).  A ResNet in PyTorch's
``channels_last`` memory format hands its NCHW activations here as a
``permute(0, 2, 3, 1)`` view, which is exactly this layout, with no copy.
gamma and beta may be float32 or bfloat16 (both the same), in any pairing
with x; dgamma and dbeta come back in gamma's dtype, rounded once from
their f32 sums, on both paths.

Bound on the H100 (3.35 TB/s): bytes.  The forward reads x once and writes
y once; the backward reads x and dy and writes dx, and finishes dgamma and
dbeta in the same launch.  Each (sample, group) is one thread-block
cluster of up to 8 blocks that holds the group in shared memory;
``launch_plan`` sizes it (design notes in the CUDA source).

On a CPU tensor the wrappers run the plain PyTorch version below; on a CUDA
tensor they launch the kernel or raise.  ``gn_forward.launches`` and
``gn_backward.launches`` count kernel launches.

The op can be differentiated twice (FedNAS's exact second-order
architect differentiates through a training step).  The backward is an
autograd function of its own, ``_GroupNormBackwardFn``: its forward runs
the backward kernel (the plain version, without a graph, on the CPU) and
its backward is the analytic double backward, written in torch ops from
the saved tensors: the gradients of (dx, dgamma, dbeta) with respect to
x (through the mean and rstd as well), dy and gamma.  This is the one
place on a path where plain ops stand in a kernel's backward.  The JAX
package has no Pallas kernel for it either: its Pallas op is a
``custom_vjp``, which JAX cannot differentiate twice, and its FedNAS runs
flax's GroupNorm under XLA.  Without ``create_graph`` the backward calls
the kernel wrapper directly, as it always did.
"""
from __future__ import annotations

import math
import threading
from typing import NamedTuple

import torch
from torch import nn

from fedml_tpu_torch.ops import build
from fedml_tpu_torch.ops.build import on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_THREADS = 512       # kMaxThreads in csrc/groupnorm.cu
MAX_CLUSTER = 8         # the portable cluster size, kMaxCluster
SMEM_BYTES = 232_448 - 1_024   # a block's 227 KB, less room for static smem
MIN_BLOCKS = 132               # a block for each of the H100's SMs at least
BLOCK_BYTES = 16 * 1024        # bytes of x a block aims to hold
BLOCK_THREADS = 128            # threads a block aims for


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in f32, or in f64 for f64 x."""
    return torch.promote_types(x.dtype, torch.float32)


def _grouped(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    N, C = x.shape[0], x.shape[-1]
    return x.to(_compute_dtype(x)).reshape(N, -1, num_groups, C // num_groups)


def gn_forward_plain(x, gamma, beta, num_groups: int, eps: float):
    """(y, mean [N, G], rstd [N, G]); stats in f32 (f64 for f64 x),
    two-pass variance."""
    xf = _grouped(x, num_groups)
    mean = xf.mean(dim=(1, 3))
    var = ((xf - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean[:, None, :, None]) * rstd[:, None, :, None])
    dt = xf.dtype
    y = xhat.reshape(x.shape) * gamma.to(dt) + beta.to(dt)
    return y.to(x.dtype), mean, rstd


def gn_backward_plain(x, dy, gamma, mean, rstd, num_groups: int):
    """(dx, dgamma, dbeta) from the saved statistics; dgamma/dbeta in
    gamma's dtype, rounded once from their f32 (f64) sums."""
    C = x.shape[-1]
    Cg = C // num_groups
    xg = _grouped(x, num_groups)
    xhat = (xg - mean[:, None, :, None]) * rstd[:, None, :, None]
    dyg = _grouped(dy, num_groups)
    dxhat = dyg * gamma.to(xg.dtype).reshape(1, 1, num_groups, Cg)
    m = xg.shape[1] * Cg
    s1 = dxhat.sum(dim=(1, 3))
    s2 = (dxhat * xhat).sum(dim=(1, 3))
    dx = (dxhat - (s1[:, None, :, None] + xhat * s2[:, None, :, None]) / m) \
        * rstd[:, None, :, None]
    dgamma = (dyg * xhat).sum(dim=(0, 1)).reshape(C)
    dbeta = dyg.sum(dim=(0, 1)).reshape(C)
    return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    """How the kernels cover [N, S, C] in G groups: one cluster of `K`
    blocks per (sample, group); block rank r owns spatial rows
    [r * rows, (r + 1) * rows); `threads` threads a block, thread t on the
    `vec` channels at column t % vpr (vpr = Cg / vec) of rows t // vpr,
    then every threads // vpr rows; `smem` bytes of dynamic shared memory;
    `resident`: the slice is held in shared memory (else later passes
    re-read it)."""
    clusters: int
    K: int
    threads: int
    rows: int
    smem: int
    resident: bool
    vec: int

    @property
    def blocks(self) -> int:
        return self.clusters * self.K


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _smem_bytes(rows: int, Cg: int, esize: int, rpp: int, backward: bool,
                resident: bool) -> int:
    """The kernels' dynamic shared memory (fwd_smem and bwd_smem in the
    CUDA source): the held slices of x (and dy), then in the backward the
    per-row and per-block channel partials of dgamma and dbeta."""
    held = _round16(rows * Cg * esize) if resident else 0
    if not backward:
        return held
    return 2 * held + _round16(2 * rpp * Cg * 4) + _round16(2 * Cg * 4)


def launch_plan(N: int, S: int, C: int, G: int, dtype: torch.dtype, *,
                backward: bool, vec: int | None = None) -> LaunchPlan:
    """The kernels' launch plan for x of [N, S, C] in `dtype` and G groups.

    K, the blocks per cluster, is the smallest that gives each SM a block
    and each block at most BLOCK_BYTES of x (capped at 8, the portable
    cluster size, and at S), then raised while a block's slice does not
    fit in its shared memory; where it does not fit even at 8, the slice
    is streamed.  A block has BLOCK_THREADS threads (a streamed one
    MAX_THREADS, to keep more loads in flight), fewer where its slice has
    fewer 16-byte vectors, and at least one row's worth.
    (Both knobs were chosen by ``gn_timing.py --sweep`` on the H100: a
    cluster barrier costs about a microsecond, so small groups take few
    blocks.)  `vec` defaults to the widest load that divides Cg (the
    wrappers pass the one their pointers allow)."""
    Cg = C // G
    esize = dtype.itemsize
    if vec is None:
        vec = build.vector_width(esize, Cg)
    vpr = Cg // vec
    if C % G or Cg % vec or vpr > MAX_THREADS:
        raise ValueError(f"group of {Cg} channels in vectors of {vec} does "
                         f"not fit the kernel's {MAX_THREADS} threads")
    clusters = N * G

    def sized(K: int, resident: bool) -> LaunchPlan:
        rows = -(-S // K)
        K = -(-S // rows)                  # no block without rows
        row_threads = -(-vpr // 32) * 32
        aim = BLOCK_THREADS if resident else MAX_THREADS   # streamed: loads in flight
        threads = min(MAX_THREADS, max(row_threads, min(
            aim, -(-rows * vpr // 32) * 32)))
        smem = _smem_bytes(rows, Cg, esize, threads // vpr, backward, resident)
        return LaunchPlan(clusters, K, threads, rows, smem, resident, vec)

    k_max = min(MAX_CLUSTER, S)
    k0 = min(k_max, max(1, -(-MIN_BLOCKS // clusters),
                        -(-S * Cg * esize // BLOCK_BYTES)))
    for K in range(k0, k_max + 1):
        plan = sized(K, True)
        if plan.smem <= SMEM_BYTES:
            return plan
    return sized(k_max, False)


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


def _check_params(gamma: torch.Tensor, beta: torch.Tensor | None = None) -> None:
    """gamma (and beta) in a dtype the kernels take, both the same."""
    if gamma.dtype not in _DTYPES:
        raise TypeError("group_norm kernel takes float32 or bfloat16 gamma "
                        f"and beta, got {gamma.dtype}")
    if beta is not None and beta.dtype != gamma.dtype:
        raise TypeError(f"group_norm kernel: gamma ({gamma.dtype}) and beta "
                        f"({beta.dtype}) must share a dtype")


def _vector_width(x: torch.Tensor, num_groups: int, *tensors) -> int:
    Cg = x.shape[-1] // num_groups
    vec = build.vector_width(x.element_size(), Cg,
                             *(t.data_ptr() for t in (x, *tensors)))
    if Cg // vec > MAX_THREADS:
        raise ValueError(f"group of {Cg} channels is wider than the kernel's "
                         f"{MAX_THREADS} threads x {vec} elements")
    return vec


_FINISH_COUNTERS: dict = {}
_FINISH_STREAMS: dict = {}
_FINISH_LOCK = threading.Lock()


def _finish_counter(device: torch.device, num_groups: int) -> torch.Tensor:
    """The backward's arrival counters on `device`, one per (group, block
    rank of a cluster): allocated zeroed once (grown if a layer has more
    groups); each launch leaves them at zero again.  Launches share them
    safely only because they run in order on one stream: clients that
    train in threads on one card all launch on its default stream.  The
    first backward on a device claims its current stream for the counters,
    and a backward on another stream of that device raises (one such
    launch could run beside another and corrupt the count)."""
    need = num_groups * MAX_CLUSTER
    stream = torch.cuda.current_stream().cuda_stream
    with _FINISH_LOCK:
        owner = _FINISH_STREAMS.setdefault(device, stream)
        if owner != stream:
            raise RuntimeError(
                f"group_norm backward on stream {stream:#x} of {device}, but "
                f"its arrival counters serve stream {owner:#x}: launch every "
                "GroupNorm backward of a device on one stream")
        buf = _FINISH_COUNTERS.get(device)
        if buf is None or buf.numel() < need:
            buf = torch.zeros(max(need, 64), dtype=torch.int32, device=device)
            _FINISH_COUNTERS[device] = buf
    return buf


def _plan_args(plan: LaunchPlan) -> tuple:
    return plan.vec, plan.K, plan.threads, plan.rows, plan.smem, int(plan.resident)


def gn_forward(x, gamma, beta, num_groups: int, eps: float):
    """(y, mean, rstd): the forward kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if not on_card(x):
        return gn_forward_plain(x, gamma, beta, num_groups, eps)
    N, S, C = _check(x, num_groups)
    _check_side(x, (C,), gamma=gamma, beta=beta)
    _check_params(gamma, beta)
    g, b = gamma.detach().contiguous(), beta.detach().contiguous()
    y = torch.empty_like(x)
    mean = torch.empty(N, num_groups, device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    plan = launch_plan(N, S, C, num_groups, x.dtype, backward=False,
                       vec=_vector_width(x, num_groups, y))
    with torch.cuda.device(x.device):
        rc = build.library().fedml_gn_fwd(
            x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), N, S, C, num_groups, float(eps),
            _DTYPES[x.dtype], _DTYPES[g.dtype], *_plan_args(plan),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gn_fwd")
    build.count_launch(gn_forward)
    return y, mean, rstd


gn_forward.launches = 0


def gn_backward(x, dy, gamma, mean, rstd, num_groups: int):
    """(dx, dgamma, dbeta): the backward kernel on a CUDA tensor (dgamma
    and dbeta finished in the same launch, in gamma's dtype), the plain
    version on a CPU tensor."""
    if not on_card(x):
        return gn_backward_plain(x, dy, gamma, mean, rstd, num_groups)
    N, S, C = _check(x, num_groups, dy)
    _check_side(x, (C,), gamma=gamma)
    _check_side(x, (N, num_groups), mean=mean, rstd=rstd)
    _check_params(gamma)
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("group_norm kernel: mean and rstd must be float32")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    g = gamma.detach().contiguous()
    dx = torch.empty_like(x)
    dgamma = torch.empty(C, device=x.device, dtype=g.dtype)
    dbeta = torch.empty_like(dgamma)
    part = torch.empty(2, N, C, device=x.device, dtype=torch.float32)
    plan = launch_plan(N, S, C, num_groups, x.dtype, backward=True,
                       vec=_vector_width(x, num_groups, dy, dx))
    with torch.cuda.device(x.device):
        counter = _finish_counter(x.device, num_groups)
        rc = build.library().fedml_gn_bwd(
            x.data_ptr(), dy.data_ptr(), g.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), part.data_ptr(), counter.data_ptr(), N, S, C,
            num_groups, _DTYPES[x.dtype], _DTYPES[g.dtype], *_plan_args(plan),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gn_bwd")
    build.count_launch(gn_backward)
    return dx, dgamma, dbeta


gn_backward.launches = 0


# ---------------------------------------------------------------------------
# public op and module
# ---------------------------------------------------------------------------

def gn_double_backward(x, dy, gamma, mean, rstd, num_groups: int,
                       g_dx, g_dgamma, g_dbeta):
    """The gradients of the backward's outputs (dx, dgamma, dbeta), given
    the gradients on them (g_dx, g_dgamma, g_dbeta), with respect to its
    inputs (x, dy, gamma); mean and rstd are functions of x.

    Per (sample, group) of m elements, with xhat = (x - mean) * rstd,
    a = dy * gamma, B = mean(a * xhat), u = g_dx:
      P = rstd * (u - mean(u) - xhat * mean(u * xhat))
      d/d dy    = gamma * P + g_dgamma * xhat + g_dbeta
      d/d gamma = sum over samples and positions of dy * P
      d/d xhat  = -rstd * (B * u + a * mean(u * xhat)) + g_dgamma * dy
      d/d rstd  = sum(u * (a - mean(a) - xhat * B))      (dx = rstd * (...))
      d/d x     = rstd * (h - mean(h) - xhat * mean(h * xhat))
                  - d/d rstd * rstd^2 * xhat / m          (h = d/d xhat)
    computed in f32 (f64 for f64 x) and rounded to each input's dtype."""
    C = x.shape[-1]
    Cg = C // num_groups
    xg = _grouped(x, num_groups)
    dt = xg.dtype
    m = xg.shape[1] * Cg
    r = rstd.to(dt)[:, None, :, None]
    xhat = (xg - mean.to(dt)[:, None, :, None]) * r
    dyg = _grouped(dy, num_groups)
    per_channel = lambda t: t.to(dt).reshape(1, 1, num_groups, Cg)
    gam = per_channel(gamma)
    a = dyg * gam
    u = _grouped(g_dx, num_groups)
    group_mean = lambda t: t.mean(dim=(1, 3), keepdim=True)
    B = group_mean(a * xhat)
    u_xhat = group_mean(u * xhat)
    P = r * (u - group_mean(u) - xhat * u_xhat)
    v, w = per_channel(g_dgamma), per_channel(g_dbeta)
    d_dy = gam * P + v * xhat + w
    d_gamma = (dyg * P).sum(dim=(0, 1)).reshape(C)
    h = -r * (B * u + a * u_xhat) + v * dyg
    d_rstd = (u * (a - group_mean(a) - xhat * B)).sum(dim=(1, 3), keepdim=True)
    d_x = (r * (h - group_mean(h) - xhat * group_mean(h * xhat))
           - d_rstd * r * r * xhat / m)
    return (d_x.reshape(x.shape).to(x.dtype), d_dy.reshape(dy.shape).to(dy.dtype),
            d_gamma.to(gamma.dtype))


class _GroupNormBackwardFn(torch.autograd.Function):
    """(x, dy, gamma, mean, rstd) -> (dx, dgamma, dbeta) through the
    backward kernel (the plain version on the CPU, recording no graph, as
    the kernel records none), differentiable through the analytic double
    backward."""

    @staticmethod
    def forward(ctx, x, dy, gamma, mean, rstd, num_groups):
        with torch.no_grad():
            dx, dgamma, dbeta = gn_backward(x, dy, gamma, mean, rstd,
                                            num_groups)
        ctx.save_for_backward(x, dy, gamma, mean, rstd)
        ctx.num_groups = num_groups
        return dx, dgamma, dbeta

    @staticmethod
    def backward(ctx, g_dx, g_dgamma, g_dbeta):
        x, dy, gamma, mean, rstd = ctx.saved_tensors
        d_x, d_dy, d_gamma = gn_double_backward(
            x, dy, gamma, mean, rstd, ctx.num_groups, g_dx, g_dgamma, g_dbeta)
        return d_x, d_dy, d_gamma, None, None, None


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
        dy = dy.contiguous()
        if torch.is_grad_enabled():      # create_graph: a second derivative
            dx, dgamma, dbeta = _GroupNormBackwardFn.apply(
                x, dy, gamma, mean, rstd, ctx.num_groups)
        else:
            dx, dgamma, dbeta = gn_backward(x, dy, gamma, mean, rstd,
                                            ctx.num_groups)
        return dx, dgamma, dbeta, None, None


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
