"""Aggregation over the client axis, with hand-written CUDA kernels
(``csrc/aggregate.cu``, ``csrc/robust.cu``).

``wsum`` replaces fedml_tpu/ops/aggregate.py::_wmean_kernel (driven by
``_wmean_flat`` and ``weighted_mean_pallas``): sum_c w_c * x_c / sum(w) over
a client stack flattened to one [C, N] matrix.  The kernel has two forms:

* ``fold(acc, V, w)``: acc += sum_k w_k * V[k, :] in f32, for a [k, P] lane
  matrix in bf16 or f32.  The mesh engine's chunk fold (the JAX package's
  ``weighted_sum_tree`` + flat carry add, parallel/engine.py:245) is this.
* ``weighted_mean_flat(V, w)``: sum_k w_k * V[k, :] / max(sum(w), 1e-12),
  the finalize form behind ``weighted_mean``.

``sqnorm`` and ``clip_agg`` replace the two kernels of
``robust_weighted_mean_pallas`` (``_sqnorm_kernel``, ``_clip_agg_kernel``):
the per-client ||x_c - g||^2 and the clipped fold
out (+)= base * g + sum_c cf_c * (x_c - g).  ``robust_weighted_mean`` is
their finalize (in place into the f32 g buffer, base 1); ``clip_fold`` is
the mesh engine's accumulate form (norm_clip, and FedNova's d-fold).

Bound on the H100 (3.35 TB/s): bytes for all three; a k-row reduction does
2 or 3 flops per element read.  Each thread owns 16 bytes of every lane
row, so all loads are coalesced 16-byte loads and the accumulator is read
and written once.

Layout: a dict of [C, ...] leaves flattens (``flatten_stacked_tree``) to one
[C, N] matrix with N padded to TILE = 512 lanes, as in the JAX package;
the padding also keeps every row 16-byte aligned for the kernels.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch the kernel or raise.  ``wsum.launches``,
``sqnorm.launches`` and ``clip_agg.launches`` count kernel launches (one
sqnorm launch is its two-stage pair).
"""
from __future__ import annotations

import dataclasses

import torch

from fedml_tpu_torch.ops import build
from fedml_tpu_torch.ops.build import on_card

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 512                             # lanes per row tile, as in the JAX package


# ---------------------------------------------------------------------------
# dict of [C, ...] tensors <-> [C, N] matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """How a flat row maps back to named leaves: names, per-client shapes
    and dtypes in order, and the unpadded row length n."""
    names: tuple
    shapes: tuple
    dtypes: tuple
    n: int

    @property
    def sizes(self) -> list:
        return [int(torch.Size(s).numel()) for s in self.shapes]

    @property
    def padded(self) -> int:
        return self.n + (-self.n) % TILE


def spec_of(tree: dict) -> TreeSpec:
    """TreeSpec of an UNSTACKED dict (one client's leaves)."""
    shapes = tuple(tuple(v.shape) for v in tree.values())
    return TreeSpec(tuple(tree), shapes, tuple(v.dtype for v in tree.values()),
                    sum(int(torch.Size(s).numel()) for s in shapes))


def flatten_stacked_tree(stacked: dict, dtype=torch.float32):
    """[C, ...] leaves -> ([C, N_pad] matrix in `dtype`, TreeSpec), N padded
    to TILE with zeros.  One fresh buffer; the inputs are not aliased."""
    first = next(iter(stacked.values()))
    C = first.shape[0]
    spec = spec_of({k: v[0] for k, v in stacked.items()})
    flat = torch.zeros(C, spec.padded, dtype=dtype, device=first.device)
    off = 0
    for v, size in zip(stacked.values(), spec.sizes):
        flat[:, off:off + size] = v.reshape(C, size)
        off += size
    return flat, spec


def unflatten_to_tree(vec: torch.Tensor, spec: TreeSpec, dtype=None) -> dict:
    """[N] or [N_pad] row -> dict of leaves with the spec's shapes, cast to
    each leaf's recorded dtype (or to `dtype`).  Leaves that need no cast
    are views of `vec`; the split keeps autograd's backward to one concat."""
    tail = vec.shape[0] - spec.n
    parts = torch.split(vec, spec.sizes + ([tail] if tail else []))
    return {name: part.view(shape).to(dtype or dt)
            for name, shape, dt, part in zip(spec.names, spec.shapes,
                                              spec.dtypes, parts)}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def wsum_plain(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w_k * V[k, :] in f32."""
    return (w.float()[:, None] * V.float()).sum(dim=0)


def fold_plain(acc: torch.Tensor, V: torch.Tensor, w: torch.Tensor) -> None:
    acc.add_(wsum_plain(V, w))


def weighted_mean_flat_plain(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return wsum_plain(V, w) / torch.clamp(w.float().sum(), min=1e-12)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check_lanes(V: torch.Tensor, what: str) -> tuple[int, int]:
    """(k, P) of a [k, P] row-major lane matrix in f32 or bf16."""
    if V.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 lanes, "
                        f"got {V.dtype}")
    if V.dim() != 2 or V.stride(1) != 1:
        raise ValueError(f"{what} kernel takes a [k, P] row-major lane matrix, "
                         f"got shape {tuple(V.shape)} strides {V.stride()}")
    return V.shape


def _check_vector(t: torch.Tensor, n: int, dtype, what: str,
                  V: torch.Tensor) -> None:
    if t.shape != (n,) or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous {dtype} [{n}]")
    if t.device != V.device:
        raise ValueError(f"{what} lies on {t.device}, the lanes on {V.device}")


def _vec(V: torch.Tensor, *others: torch.Tensor) -> int:
    """Elements per 16-byte load when P, the row stride and every pointer
    allow it, else 1."""
    full = 16 // V.element_size()
    ok = (V.shape[1] % full == 0 and V.stride(0) % full == 0
          and all(t.data_ptr() % 16 == 0 for t in (V, *others)))
    return full if ok else 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def wsum(out: torch.Tensor, V: torch.Tensor, w: torch.Tensor,
         finalize: bool) -> None:
    """Launch the fold kernel: out += w @ V (finalize=False) or
    out = w @ V / max(sum(w), 1e-12) (finalize=True).  CUDA tensors only."""
    k, P = _check_lanes(V, "fold")
    _check_vector(out, P, torch.float32, "fold accumulator", V)
    _check_vector(w, k, torch.float32, "fold weights", V)
    with torch.cuda.device(V.device):
        rc = build.library().fedml_wsum(
            out.data_ptr(), V.data_ptr(), w.data_ptr(), k, P, V.stride(0),
            int(finalize), _DTYPES[V.dtype], _vec(V, out), _stream())
    build.check(rc, "wsum")
    build.count_launch(wsum)


wsum.launches = 0


def fold(acc: torch.Tensor, V: torch.Tensor, w: torch.Tensor) -> None:
    """acc += sum_k w_k * V[k, :] (in place), accumulated in f32."""
    if on_card(V):
        wsum(acc, V, w, finalize=False)
    else:
        fold_plain(acc, V, w)


def weighted_mean_flat(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_k w_k * V[k, :] / max(sum(w), 1e-12) as a new f32 [P] vector."""
    if not on_card(V):
        return weighted_mean_flat_plain(V, w)
    out = torch.empty(V.shape[1], dtype=torch.float32, device=V.device)
    wsum(out, V, w, finalize=True)
    return out


def weighted_mean(stacked: dict, weights: torch.Tensor) -> dict:
    """Sample-weighted mean over the client axis of every leaf, fused over
    all leaves: the port of weighted_mean_pallas."""
    flat, spec = flatten_stacked_tree(stacked)
    return unflatten_to_tree(
        weighted_mean_flat(flat, weights.to(torch.float32).contiguous()), spec)


# ---------------------------------------------------------------------------
# norm-clipped aggregation (csrc/robust.cu): the port of
# robust_weighted_mean_pallas's two kernels
# ---------------------------------------------------------------------------

def sqnorm_plain(V: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """sum_p (V[k, p] - g[p])^2 per lane row, in f32."""
    return (V.float() - g.float()).square().sum(dim=1)


def clip_agg_plain(out: torch.Tensor, V: torch.Tensor, g: torch.Tensor,
                   cf: torch.Tensor, base, accumulate: bool) -> None:
    """out (+)= base * g + sum_k cf_k * (V[k] - g), in f32; `out` may be
    `g` itself (the in-place form)."""
    r = (cf[:, None] * (V.float() - g.float())).sum(dim=0) + base * g.float()
    if accumulate:
        out.add_(r)
    else:
        out.copy_(r)


def sqnorm(V: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch the squared-distance kernel: [k] f32 of
    sum_p (V[k, p] - g[p])^2, g in V's dtype.  CUDA tensors only."""
    k, P = _check_lanes(V, "sqnorm")
    _check_vector(g, P, V.dtype, "sqnorm g", V)
    lib = build.library()
    out = torch.empty(k, dtype=torch.float32, device=V.device)
    partial = torch.empty(k * lib.fedml_sqnorm_max_blocks(),
                          dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        rc = lib.fedml_sqnorm(out.data_ptr(), partial.data_ptr(), V.data_ptr(),
                              g.data_ptr(), k, P, V.stride(0), _DTYPES[V.dtype],
                              _vec(V, g), _stream())
    build.check(rc, "sqnorm")
    build.count_launch(sqnorm)
    return out


sqnorm.launches = 0


def clip_agg(out: torch.Tensor, V: torch.Tensor, g: torch.Tensor,
             cf: torch.Tensor, base, accumulate: bool) -> None:
    """Launch the clipped-fold kernel: out (+)= base * g + sum_k cf_k *
    (V[k] - g) in f32.  `base` is a float or a one-element f32 tensor on
    the lanes' device (read there, so the host does not wait).  `out` may be
    `g` itself when g is f32 and accumulate is False (the in-place form).
    CUDA tensors only."""
    k, P = _check_lanes(V, "clip_agg")
    _check_vector(g, P, V.dtype, "clip_agg g", V)
    _check_vector(out, P, torch.float32, "clip_agg out", V)
    _check_vector(cf, k, torch.float32, "clip_agg factors", V)
    if out.data_ptr() == g.data_ptr() and accumulate:
        raise ValueError("clip_agg cannot accumulate into g itself")
    if isinstance(base, torch.Tensor):
        if (base.numel() != 1 or base.dtype != torch.float32
                or base.device != V.device):
            raise ValueError("clip_agg base must be one f32 element on the "
                             "lanes' device")
        base_ptr, base_const = base.data_ptr(), 0.0
    else:
        base_ptr, base_const = None, float(base)
    with torch.cuda.device(V.device):
        rc = build.library().fedml_clip_agg(
            out.data_ptr(), V.data_ptr(), g.data_ptr(), cf.data_ptr(),
            base_ptr, base_const, k, P, V.stride(0), int(accumulate),
            _DTYPES[V.dtype], _vec(V, g, out), _stream())
    build.check(rc, "clip_agg")
    build.count_launch(clip_agg)


clip_agg.launches = 0


def client_sqnorms(V: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[k] f32 squared distances of the lane rows to g."""
    return sqnorm(V, g) if on_card(V) else sqnorm_plain(V, g)


def clip_fold(acc: torch.Tensor, V: torch.Tensor, g: torch.Tensor,
              cf: torch.Tensor, base) -> None:
    """acc += base * g + sum_k cf_k * (V[k] - g) (in place), in f32."""
    if on_card(V):
        clip_agg(acc, V, g, cf, base, accumulate=True)
    else:
        clip_agg_plain(acc, V, g, cf, base, accumulate=True)


def shift_toward(g: torch.Tensor, V: torch.Tensor, cf: torch.Tensor) -> None:
    """g = g + sum_k cf_k * (V[k] - g), written in place into the f32
    buffer g (the Pallas kernel's output aliases its g input likewise)."""
    if on_card(V):
        clip_agg(g, V, g, cf, 1.0, accumulate=False)
    else:
        clip_agg_plain(g, V, g, cf, 1.0, accumulate=False)


def robust_weighted_mean(stacked: dict, weights: torch.Tensor,
                         global_tree: dict, norm_bound: float) -> dict:
    """g + sum_i w_hat_i * clip_i * (x_i - g), w_hat = w / sum(w),
    clip_i = min(1, tau / ||x_i - g||): norm_diff_clip then the weighted
    mean, fused over all leaves (the port of robust_weighted_mean_pallas).
    The clip factors stay on the device."""
    # imported here: fedml_tpu_torch.core imports this module
    from fedml_tpu_torch.core.pytree import clip_scale
    flat, spec = flatten_stacked_tree(stacked)
    gflat = flatten_stacked_tree({k: global_tree[k][None] for k in stacked})[0][0]
    clip = clip_scale(client_sqnorms(flat, gflat), norm_bound)
    w = weights.to(torch.float32)
    cf = (w / torch.clamp(w.sum(), min=1e-12) * clip).contiguous()
    shift_toward(gflat, flat, cf)
    return unflatten_to_tree(gflat, spec)
