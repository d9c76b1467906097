"""Weighted aggregation over the client axis, with a hand-written CUDA kernel
(``csrc/aggregate.cu``).

Replaces fedml_tpu/ops/aggregate.py::_wmean_kernel (driven by
``_wmean_flat`` and ``weighted_mean_pallas``): sum_c w_c * x_c / sum(w) over
a client stack flattened to one [C, N] matrix.  The kernel has two forms:

* ``fold(acc, V, w)``: acc += sum_k w_k * V[k, :] in f32, for a [k, P] lane
  matrix in bf16 or f32.  The mesh engine's chunk fold (the JAX package's
  ``weighted_sum_tree`` + flat carry add, parallel/engine.py:245) is this.
* ``weighted_mean_flat(V, w)``: sum_k w_k * V[k, :] / max(sum(w), 1e-12),
  the finalize form behind ``weighted_mean``.

Bound on the H100 (3.35 TB/s): bytes; the k-row reduction does 2 flops per
element read.  Each thread owns 16 bytes of every lane row, so all loads
are coalesced 16-byte loads and the accumulator is read and written once.

Layout: a dict of [C, ...] leaves flattens (``flatten_stacked_tree``) to one
[C, N] matrix with N padded to TILE = 512 lanes, as in the JAX package;
the padding also keeps every row 16-byte aligned for the kernel.

On a CPU tensor the wrappers run the plain PyTorch version; on a CUDA
tensor they launch the kernel or raise.  ``wsum.launches`` counts kernel
launches of both forms.
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

def wsum(out: torch.Tensor, V: torch.Tensor, w: torch.Tensor,
         finalize: bool) -> None:
    """Launch the fold kernel: out += w @ V (finalize=False) or
    out = w @ V / max(sum(w), 1e-12) (finalize=True).  CUDA tensors only."""
    if V.dtype not in _DTYPES:
        raise TypeError(f"fold kernel takes float32 or bfloat16 lanes, got {V.dtype}")
    if V.dim() != 2 or V.stride(1) != 1:
        raise ValueError(f"fold kernel takes a [k, P] row-major lane matrix, "
                         f"got shape {tuple(V.shape)} strides {V.stride()}")
    k, P = V.shape
    if out.shape != (P,) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"fold accumulator must be contiguous f32 [{P}]")
    if w.shape != (k,) or w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"fold weights must be contiguous f32 [{k}]")
    if not (out.device == V.device == w.device):
        raise ValueError("fold kernel inputs lie on different devices")
    ld = V.stride(0)
    full = 16 // V.element_size()
    vec = full if (P % full == 0 and ld % full == 0
                   and V.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0) else 1
    with torch.cuda.device(V.device):
        rc = build.library().fedml_wsum(
            out.data_ptr(), V.data_ptr(), w.data_ptr(), k, P, ld,
            int(finalize), _DTYPES[V.dtype], vec,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "wsum")
    wsum.launches += 1


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
