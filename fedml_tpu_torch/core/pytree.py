"""Arithmetic over dicts of tensors for federated aggregation (the subset of
fedml_tpu/core/pytree.py that the FedAvg, robust, FedOpt, FedProx and
FedNova rounds use).  Where the JAX package maps over pytrees, the port maps
over flat ``{name: tensor}`` dicts."""
from __future__ import annotations

import torch


def tree_weighted_mean(trees_stacked: dict, weights: torch.Tensor) -> dict:
    """Sample-weighted mean over the leading (client) axis of every leaf:
    ``sum_i (n_i / N) * w_i`` (FedAVGAggregator.py:73-81), in each leaf's
    dtype like the reference."""
    w = weights / weights.sum()

    def _avg(leaf):
        wb = w.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return (leaf * wb).sum(dim=0)

    return {k: _avg(v) for k, v in trees_stacked.items()}


def tree_add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def tree_scale(tree: dict, s) -> dict:
    """Every leaf times `s`, with `s` cast to the leaf's dtype first (as
    ``jnp.asarray(s, dtype=x.dtype)`` does: a bf16 leaf scales by a bf16
    factor)."""
    s = torch.as_tensor(s)
    return {k: v * s.to(device=v.device, dtype=v.dtype) for k, v in tree.items()}


def tree_sq_norm(tree: dict) -> torch.Tensor:
    """Global squared L2 norm over all leaves: an f32 sum per leaf, then
    the sum of those."""
    return torch.stack([v.float().square().sum() for v in tree.values()]).sum()


def tree_l2_norm(tree: dict) -> torch.Tensor:
    """Global L2 norm over all leaves (the reference's vectorize_weight +
    torch.norm, robust_aggregation.py:4-9)."""
    return torch.sqrt(tree_sq_norm(tree))


def clip_scale(sq_norm, max_norm) -> torch.Tensor:
    """The norm-clip factor min(1, tau / ||.||) from a SQUARED norm, with the
    1e-24 floor inside the sqrt guarding the zero-update case."""
    sq = torch.as_tensor(sq_norm, dtype=torch.float32)
    norm = torch.sqrt(torch.clamp(sq, min=1e-24))
    return torch.clamp(max_norm / norm, max=1.0)


def tree_clip_by_norm(tree: dict, max_norm) -> dict:
    return tree_scale(tree, clip_scale(tree_sq_norm(tree), max_norm))


def tree_select(pred, new: dict, old: dict) -> dict:
    """Elementwise ``where(pred, new, old)`` over two matching dicts: the
    empty-batch guard for state that is not additive."""
    return {k: torch.where(pred, new[k], old[k]) for k in new}
