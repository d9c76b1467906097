"""Arithmetic over dicts of tensors for federated aggregation (the port of
fedml_tpu/core/pytree.py).  Where the JAX package maps over pytrees, the
port maps over flat ``{name: tensor}`` dicts, in the dict's order."""
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


def tree_stack(trees) -> dict:
    """Stack a list of identically-keyed dicts along a new axis 0."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def tree_unstack(tree: dict) -> list:
    """Inverse of tree_stack: split the leading axis into a list of dicts."""
    n = next(iter(tree.values())).shape[0]
    return [{k: v[i] for k, v in tree.items()} for i in range(n)]


def tree_zeros_like(tree: dict) -> dict:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_dot(a: dict, b: dict) -> torch.Tensor:
    """sum over leaves of <a, b> (each leaf's dot in its dtype, then the
    f32 sum of those, as jnp.vdot leaf by leaf)."""
    return torch.stack([torch.vdot(a[k].reshape(-1), b[k].reshape(-1))
                        .float() for k in a]).sum()


def tree_cast(tree: dict, dtype) -> dict:
    return {k: v.to(dtype) for k, v in tree.items()}


def vectorize_weights(tree: dict) -> torch.Tensor:
    """Flatten a dict of tensors into one 1-D vector in the dict's order
    (reference robust_aggregation.py:4-9): MPC encoding and norm math."""
    return torch.cat([v.reshape(-1) for v in tree.values()])


def unvectorize_weights(vec: torch.Tensor, like: dict) -> dict:
    """Inverse of vectorize_weights given a template dict."""
    out, off = {}, 0
    for k, v in like.items():
        n = v.numel()
        out[k] = vec[off:off + n].reshape(v.shape).to(v.dtype)
        off += n
    return out


def tree_merge_counts(kept: dict, advanced: dict) -> dict:
    """`kept` with every schedule step count (an optimizer state's
    "count", core/trainer.py::Optimizer) taken from `advanced`.

    The empty-batch guard freezes the optimizer state, which would freeze
    the schedule's count too, so padded-lane clients would stall on the LR
    schedule while real steps elapse.  The schedule count measures elapsed
    local steps, not applied updates; Adam's "adam_count", whose bias
    correction must agree with the frozen moments, and the moment and
    momentum buffers stay frozen."""
    return {k: (advanced[k] if k == "count"
                else tree_merge_counts(v, advanced[k])
                if isinstance(v, dict) else v)
            for k, v in kept.items()}
