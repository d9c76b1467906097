"""Byzantine-robust aggregation primitives (port of fedml_tpu/core/robust.py).

Parity with reference fedml_core/robustness/robust_aggregation.py: norm
-difference clipping ``w_t + clip(w_local - w_t)`` (:38-49) and weak-DP
Gaussian noise (:51-55); plus krum, multi-krum, coordinate median and
trimmed mean over the stacked client axis.  The caller passes the params
only (``ClientTrainer.param_names``, or a row's parameter segment): no
BatchNorm statistic may enter a norm or an order statistic.

Where the JAX package's numbers differ from PyTorch's defaults:
* ``jnp.median`` of an even count averages the two middle values (and is
  NaN where any value is); ``torch.median`` returns the lower one.  The
  median here sorts and averages the middle pair.
* ``jnp.argsort`` is stable; multi-krum's top-m asks torch for a stable
  sort so that ties break as in JAX.
* The noise draws from a ``torch.Generator``, not ``jax.random``: the same
  seed gives other numbers, with the same distribution.
"""
from __future__ import annotations

import torch

from fedml_tpu_torch.core.pytree import (clip_scale, tree_add,
                                         tree_clip_by_norm, tree_sub)

__all__ = ["norm_diff_clip", "clip_scale", "clip_row", "add_weak_dp_noise",
           "krum_select_flat", "krum_scores_flat", "multi_krum_select_flat",
           "default_multi_krum_m", "krum_select", "multi_krum_select",
           "coordinate_median", "trimmed_mean"]


def norm_diff_clip(local_params: dict, global_params: dict,
                   norm_bound: float) -> dict:
    """w_global + clip(w_local - w_global): the update clipped to
    `norm_bound` and re-applied, in the leaves' dtype."""
    diff = tree_sub(local_params, global_params)
    return tree_add(global_params, tree_clip_by_norm(diff, norm_bound))


def clip_row(row: torch.Tensor, norm_bound: float) -> torch.Tensor:
    """Flat-row norm clip of a DELTA row: row * clip_scale(||row||^2)."""
    row = row.to(torch.float32)
    return row * clip_scale((row * row).sum(), norm_bound)


def add_weak_dp_noise(params: dict, generator: torch.Generator,
                      stddev: float) -> dict:
    """Per-leaf Gaussian noise with std `stddev` (weak differential
    privacy), drawn from `generator` (on the leaves' device)."""
    return {k: v + stddev * torch.randn(v.shape, generator=generator,
                                        dtype=v.dtype, device=v.device)
            for k, v in params.items()}


def krum_scores_flat(flat: torch.Tensor, n_byzantine: int) -> torch.Tensor:
    """Per-client krum scores on a [K, P] matrix: the sum of squared
    distances to the n-f-2 nearest neighbours, from the Gram matrix.  A
    non-finite distance becomes +inf, so a NaN/Inf row scores inf and drops
    out of every other row's nearest sums (identity on finite input)."""
    sq = (flat * flat).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T), min=0.0)
    n = flat.shape[0]
    k = max(n - n_byzantine - 2, 1)
    eye = torch.eye(n, dtype=torch.bool, device=flat.device)
    inf = torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device)
    d2 = torch.where(eye, inf, d2)
    d2 = torch.where(torch.isfinite(d2) | eye, d2, inf)
    return torch.sort(d2, dim=1).values[:, :k].sum(dim=1)


def krum_select_flat(flat: torch.Tensor, n_byzantine: int) -> torch.Tensor:
    """Krum on a [K, P] matrix: the index of the lowest score (the first,
    on ties, as ``jnp.argmin``)."""
    return torch.argmin(krum_scores_flat(flat, n_byzantine))


def default_multi_krum_m(K: int, n_byzantine: int, m: int | None = None) -> int:
    """Multi-krum selection size: m = K - f - 2 when unset (Blanchard et
    al. 2017), clamped to [1, K] either way."""
    if m is None:
        m = K - n_byzantine - 2
    return max(1, min(m, K))


def multi_krum_select_flat(flat: torch.Tensor, n_byzantine: int,
                           m: int) -> torch.Tensor:
    """Indices of the m clients with the lowest krum scores, ties in index
    order (a stable sort, as ``jnp.argsort``)."""
    scores = krum_scores_flat(flat, n_byzantine)
    m = max(1, min(m, flat.shape[0]))
    return torch.argsort(scores, stable=True)[:m]


def _flatten_clients(stacked_params: dict) -> torch.Tensor:
    """[K, ...] leaves -> the [K, P] matrix the krum family scores."""
    return torch.cat([x.reshape(x.shape[0], -1)
                      for x in stacked_params.values()], dim=1)


def krum_select(stacked_params: dict, n_byzantine: int) -> torch.Tensor:
    return krum_select_flat(_flatten_clients(stacked_params), n_byzantine)


def multi_krum_select(stacked_params: dict, n_byzantine: int,
                      m: int) -> torch.Tensor:
    return multi_krum_select_flat(_flatten_clients(stacked_params),
                                  n_byzantine, m)


def median_axis0(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: the middle value, or the mean of the two
    middle values for an even count; NaN where any value is NaN."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    med = s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2
    return torch.where(torch.isnan(x).any(dim=0),
                       torch.full_like(med, float("nan")), med)


def trimmed_mean_axis0(x: torch.Tensor, trim_k: int) -> torch.Tensor:
    """Mean over axis 0 after dropping the k largest and k smallest values
    (k capped so one survives); NaN sorts last and is trimmed first.
    The kept rows are summed one after another, so a column's result does
    not depend on how many columns the call holds (the block-streamed
    round's parameter slices are bitwise the whole matrix's)."""
    n = x.shape[0]
    k = min(trim_k, (n - 1) // 2)
    s = torch.sort(x, dim=0).values
    acc = s[k].to(torch.promote_types(s.dtype, torch.float32))
    for i in range(k + 1, n - k):
        acc += s[i]
    return (acc / (n - 2 * k)).to(x.dtype)


def coordinate_median(stacked_params: dict) -> dict:
    """Coordinate-wise median over the client axis."""
    return {k: median_axis0(v) for k, v in stacked_params.items()}


def trimmed_mean(stacked_params: dict, trim_k: int) -> dict:
    """Coordinate-wise trimmed mean: drop the k largest and smallest."""
    return {k: trimmed_mean_axis0(v, trim_k) for k, v in stacked_params.items()}
