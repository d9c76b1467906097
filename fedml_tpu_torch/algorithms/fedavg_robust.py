"""Byzantine-robust FedAvg (port of fedml_tpu/algorithms/fedavg_robust.py).

Reference (fedml_api/distributed/fedavg_robust/FedAvgRobustAggregator.py:
176-206 + fedml_core/robustness/robust_aggregation.py): per-client
norm-difference clipping before the weighted average, plus optional weak-DP
Gaussian noise on the aggregate; krum, multi-krum, coordinate median and
trimmed mean beside it.

``norm_clip`` aggregates through ``ops.robust_weighted_mean``: on the card,
the squared-distance and clipped-fold kernels.  Every defense sees the
model's parameters only; the collections (BatchNorm statistics) take the
plain sample-weighted mean, as in the JAX engine (fedavg_robust.py:77-79).
The noise comes from a generator the engine owns, seeded from
``cfg.seed``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.pytree import tree_weighted_mean
from fedml_tpu_torch.core.robust import (add_weak_dp_noise, coordinate_median,
                                         default_multi_krum_m, krum_select,
                                         multi_krum_select, trimmed_mean)
from fedml_tpu_torch.ops.aggregate import robust_weighted_mean
from fedml_tpu_torch.utils.device import to_device

DEFENSES = ("norm_clip", "krum", "multi_krum", "median", "trimmed_mean")


def check_defense(defense: str) -> None:
    if defense not in DEFENSES:
        raise ValueError(f"unknown defense {defense!r}; one of {DEFENSES}")


class FedAvgRobustEngine(FedAvgEngine):
    """defense: "norm_clip" (reference), "krum", "multi_krum", "median",
    "trimmed_mean".  `attack_fn` corrupts the stacked client updates
    ({name: [K, ...]}) before the defense sees them."""

    program_family = "robust_orderstat"

    def __init__(self, trainer, data, cfg, defense: str = "norm_clip",
                 n_byzantine: int = 0, multi_krum_m: Optional[int] = None,
                 attack_fn: Optional[Callable] = None, device=None):
        check_defense(defense)
        self.defense = defense
        self.n_byzantine = n_byzantine
        self.multi_krum_m = default_multi_krum_m(
            min(cfg.client_num_per_round, data.client_num), n_byzantine,
            multi_krum_m)
        self.attack_fn = attack_fn
        super().__init__(trainer, data, cfg, device=device)
        self.noise_generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def aggregate(self, stacked_variables: dict, weights: torch.Tensor,
                  global_variables: dict, server_state):
        if self.attack_fn is not None:
            stacked_variables = self.attack_fn(stacked_variables)
        params = {k: stacked_variables[k] for k in self.trainer.param_names}
        if self.defense == "norm_clip":
            new = robust_weighted_mean(params, weights, global_variables,
                                       self.cfg.norm_bound)
            if self.cfg.stddev > 0:
                new = add_weak_dp_noise(new, self.noise_generator,
                                        self.cfg.stddev)
        elif self.defense == "krum":
            i = krum_select(params, self.n_byzantine)
            new = {k: v[i] for k, v in params.items()}
        elif self.defense == "multi_krum":
            idx = multi_krum_select(params, self.n_byzantine, self.multi_krum_m)
            new = {k: v[idx].float().mean(dim=0).to(v.dtype)
                   for k, v in params.items()}
        elif self.defense == "median":
            new = coordinate_median(params)
        else:
            new = trimmed_mean(params, max(self.n_byzantine, 1))
        new.update(tree_weighted_mean(
            {k: stacked_variables[k] for k in self.trainer.stat_names},
            weights))
        return new, server_state

    def evaluate_backdoor(self, variables: dict, poison_shard: dict) -> dict:
        """Backdoor success rate on a triggered test shard (the reference's
        poisoned-testset eval, FedAvgRobustAggregator.test :14-111)."""
        sums = self.trainer.evaluate(self.trainer.flatten(variables),
                                     to_device(poison_shard, self.device))
        n = max(float(sums["count"]), 1.0)
        return {"backdoor_acc": float(sums["correct"]) / n,
                "backdoor_loss": float(sums["loss_sum"]) / n}
