"""Decentralized gossip learning, server-less (port of
fedml_tpu/algorithms/decentralized.py).

Reference: fedml_api/distributed/decentralized_framework/ (neighbour
round-robin skeleton) and fedml_api/standalone/decentralized/ (DSGD and
push-sum over a TopologyManager graph for online regret minimization).

Every client keeps its own model: the engine holds all of them as the rows
of one [C, P] matrix of flat vectors.  One round is local SGD for every
client (one after another here, a vmap in JAX) followed by the gossip
mixing step W x, W the topology's row-normalized mixing matrix: one
[C, C] x [C, P] matrix product (``torch.matmul``; XLA's dot in JAX), in
place of C point-to-point messages.  Push-sum (directed graphs) carries
a scalar weight per client beside its row: a round de-biases (x / w),
trains, re-biases (x * w), then mixes rows and weights alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from fedml_tpu_torch.algorithms.fedavg import stack_rows
from fedml_tpu_torch.core.topology import BaseTopologyManager
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device


def debias(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Push-sum's de-bias z = x / w, row by row."""
    return stacked / weights[:, None]


def rebias(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Push-sum's re-bias x = z * w, row by row."""
    return stacked * weights[:, None]


class DecentralizedGossipEngine:
    """DSGD (symmetric W) or push-sum (asymmetric, directed W)."""

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, topology: BaseTopologyManager,
                 push_sum: bool = False, device=None):
        self.device = resolve_device(device)
        self.trainer = trainer
        self.data = data
        self.cfg = cfg
        self.W = torch.as_tensor(topology.mixing_matrix(),
                                 dtype=torch.float32).to(self.device)
        self.push_sum = push_sum
        self._test_shard = to_device(data.test_global, self.device)
        self.metrics_history: list[dict] = []

    def init_states(self, generator: Optional[torch.Generator] = None):
        """Every client at the same fresh model: ([C, P] rows, push-sum
        weights [C], all ones)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        flat = self.trainer.flatten(self.trainer.init(generator, self.device))
        C = self.data.client_num
        return (flat[None].repeat(C, 1),
                torch.ones(C, dtype=torch.float32, device=self.device))

    def _mix(self, stacked: torch.Tensor, weights: torch.Tensor):
        return self.W @ stacked, self.W @ weights

    def _round(self, stacked: torch.Tensor, weights: torch.Tensor,
               cohort: dict, round_idx: int = 0):
        rows = debias(stacked, weights) if self.push_sum else stacked
        new, losses, ns = [], [], []
        for i in range(rows.shape[0]):
            v, loss, n = self.trainer.local_train(
                rows[i], {k: t[i] for k, t in cohort.items()},
                self.cfg.epochs,
                generator=client_generator(self.cfg.seed, round_idx, i,
                                           self.device))
            new.append(v)
            losses.append(loss)
            ns.append(n)
        new = torch.stack(new)
        if self.push_sum:
            new = rebias(new, weights)
        mixed, new_weights = self._mix(new, weights)
        losses, ns = torch.stack(losses), torch.stack(ns)
        return mixed, new_weights, {"train_loss": (losses * ns).sum() / ns.sum()}

    round_fn = _round

    def run(self, rounds: Optional[int] = None):
        """Returns ({name: [C, ...]} every client's model, weights [C])."""
        stacked, weights = self.init_states()
        cohort, _ = self.data.device_shards(self.device)
        rounds = rounds if rounds is not None else self.cfg.comm_round
        for round_idx in range(rounds):
            stacked, weights, m = self.round_fn(stacked, weights, cohort,
                                                round_idx)
            if (round_idx % self.cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                stats = self.evaluate(stacked, weights)
                stats.update(round=round_idx, train_loss=float(m["train_loss"]))
                self.metrics_history.append(stats)
        return stack_rows(self.trainer, list(stacked)), weights

    def evaluate(self, stacked: torch.Tensor, weights: torch.Tensor) -> dict:
        """Evaluate the consensus model: the mean of the (for push-sum,
        de-biased) rows."""
        if self.push_sum:
            stacked = debias(stacked, weights)
        sums = self.trainer.evaluate(stacked.mean(dim=0), self._test_shard)
        cnt = max(float(sums["count"]), 1.0)
        return {"test_acc": float(sums["correct"]) / cnt,
                "test_loss": float(sums["loss_sum"]) / cnt}
