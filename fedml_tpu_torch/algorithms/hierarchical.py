"""Hierarchical FL — two-tier FedAvg, clients -> groups -> global (port of
fedml_tpu/algorithms/hierarchical.py).

Reference (fedml_api/standalone/hierarchical_fl/trainer.py:44-69, group.py:
24-46): each group runs `group_comm_round` inner FedAvg rounds starting from
the global model, then the global model is the sample-weighted average of
the group models.  Oracle: with full participation, a full batch and E=1
the result does not depend on the grouping (CI-script-fedavg.sh:51-59).

The JAX engine vmaps the groups and scans their inner rounds in one XLA
program; here the groups and their clients run one after another on the
engine's device.  The cohort splits into G groups of M consecutive
clients.  Every group mean and the global mean go through the fold
kernel's finalize form (``ops.weighted_mean_flat``) on the flat vectors.
"""
from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.trainer import client_generator
from fedml_tpu_torch.ops.aggregate import weighted_mean_flat


class HierarchicalFedAvgEngine(FedAvgEngine):
    def __init__(self, trainer, data, cfg, group_num: int = 2,
                 group_comm_round: int = 1, device=None):
        self.group_num = group_num
        self.group_comm_round = group_comm_round
        super().__init__(trainer, data, cfg, device=device)

    def _group(self, flat: torch.Tensor, shards: dict, round_idx: int,
               first: int):
        """`group_comm_round` FedAvg rounds inside one group of clients
        (cohort positions first..first+M-1): (group flat vector, mean over
        inner rounds of the sample-weighted loss, the group's samples)."""
        M = shards["mask"].shape[0]
        losses = []
        for r in range(self.group_comm_round):
            rows, ls, ns = [], [], []
            for i in range(M):
                gen = client_generator(self.cfg.seed,
                                       round_idx * self.group_comm_round + r,
                                       first + i, self.device)
                v, loss, n = self.trainer.local_train(
                    flat, {k: t[i] for k, t in shards.items()},
                    self.cfg.epochs, generator=gen)
                rows.append(v)
                ls.append(loss)
                ns.append(n)
            ls, ns = torch.stack(ls), torch.stack(ns)
            flat = weighted_mean_flat(torch.stack(rows), ns.float())
            losses.append((ls * ns).sum() / ns.sum())
        return flat, torch.stack(losses).mean(), ns.sum()

    def _round(self, variables: dict, server_state, cohort: dict,
               round_idx: int = 0):
        """One global round: `group_comm_round` inner rounds per group."""
        K, G = cohort["mask"].shape[0], self.group_num
        if K % G:
            raise ValueError(f"a cohort of {K} clients does not split evenly "
                             f"into {G} groups")
        M = K // G
        flat = self.trainer.flatten(variables)
        groups = [self._group(flat, {k: t[g * M:(g + 1) * M]
                                     for k, t in cohort.items()},
                              round_idx, g * M) for g in range(G)]
        flats, losses, ns = (torch.stack(t) for t in zip(*groups))
        new_flat = weighted_mean_flat(flats, ns.float())
        train_loss = (losses * ns).sum() / ns.sum()
        return (self.trainer.unflatten(new_flat), server_state,
                {"train_loss": train_loss})

    round_fn = _round
