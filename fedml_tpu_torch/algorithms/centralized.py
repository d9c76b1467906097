"""Centralized (non-FL) baseline trainer (port of
fedml_tpu/algorithms/centralized.py).

Reference: fedml_api/centralized/centralized_trainer.py +
fedml_experiments/centralized/main.py.  This is one side of the
correctness oracle: FedAvg with full participation, full batch and E=1
matches this trainer's accuracy (CI-script-fedavg.sh:41-47).  One epoch is
``ClientTrainer.local_train`` over the whole padded train shard, which is
uploaded once and reused, as are the eval shards.

The JAX trainer's ``mesh=`` (classic data parallelism, the reference's
DDP) is slice 6 of the port and raises here.
"""
from __future__ import annotations

from typing import Optional

import torch

from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device


class CentralizedTrainer:
    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "CentralizedTrainer(mesh=...), data parallelism over a "
                "device mesh, is slice 6 of the port")
        self.device = resolve_device(device)
        self.trainer = trainer
        self.data = data
        self.cfg = cfg
        self.metrics_history: list[dict] = []
        self._shard_cache: dict = {}

    def _shard(self, split: str) -> dict:
        """The global `split` shard on the device, uploaded once."""
        if split not in self._shard_cache:
            src = (self.data.train_global if split == "train"
                   else self.data.test_global)
            self._shard_cache[split] = to_device(src, self.device)
        return self._shard_cache[split]

    def run(self, epochs: Optional[int] = None,
            variables: Optional[dict] = None) -> dict:
        cfg = self.cfg
        shard = self._shard("train")
        if variables is None:
            variables = self.trainer.init(
                torch.Generator().manual_seed(cfg.seed), self.device)
        flat = self.trainer.flatten(variables)
        epochs = epochs if epochs is not None else cfg.comm_round
        for ep in range(epochs):
            flat, loss, _ = self.trainer.local_train(
                flat, shard, 1,
                generator=client_generator(cfg.seed, ep, 0, self.device))
            if ep % cfg.frequency_of_the_test == 0 or ep == epochs - 1:
                stats = self.evaluate(self.trainer.unflatten(flat))
                stats.update(epoch=ep, train_loss=float(loss))
                self.metrics_history.append(stats)
        return self.trainer.unflatten(flat)

    def evaluate(self, variables: dict) -> dict:
        flat = self.trainer.flatten(variables)
        out = {}
        for split in ("train", "test"):
            sums = self.trainer.evaluate(flat, self._shard(split))
            cnt = max(float(sums["count"]), 1.0)
            out[f"{split}_acc"] = float(sums["correct"]) / cnt
            out[f"{split}_loss"] = float(sums["loss_sum"]) / cnt
        return out
