"""Centralized (non-FL) baseline trainer (port of
fedml_tpu/algorithms/centralized.py).

Reference: fedml_api/centralized/centralized_trainer.py +
fedml_experiments/centralized/main.py.  This is one side of the
correctness oracle: FedAvg with full participation, full batch and E=1
matches this trainer's accuracy (CI-script-fedavg.sh:41-47).  One epoch is
``ClientTrainer.local_train`` over the whole padded train shard, which is
uploaded once and reused, as are the eval shards.

``mesh=`` is classic data parallelism, the reference's DDP
(centralized_trainer.py:7,39, main.py:301-377; JAX centralized.py:23-113):
every batch's sample axis is padded with zero-mask samples to a multiple
of the mesh's ranks and split over them, the parameters stay replicated,
and the trainer (a copy, with ``batch_axes`` over the whole mesh) folds
each step's gradient on the host in rank order.  Under GSPMD a plain flax
BatchNorm on a batch-sharded array normalizes by the GLOBAL batch's
statistics (XLA inserts the reduction), so here every BatchNorm layer of
the model folds its statistics over the mesh too (``utils/axes.py``'s
`batch_norm_axes`), as if each were ``sync_batch_norm`` over it.  As in
JAX, a BatchNorm model whose training batches needed padding is refused:
the zero samples would enter its statistics.  The first rank evaluates,
on the whole eval shards.  A mesh of one rank folds nothing: it is the
one-device trainer, bitwise.
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.utils import axes as mesh_axes
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device


class CentralizedTrainer:
    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, mesh=None, device=None):
        self.device = resolve_device(device)
        self.data = data
        self.cfg = cfg
        self.mesh = mesh
        self.exchange = None
        self._padded = False
        if mesh is not None:
            from fedml_tpu_torch.parallel.engine import MeshExchange
            from fedml_tpu_torch.parallel.mesh import Mesh
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh of "
                                f"ranks, got {type(mesh).__name__}")
            self.exchange = MeshExchange(mesh)
            self.axes = tuple(mesh.axis_names)
            self.n_shards = mesh.size
            self.index = mesh.index(self.axes)
            trainer = copy.copy(trainer)
            trainer.batch_axes = self.axes
        self.trainer = trainer
        self.metrics_history: list[dict] = []
        self._shard_cache: dict = {}

    def _shard(self, split: str) -> dict:
        """The global `split` shard on the device, uploaded once."""
        if split not in self._shard_cache:
            src = (self.data.train_global if split == "train"
                   else self.data.test_global)
            self._shard_cache[split] = to_device(src, self.device)
        return self._shard_cache[split]

    def _train_shard(self) -> dict:
        """The shard an epoch trains on: the global train shard, or over a
        mesh this rank's rows of every batch after the zero-mask pad."""
        if self.mesh is None:
            return self._shard("train")
        if "train_rows" not in self._shard_cache:
            shard = self.data.train_global
            bs = np.shape(shard["mask"])[1]
            pad = (-bs) % self.n_shards
            if pad:
                self._padded = True
                shard = {k: np.concatenate(
                    [np.asarray(v), np.zeros(np.shape(v)[:1] + (pad,)
                                             + np.shape(v)[2:],
                                             np.asarray(v).dtype)], axis=1)
                    for k, v in shard.items()}
            k = (bs + pad) // self.n_shards
            rows = slice(self.index * k, (self.index + 1) * k)
            self._shard_cache["train_rows"] = to_device(
                {key: np.ascontiguousarray(np.asarray(v)[:, rows])
                 for key, v in shard.items()}, self.device)
        return self._shard_cache["train_rows"]

    def _epoch(self, flat: torch.Tensor, shard: dict, ep: int):
        cfg = self.cfg
        if self.mesh is None:
            return self.trainer.local_train(
                flat, shard, 1,
                generator=client_generator(cfg.seed, ep, 0, self.device))
        split = self.n_shards > 1
        with mesh_axes.bound(self.exchange,
                             batch_norm_axes=self.axes if split else None):
            return self.trainer.local_train(
                flat, shard, 1, generator=client_generator(
                    cfg.seed, ep, 0, self.device,
                    self.index if split else None))

    def run(self, epochs: Optional[int] = None,
            variables: Optional[dict] = None) -> dict:
        cfg = self.cfg
        shard = self._train_shard()
        if self._padded and self.trainer.n_stats:
            raise ValueError(
                "mesh data-parallel centralized training with a "
                "stats-carrying model (BatchNorm) needs batch_size "
                f"divisible by the {self.n_shards} ranks (got padding)")
        if variables is None:
            variables = self.trainer.init(
                torch.Generator().manual_seed(cfg.seed), self.device)
        flat = self.trainer.flatten(variables)
        epochs = epochs if epochs is not None else cfg.comm_round
        for ep in range(epochs):
            flat, loss, _ = self._epoch(flat, shard, ep)
            if (self.mesh is None or self.mesh.is_first) and (
                    ep % cfg.frequency_of_the_test == 0 or ep == epochs - 1):
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
