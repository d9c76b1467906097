"""Decentralized gossip (DSGD) over a ring of ranks: serverless FL (port of
fedml_tpu/parallel/gossip.py).

Reference: fedml_api/distributed/decentralized_framework/ (neighbour
wait-and-advance over a TopologyManager ring) and
fedml_api/standalone/decentralized/client_dsgd.py (DSGD mixing).  Every
client is a worker with its own model.  The ring is a 1-D mesh of ranks
(parallel/mesh.py): each rank owns C / n_shards contiguous workers, their
models as the rows of one [w, P] f32 matrix on its device and their
client data resident there.  A round trains every worker, then mixes

    v_i <- w_self * v_i + w_nbr * (v_{i-1} + v_{i+1})

in f32, in JAX's order: inside a rank's block the neighbours are
`torch.roll`s of the block, and the two edge rows come from the
neighbouring ranks, gathered through the host (every rank's first and
last row, picked by ring position), so the result does not depend on
timing and a ring of n ranks mixes the bits of a mesh of one.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine, stack_rows
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.parallel.engine import MeshExchange
from fedml_tpu_torch.parallel.mesh import Mesh, make_mesh
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import to_device

log = logging.getLogger(__name__)


class MeshGossipEngine(FedAvgEngine):
    """One worker model per client over a ring mesh; ring-gossip mixing
    each round.

    `self_weight` follows the reference's row-normalized symmetric ring
    (SymmetricTopologyManager.generate_topology,
    symmetric_topology_manager.py:21-52): with 2 neighbours each row is
    [w_nbr, w_self, w_nbr].  Worker i trains with
    ``client_generator(seed, round, i)``.  Only the mesh's first rank
    evaluates (the consensus model, gathered on every rank)."""

    program_family = "gossip"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, mesh: Optional[Mesh] = None,
                 self_weight: float = 1.0 / 3.0, device=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        if len(self.mesh.axis_names) != 1:
            raise ValueError("gossip requires a 1-D (ring) mesh; got axes "
                             f"{self.mesh.axis_names}")
        self.axis = self.mesh.axis_names
        self.n_shards = self.mesh.size
        self.self_weight = self_weight
        self.exchange = MeshExchange(self.mesh)
        super().__init__(trainer, data, cfg, device=device)
        self.n_workers = data.client_num
        if self.n_workers % self.n_shards:
            raise ValueError(f"{self.n_workers} workers over "
                             f"{self.n_shards} shards")
        self.w_loc = self.n_workers // self.n_shards
        self.first_worker = self.mesh.index(self.axis) * self.w_loc
        self._stack = None

    def _device_stack(self) -> tuple:
        """This rank's workers' client data and sample counts, uploaded
        once."""
        if self._stack is None:
            lo, hi = self.first_worker, self.first_worker + self.w_loc
            shards = {k: np.asarray(v)[lo:hi]
                      for k, v in self.data.client_shards.items()}
            w = np.asarray(self.data.client_num_samples, np.float32)[lo:hi]
            self._stack = (to_device(shards, self.device),
                           torch.from_numpy(w).to(self.device))
        return self._stack

    def init_worker_variables(self, generator=None,
                              variables: Optional[dict] = None):
        """[w, P] rows of this rank's workers, all the same model at init
        (`variables`, or the engine's init)."""
        v = variables if variables is not None else self.init_variables(
            generator)
        flat = self.trainer.flatten(v, torch.float32)
        return flat[None].repeat(self.w_loc, 1)

    def _gossip_round(self, rows: torch.Tensor, stack: dict,
                      stack_w: torch.Tensor, round_idx: int = 0):
        trained, losses = [], []
        for i in range(self.w_loc):
            v, loss, _ = self.trainer.local_train(
                rows[i], {k: t[i] for k, t in stack.items()},
                self.cfg.epochs,
                generator=client_generator(self.cfg.seed, round_idx,
                                           self.first_worker + i,
                                           self.device))
            trained.append(v)
            losses.append(loss)
        x = torch.stack(trained).float()
        left, right = torch.roll(x, 1, 0), torch.roll(x, -1, 0)
        if self.n_shards > 1:
            # the wrapped rows come from the ring neighbours
            edges = self.exchange.gather(
                torch.stack([x[0], x[-1]]).to("cpu").numpy(), self.axis)
            me, n = self.mesh.index(self.axis), self.n_shards
            left[0] = torch.from_numpy(edges[(me - 1) % n][1]).to(x.device)
            right[-1] = torch.from_numpy(edges[(me + 1) % n][0]).to(x.device)
        w_self = self.self_weight
        w_nbr = (1.0 - w_self) / 2.0
        mixed = (w_self * x + w_nbr * (left + right)).to(rows.dtype)
        sums = torch.stack([(torch.stack(losses) * stack_w).sum(),
                            stack_w.sum()]).to("cpu").numpy()
        loss_sum, den = torch.from_numpy(
            self.exchange.fold(sums, self.axis)).to(self.device)
        return mixed, {"train_loss": loss_sum / den}

    round_fn = _gossip_round

    def gather_workers(self, rows: torch.Tensor) -> torch.Tensor:
        """Every worker's row, [W, P] in ring order, on this rank's device
        (collective: every rank calls it)."""
        return self.exchange.gather_rows(rows, self.axis)

    def worker_variables(self, rows: torch.Tensor) -> dict:
        """Every worker's model as stacked leaves {name: [W, ...]}, the JAX
        engine's worker_vars layout (collective)."""
        return stack_rows(self.trainer, list(self.gather_workers(rows)))

    def consensus_variables(self, rows: torch.Tensor) -> dict:
        """The uniform average of all worker models, in f32 (collective)."""
        mean = self.gather_workers(rows).float().mean(dim=0)
        return self.trainer.unflatten(mean, torch.float32)

    def run(self, rounds: Optional[int] = None,
            variables: Optional[dict] = None) -> torch.Tensor:
        """`rounds` gossip rounds from `variables` (default: the engine's
        init); returns this rank's [w, P] worker rows."""
        cfg = self.cfg
        rows = self.init_worker_variables(variables=variables)
        rounds = rounds if rounds is not None else cfg.comm_round
        stack, stack_w = self._device_stack()
        for round_idx in range(rounds):
            t0 = time.time()
            with obs.span("round", round=round_idx, engine="MeshGossipEngine"):
                rows, m = self.round_fn(rows, stack, stack_w, round_idx)
            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                consensus = self.consensus_variables(rows)
                if self.mesh.is_first:
                    stats = self.evaluate(consensus)
                    stats.update(round=round_idx,
                                 train_loss=float(m["train_loss"]),
                                 round_time=time.time() - t0)
                    self.metrics_history.append(stats)
                    log.info("gossip round %d: %s", round_idx, stats)
        return rows
