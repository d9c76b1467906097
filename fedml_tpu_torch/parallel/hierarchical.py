"""Hierarchical FL on a (silo x clients) mesh of ranks (port of
fedml_tpu/parallel/hierarchical.py).

Reference: fedml_api/standalone/hierarchical_fl/{trainer,group,client}.py:
clients -> groups run `group_comm_round` inner FedAvg rounds, groups ->
global average every global round (trainer.py:44-69, group.py:24-46).

The two aggregation tiers map onto the two mesh axes (parallel/mesh.py:
one process a device, joined by torch.distributed):

    inner round:  each rank's chunk-loop sums, gathered over its silo's
                  "clients" group and folded in rank order -> the silo model
    outer round:  each silo's model weighted by W_g, gathered over the
                  "silo" group and folded in silo order -> the global model

Every rank of a silo folds the same partials in the same order, so a
silo's ranks hold one silo model bit for bit; every column of the grid
then folds one model per silo in silo order, so every rank commits the
same bits.  The floats cross ranks through the host (mesh.py), never an
all-reduce.

Invariant kept from the reference CI (CI-script-fedavg.sh:51-59): with
full batch, E=1, full participation and one inner round, the result
equals plain FedAvg whatever the client -> silo grouping, because
sum_g (W_g/W) * (sum_i w_i v_i / W_g) = sum_i (w_i/W) v_i.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.parallel.engine import (MeshExchange, cast_local,
                                             chunked_weighted_train,
                                             default_chunk)
from fedml_tpu_torch.parallel.mesh import (CLIENT_AXIS, SILO_AXIS, Mesh,
                                           make_mesh_2d)
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import to_device

log = logging.getLogger(__name__)


class MeshHierarchicalEngine(FedAvgEngine):
    """Two-tier FedAvg over a (silo, clients) mesh.

    Clients are assigned to silos contiguously: silo g owns client ids
    [g*C/S, (g+1)*C/S), held on each of its ranks' devices.  Each global
    round runs `group_comm_round` inner rounds; inner cohorts are sampled
    per silo with the reference's seeded numpy semantics
    (`sample_inner_rounds`, bitwise the JAX engine's draws), and rank c
    of a silo trains its contiguous share of the silo's cohort.  Inner
    round i of global round t trains lane j of silo s's padded cohort
    with ``client_generator(seed, t * group_comm_round + i, s * K_pad +
    j)``, whatever the mesh.
    Only the mesh's first rank evaluates."""

    program_family = "hierarchical"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, n_silos: int = 2,
                 group_comm_round: int = 1, mesh: Optional[Mesh] = None,
                 chunk: Optional[int] = None, local_dtype=None,
                 device=None):
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk if chunk is not None else default_chunk(
            local_dtype)
        self.local_dtype = local_dtype
        self.mesh = mesh if mesh is not None else make_mesh_2d(n_silos)
        if self.mesh.axis_names != (SILO_AXIS, CLIENT_AXIS):
            raise ValueError(f"the hierarchical engine needs a (silo, "
                             f"clients) mesh, got {self.mesh.axis_names}")
        self.n_silos = self.mesh.shape[SILO_AXIS]
        self.per_silo_shards = self.mesh.shape[CLIENT_AXIS]
        self.group_comm_round = group_comm_round
        self.exchange = MeshExchange(self.mesh)
        super().__init__(trainer, data, cfg, device=device)
        C = data.client_num
        if C % self.n_silos:
            raise ValueError(f"{C} clients cannot split into "
                             f"{self.n_silos} silos")
        self.clients_per_silo = C // self.n_silos
        self._stack = None

    # -- data: this rank's silo, resident on its device ----------------------
    def _device_stack(self) -> tuple:
        """The clients of this rank's silo ({x, y, mask} [C/S, ...]) and
        their sample counts, uploaded once."""
        if self._stack is None:
            cs = self.clients_per_silo
            lo = self.mesh.coords[SILO_AXIS] * cs
            shards = {k: np.asarray(v)[lo:lo + cs]
                      for k, v in self.data.client_shards.items()}
            w = np.asarray(self.data.client_num_samples,
                           np.float32)[lo:lo + cs]
            self._stack = (to_device(shards, self.device),
                           torch.from_numpy(w).to(self.device))
        return self._stack

    # -- sampling: per-silo cohort ids for every inner round -----------------
    def sample_inner_rounds(self, global_round: int) -> tuple:
        """ids[g_round, silo, K_pad] (silo-local indices) and a wmask like
        it, K padded to a multiple of the client-axis size (pad lanes are
        silo client 0 with weight 0).  Reference seed discipline: one
        RandomState(round) per sampling call (group.py, fedavg_api.py:
        83-91)."""
        K = min(self.cfg.client_num_per_round, self.clients_per_silo)
        Kp = K + ((-K) % self.per_silo_shards)
        G = self.group_comm_round
        ids = np.zeros((G, self.n_silos, Kp), np.int32)
        wmask = np.zeros((G, self.n_silos, Kp), np.float32)
        for g in range(G):
            rs = np.random.RandomState(global_round * self.group_comm_round
                                       + g)
            for s in range(self.n_silos):
                if K == self.clients_per_silo:
                    pick = np.arange(K)
                else:
                    pick = rs.choice(self.clients_per_silo, K, replace=False)
                ids[g, s, :K] = pick
                wmask[g, s, :K] = 1.0
        return ids, wmask

    # -- the global round ----------------------------------------------------
    def _silo_sums(self, vars_g: dict, ids: np.ndarray, wmask: np.ndarray,
                   round_idx: int) -> tuple:
        """One inner round: this rank's share of its silo's cohort trained
        from the silo model, then the silo's folded (sum w*v, sum w,
        sum w*loss)."""
        s, c = self.mesh.coords[SILO_AXIS], self.mesh.coords[CLIENT_AXIS]
        stack, stack_w = self._device_stack()
        k_loc = ids.shape[0] // self.per_silo_shards
        rows = slice(c * k_loc, (c + 1) * k_loc)
        idx = torch.as_tensor(ids[rows], dtype=torch.long,
                              device=self.device)
        cohort = {k: v.index_select(0, idx) for k, v in stack.items()}
        weights = stack_w.index_select(0, idx) * torch.from_numpy(
            np.ascontiguousarray(wmask[rows])).to(self.device)
        flat = self.trainer.flatten(cast_local(vars_g, self.local_dtype))
        sums = chunked_weighted_train(
            self.trainer, flat, cohort, weights, self.cfg.epochs,
            chunk_cap=self.chunk, seed=self.cfg.seed, round_idx=round_idx,
            lane0=s * ids.shape[0] + c * k_loc)
        return self.exchange.fold_sums(self.trainer, sums, (CLIENT_AXIS,),
                                       self.device)

    def _global_round(self, variables: dict, server_state, ids: np.ndarray,
                      wmask: np.ndarray, round_idx: int = 0):
        """`group_comm_round` inner rounds on every silo, then the
        cross-silo average weighted by each silo's last-round W_g."""
        s = self.mesh.coords[SILO_AXIS]
        G = self.group_comm_round
        trainer = self.trainer
        vars_g = variables
        for g in range(G):
            num, den, lsum = self._silo_sums(vars_g, ids[g, s], wmask[g, s],
                                             round_idx * G + g)
            avg = trainer.unflatten(num / den, torch.float32)
            vars_g = {k: v.to(vars_g[k].dtype) for k, v in avg.items()}
            loss = lsum / den
        # outer tier: the sample-weighted cross-silo average
        W_g = den
        num, W, lw = self.exchange.fold_sums(
            trainer, (trainer.flatten(vars_g, torch.float32) * W_g, W_g,
                      loss * W_g), (SILO_AXIS,), self.device)
        new = trainer.unflatten(num / W, torch.float32)
        return ({k: v.to(variables[k].dtype) for k, v in new.items()},
                server_state, {"train_loss": lw / W})

    round_fn = _global_round

    def _round_args(self, round_idx: int) -> tuple:
        return (*self.sample_inner_rounds(round_idx), round_idx)
