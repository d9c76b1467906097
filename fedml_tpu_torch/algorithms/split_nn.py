"""SplitNN — split learning across a client/server model cut (port of
fedml_tpu/algorithms/split_nn.py).

Parity: fedml_api/distributed/split_nn/ (client.py:24-35, server.py:40-72,
SplitNNAPI.py): the client net computes activations, the server net the
logits and loss and returns the activations' gradient; clients take turns
round-robin (``active_node`` rotation, server.py:69-72).

Both halves live on the engine's device, so the cut is function
composition: one backward pass gives both halves' gradients (the
reference ships acts.grad back by hand, server.py:57-60).  The lower and
upper halves are two flat vectors (``core/flatmodel.py``), each stepped by
its own optimizer, created afresh for every client's turn as in JAX.
Every client keeps its own lower net; the server net is carried from
client to client.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.core.flatmodel import FlatModel
from fedml_tpu_torch.core.trainer import (make_optimizer, masked_accuracy_sums,
                                          masked_cross_entropy)
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device, to_device

log = logging.getLogger(__name__)


class SplitNNEngine:
    """Round-robin split training: client k trains for `epochs` with its
    lower-net params; the server's upper-net params persist and are
    trained on every client's traffic."""

    def __init__(self, client_model, server_model, data: FederatedData,
                 cfg: FedConfig, device=None):
        self.device = resolve_device(device)
        self.client = FlatModel(client_model)
        self.server = FlatModel(server_model)
        self.data = data
        self.cfg = cfg
        self.client_tx = make_optimizer(cfg.client_optimizer, cfg.lr,
                                        cfg.momentum, cfg.wd)
        self.server_tx = make_optimizer(cfg.client_optimizer, cfg.lr,
                                        cfg.momentum, cfg.wd)
        self.metrics_history: list[dict] = []

    def init_params(self, generator: Optional[torch.Generator] = None):
        """(client params, server params), {name: tensor} each."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        return (self.client.init(generator, self.device),
                self.server.init(generator, self.device))

    def _loss(self, cp: torch.Tensor, sp: torch.Tensor, batch: dict):
        # the forward crosses the cut: acts = f_client(x), logits =
        # f_server(acts) (client.py:24-31 'forward_pass', server.py:40-55)
        logits = self.server(sp, self.client(cp, batch["x"]))
        return masked_cross_entropy(logits, batch["y"], batch["mask"])

    def _client_phase(self, cp: torch.Tensor, sp: torch.Tensor, shard: dict):
        """One client's `epochs` over its shard, both halves stepped per
        batch (an all-padding batch leaves both and their optimizer states
        as they were): (client vector, server vector, mean loss)."""
        c_opt, s_opt = self.client_tx.init(cp), self.server_tx.init(sp)
        epoch_losses = []
        for _ in range(self.cfg.epochs):
            losses = []
            for b in range(shard["mask"].shape[0]):
                batch = {k: v[b] for k, v in shard.items()}
                c_leaf = cp.detach().requires_grad_()
                s_leaf = sp.detach().requires_grad_()
                loss = self._loss(c_leaf, s_leaf, batch)
                cg, sg = torch.autograd.grad(loss, (c_leaf, s_leaf))
                has = batch["mask"].sum() > 0
                cu, c_new = self.client_tx.update(cg, c_opt, cp)
                su, s_new = self.server_tx.update(sg, s_opt, sp)
                cp = torch.where(has, cp + cu, cp)
                sp = torch.where(has, sp + su, sp)
                c_opt = self.client_tx.select(has, c_new, c_opt)
                s_opt = self.server_tx.select(has, s_new, s_opt)
                losses.append(loss.detach())
            epoch_losses.append(torch.stack(losses).mean())
        return cp, sp, torch.stack(epoch_losses).mean()

    def run(self, rounds: Optional[int] = None, params=None):
        """Returns (every client's lower-net params, the server's params);
        `params` (client, server) overrides init_params()."""
        cfg = self.cfg
        cp0, sp0 = params if params is not None else self.init_params()
        # every client keeps its own lower-net weights (not averaged: split
        # learning semantics, unlike FedAvg)
        per_client = [self.client.flatten(cp0)] * self.data.client_num
        sp = self.server.flatten(sp0)
        shards, _ = self.data.device_shards(self.device)
        rounds = rounds if rounds is not None else cfg.comm_round
        for round_idx in range(rounds):
            t0 = time.time()
            losses = []
            for cid in range(self.data.client_num):   # active_node rotation
                per_client[cid], sp, loss = self._client_phase(
                    per_client[cid], sp, {k: v[cid] for k, v in shards.items()})
                losses.append(float(loss))
            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                stats = self.evaluate(self.client.unflatten(per_client[0]),
                                      self.server.unflatten(sp))
                stats.update(round=round_idx,
                             train_loss=float(np.mean(losses)),
                             round_time=time.time() - t0)
                self.metrics_history.append(stats)
                log.info("splitnn round %d: %s", round_idx, stats)
        return ([self.client.unflatten(v) for v in per_client],
                self.server.unflatten(sp))

    @torch.no_grad()
    def evaluate(self, client_params: dict, server_params: dict) -> dict:
        shard = to_device(self.data.test_global, self.device)
        cp = self.client.flatten(client_params)
        sp = self.server.flatten(server_params)
        correct = count = 0.0
        for b in range(shard["mask"].shape[0]):
            logits = self.server(sp, self.client(cp, shard["x"][b]))
            c, n = masked_accuracy_sums(logits, shard["y"][b], shard["mask"][b])
            correct, count = correct + c, count + n
        return {"test_acc": float(correct) / max(float(count), 1.0)}
