"""Classical vertical FL — multi-party logistic regression over a feature
split (port of fedml_tpu/algorithms/vertical_fl.py).

Parity: fedml_api/standalone/classical_vertical_fl/ (vfl.py:1-56,
party_models.py:1-119, vfl_fixture.py) and the distributed variant
(guest_trainer.py:113-126, host_trainer.py): each party owns a disjoint
feature slice of the same samples; hosts send their logit components to
the guest, the guest adds its own component and the label loss and sends
back the common gradient; every party backprops its local extractor.

Here one backward pass gives every party's gradient.  The params are one
dict with a subtree per party (``party_p.kernel`` [d_p, hidden],
``party_p.bias``) and the guest's head (``guest_head.kernel`` [hidden, 1],
``guest_head.bias``), the JAX engine's nested dict under dotted names
(``convert.flax_to_torch`` maps one to the other); the optimizer steps
them as one flat vector, elementwise as optax steps each leaf.  The init
draws from a torch generator where JAX draws from ``jax.random``, with the
same distributions.  The batch order is ``np.random.RandomState(seed)``,
bitwise the JAX engine's.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core.trainer import (make_optimizer,
                                          sigmoid_binary_cross_entropy)
from fedml_tpu_torch.ops.aggregate import spec_of, unflatten_to_tree
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


class VFLEngine:
    """n_parties-way vertical logistic regression (binary, like the
    reference's lending-club / NUS-WIDE tasks).  Party p owns feature slice
    `feature_splits[p]` and a linear extractor x_p -> R^hidden; the guest
    (party 0) also owns the classifier over the summed party outputs."""

    def __init__(self, feature_splits: Sequence[int], cfg: FedConfig,
                 hidden: int = 16, device=None):
        self.device = resolve_device(device)
        self.splits = list(feature_splits)
        self.n_parties = len(self.splits)
        self.hidden = hidden
        self.cfg = cfg
        self.tx = make_optimizer(cfg.client_optimizer, cfg.lr, cfg.momentum,
                                 cfg.wd)
        self.metrics_history: list[dict] = []

    def init_params(self, generator: Optional[torch.Generator] = None) -> dict:
        """N(0, 1/d) party kernels, N(0, 0.01) head, zero biases; drawn on
        the CPU, then moved to the device."""
        if generator is None:
            generator = torch.Generator().manual_seed(self.cfg.seed)
        params = {}
        for p, d in enumerate(self.splits):
            params[f"party_{p}.kernel"] = (torch.randn(
                d, self.hidden, generator=generator) / math.sqrt(d))
            params[f"party_{p}.bias"] = torch.zeros(self.hidden)
        params["guest_head.kernel"] = torch.randn(
            self.hidden, 1, generator=generator) * 0.1
        params["guest_head.bias"] = torch.zeros(1)
        return {k: v.to(self.device) for k, v in params.items()}

    def _forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        # each host computes its component locally (host_trainer.py), the
        # guest sums them and applies its head (guest_trainer.py:113-126)
        comps, off = [], 0
        for p, d in enumerate(self.splits):
            comps.append(x[:, off:off + d] @ params[f"party_{p}.kernel"]
                         + params[f"party_{p}.bias"])
            off += d
        z = torch.stack(comps).sum(dim=0)
        h_k, h_b = params["guest_head.kernel"], params["guest_head.bias"]
        return (F.relu(z) @ h_k + h_b)[:, 0]

    def _loss(self, params: dict, batch: dict) -> torch.Tensor:
        ls = sigmoid_binary_cross_entropy(self._forward(params, batch["x"]),
                                          batch["y"].float())
        m = batch["mask"]
        return (ls * m).sum() / torch.clamp(m.sum(), min=1.0)

    def _train_step(self, flat, spec, opt_state, batch):
        leaf = flat.detach().requires_grad_()
        loss = self._loss(unflatten_to_tree(leaf, spec), batch)
        (grad,) = torch.autograd.grad(loss, leaf)
        updates, opt_state = self.tx.update(grad, opt_state, flat)
        return flat + updates, opt_state, loss.detach()

    def fit(self, x: np.ndarray, y: np.ndarray,
            x_test: Optional[np.ndarray] = None,
            y_test: Optional[np.ndarray] = None,
            epochs: Optional[int] = None,
            params: Optional[dict] = None) -> dict:
        """Train from `params` (default init_params()) for `epochs` (default
        cfg.comm_round) passes over (x, y) in seeded shuffled batches, the
        tail batch padded and masked."""
        cfg = self.cfg
        bs = cfg.batch_size
        params = params if params is not None else self.init_params()
        spec = spec_of(params)
        flat = torch.cat([params[k].reshape(-1).float().to(self.device)
                          for k in spec.names])
        opt_state = self.tx.init(flat)
        n = len(y)
        epochs = epochs if epochs is not None else cfg.comm_round
        rs = np.random.RandomState(cfg.seed)
        for epoch in range(epochs):
            t0 = time.time()
            order = rs.permutation(n)
            losses = []
            for i in range(0, n, bs):
                idx = order[i:i + bs]
                pad = bs - len(idx)
                mask = np.concatenate([np.ones(len(idx), np.float32),
                                       np.zeros(pad, np.float32)])
                idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                batch = {k: torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device) for k, a in (("x", x[idx]), ("y", y[idx]),
                                              ("mask", mask))}
                flat, opt_state, loss = self._train_step(flat, spec,
                                                         opt_state, batch)
                losses.append(loss)
            stats = {"epoch": epoch,
                     "train_loss": float(torch.stack(losses).mean()),
                     "epoch_time": time.time() - t0}
            params = unflatten_to_tree(flat, spec)
            if x_test is not None:
                stats["test_auc_acc"] = self.score(params, x_test, y_test)
            self.metrics_history.append(stats)
            log.info("vfl epoch %d: %s", epoch, stats)
        return unflatten_to_tree(flat, spec)

    @torch.no_grad()
    def score(self, params: dict, x, y) -> float:
        logits = self._forward(params, torch.as_tensor(x).to(self.device))
        pred = (logits > 0).long().cpu().numpy()
        return float((pred == np.asarray(y)).mean())
