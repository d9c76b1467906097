"""FedOpt: a server optimizer applied to the pseudo-gradient (port of
fedml_tpu/algorithms/fedopt.py).

Reference (fedml_api/distributed/fedopt/FedOptAggregator.py:70-123): average
the client models, form the pseudo-gradient g = w_global - w_avg, and step
a server optimizer whose state persists across rounds.

The JAX package's server optimizers are optax's, and optax's are not
torch.optim's, so each is written out here as the same tensor updates over
``{name: tensor}`` dicts:

* sgd / FedAvgM: ``optax.sgd(lr, momentum)``: t = g + m * t, u = -lr * t.
* adam: ``optax.adam(lr, b1=0.9, b2=0.99, eps=1e-3)``, eps outside the root.
* yogi: ``optax.yogi(lr)``: b1 0.9, b2 0.999, eps 1e-3, both moments
  starting at 1e-6 (torch has no Yogi).
* adagrad: ``optax.adagrad(lr)``: the accumulator starts at 0.1 and the
  step is g * rsqrt(acc + 1e-7), eps inside the root
  (``torch.optim.Adagrad`` starts at 0 with eps outside).

optax ADDS its updates, so u = -lr * (...) of g = w_global - w_avg moves the
model toward the client average.
"""
from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.pytree import tree_add, tree_sub
from fedml_tpu_torch.ops.aggregate import weighted_mean


def _bias_correction(decay: float, count: int) -> float:
    return 1.0 - decay ** count


class SGD:
    """optax.sgd: u = -lr * g, or with momentum the trace t = g + m * t."""

    def __init__(self, lr: float, momentum: float | None = None):
        self.lr, self.momentum = lr, momentum

    def init(self, params: dict) -> dict:
        if not self.momentum:
            return {}
        return {"trace": {k: torch.zeros_like(v) for k, v in params.items()}}

    def update(self, grads: dict, state: dict, params: dict = None):
        if self.momentum:
            grads = {k: g + self.momentum * state["trace"][k]
                     for k, g in grads.items()}
            state = {"trace": grads}
        return {k: -self.lr * g for k, g in grads.items()}, state


class Adam:
    """optax.adam (eps_root 0): bias-corrected moments, m / (sqrt(v) + eps)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.initial = 0.0

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {k: torch.full_like(v, self.initial)
                       for k, v in params.items()},
                "nu": {k: torch.full_like(v, self.initial)
                       for k, v in params.items()}}

    def _second_moment(self, g: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
        return (1 - self.b2) * (g * g) + self.b2 * nu

    def update(self, grads: dict, state: dict, params: dict = None):
        count = state["count"] + 1
        mu = {k: (1 - self.b1) * g + self.b1 * state["mu"][k]
              for k, g in grads.items()}
        nu = {k: self._second_moment(g, state["nu"][k])
              for k, g in grads.items()}
        c1 = _bias_correction(self.b1, count)
        c2 = _bias_correction(self.b2, count)
        updates = {k: -self.lr * ((mu[k] / c1)
                                  / (torch.sqrt(nu[k] / c2) + self.eps))
                   for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}


class Yogi(Adam):
    """optax.yogi: Adam's first moment; v = v - (1 - b2) * sign(v - g^2)
    * g^2; both moments start at 1e-6."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-3):
        super().__init__(lr, b1, b2, eps)
        self.initial = 1e-6

    def _second_moment(self, g: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
        g2 = g * g
        return nu - (1 - self.b2) * torch.sign(nu - g2) * g2


class Adagrad:
    """optax.adagrad: acc += g^2 from 0.1; u = -lr * g * rsqrt(acc + eps)
    (0 where acc is 0)."""

    def __init__(self, lr: float, initial: float = 0.1, eps: float = 1e-7):
        self.lr, self.initial, self.eps = lr, initial, eps

    def init(self, params: dict) -> dict:
        return {"sum_of_squares": {k: torch.full_like(v, self.initial)
                                   for k, v in params.items()}}

    def update(self, grads: dict, state: dict, params: dict = None):
        acc = {k: g * g + state["sum_of_squares"][k] for k, g in grads.items()}
        updates = {}
        for k, g in grads.items():
            inv = torch.where(acc[k] > 0, torch.rsqrt(acc[k] + self.eps),
                              torch.zeros_like(acc[k]))
            updates[k] = -self.lr * (inv * g)
        return updates, {"sum_of_squares": acc}


def make_server_optimizer(name: str, lr: float, momentum: float = 0.9):
    name = name.lower()
    if name in ("sgd", "fedavgm"):
        return SGD(lr, momentum if momentum else None)
    if name in ("adam", "fedadam"):
        return Adam(lr, b1=0.9, b2=0.99, eps=1e-3)
    if name in ("yogi", "fedyogi"):
        return Yogi(lr)
    if name in ("adagrad", "fedadagrad"):
        return Adagrad(lr)
    raise ValueError(f"unknown server optimizer {name!r}")


def server_step(tx, avg: dict, global_variables: dict, server_state,
                param_names):
    """One server-optimizer step on the parameters' pseudo-gradient
    w_global - w_avg; the collections (BatchNorm statistics) take the
    average (fedopt.py:54-59).  Returns (new variables, new optimizer
    state)."""
    params = lambda tree: {k: tree[k] for k in param_names}
    g = params(global_variables)
    updates, server_state = tx.update(tree_sub(g, params(avg)), server_state,
                                      g)
    return {**avg, **tree_add(g, updates)}, server_state


class FedOptEngine(FedAvgEngine):
    """FedAvg whose server applies `cfg.server_optimizer` to the
    pseudo-gradient; the optimizer state is the round's server_state."""

    def __init__(self, trainer, data, cfg, device=None):
        self.server_tx = make_server_optimizer(
            cfg.server_optimizer, cfg.server_lr, cfg.server_momentum)
        super().__init__(trainer, data, cfg, device=device)

    def server_init(self, variables: dict):
        return self.server_tx.init({k: variables[k]
                                    for k in self.trainer.param_names})

    def aggregate(self, stacked_variables: dict, weights: torch.Tensor,
                  global_variables: dict, server_state):
        return server_step(self.server_tx,
                           weighted_mean(stacked_variables, weights),
                           global_variables, server_state,
                           self.trainer.param_names)
