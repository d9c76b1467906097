"""FedProx: FedAvg with the proximal term (mu/2)||w - w_global||^2 in the
client loss (port of fedml_tpu/algorithms/fedprox.py).

The term lives in the trainer (``ClientTrainer(prox_mu=...)``); the engine
is FedAvg's, with the round's global vector handed to local training.
"""
from __future__ import annotations

import copy

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine


class FedProxEngine(FedAvgEngine):
    program_family = "fedprox_resident"

    def __init__(self, trainer, data, cfg, device=None):
        if trainer.prox_mu <= 0.0:
            # never mutate the caller's trainer: another engine may share it
            trainer = copy.copy(trainer)
            trainer.prox_mu = cfg.prox_mu if cfg.prox_mu > 0 else 0.01
        super().__init__(trainer, data, cfg, device=device)
