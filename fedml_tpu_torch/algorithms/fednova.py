"""FedNova: normalized averaging (port of fedml_tpu/algorithms/fednova.py).

Reference (fedml_api/standalone/fednova/fednova.py:50-200): client i runs
tau_i local steps; the server averages the normalized directions
d = sum_i p_i (w_global - w_i) / tau_i with data weights p_i and installs
w_new = w_global - tau_eff * d, tau_eff = sum_i p_i tau_i.

Written as w_new = g + sum_i cf_i (w_i - g) with cf_i = p_i tau_eff /
max(tau_i, 1), this is the clipped fold's in-place form
(``ops.aggregate.shift_toward``), so on the card it runs through that
kernel.  It applies to the parameters; the collections (BatchNorm
statistics) take the plain p-weighted mean (fednova.py:62-69).
"""
from __future__ import annotations

import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.ops.aggregate import shift_toward


def fednova_tau(shard: dict, epochs: int) -> torch.Tensor:
    """tau = local steps that saw real data: non-empty batches x epochs.
    ``shard["mask"]`` is one client's [B, bs], or [..., B, bs] for a stack
    of clients (one tau each)."""
    counts = shard["mask"].sum(dim=-1)
    return (counts > 0).to(torch.float32).sum(dim=-1) * epochs


class FedNovaEngine(FedAvgEngine):
    program_family = "fednova_resident"

    def _round(self, variables: dict, server_state, cohort: dict,
               round_idx: int = 0):
        g = self.trainer.flatten(variables, torch.float32)
        rows, losses, ns = self._train_cohort(g, cohort, round_idx)
        rows = torch.stack(rows).float()
        taus = fednova_tau(cohort, self.cfg.epochs)
        p = ns / ns.sum()
        tau_eff = (p * taus).sum()
        r = self.trainer.train_len
        # g is a fresh buffer that training only read: update it in place
        shift_toward(g[:r], rows[:, :r],
                     (p * tau_eff / torch.clamp(taus, min=1.0)).contiguous())
        g[r:] = (p[:, None] * rows[:, r:]).sum(dim=0)
        new_variables = {k: v.to(variables[k].dtype)
                         for k, v in self.trainer.unflatten(g).items()}
        train_loss = (losses * ns).sum() / ns.sum()
        return new_variables, server_state, {"train_loss": train_loss}

    round_fn = _round
