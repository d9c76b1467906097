"""TurboAggregate — secure aggregation with additive masking and coded
groups (port of fedml_tpu/algorithms/turboaggregate.py).

Parity: fedml_api/distributed/turboaggregate/ (TA_Aggregator.py,
TA_decentralized_worker.py, mpc_function.py) and the standalone simulation
(fedml_api/standalone/turboaggregate/TA_trainer.py).

Clients quantize their weighted model into a prime field, split it into
additive shares (one per peer), exchange shares, and upload only sums of
shares: the server reconstructs the aggregate exactly but never sees an
individual model.  The LCC layer adds straggler-resilient coded
redundancy across client groups (mpc_function.py:111-260).

Local training runs on the engine's device, one client after another
(the clients are separate parties); the masking is host numpy on each
trained flat vector (``core/mpc.py``).  The JAX package flattens leaves
in ``jax.tree.flatten``'s (sorted-key) order, the port in its flat spec's
order; the masks cancel exactly mod p element by element, so the result
is the same per leaf whatever the order.  ``plain_mean`` is the plain
sample-weighted mean of the same rows (the fold kernel on the card): the
secure mean agrees with it to the fixed-point grid, within K * 2^-16 for
K clients.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine, stack_rows
from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.core.trainer import client_generator
from fedml_tpu_torch.ops.aggregate import weighted_mean

log = logging.getLogger(__name__)


class TurboAggregateEngine(FedAvgEngine):
    """FedAvg whose aggregation runs through secure additive masking: the
    weighted mean sum n_i w_i / sum n_i is computed on masked field
    elements, identical to fixed-point precision, with no view of any one
    w_i."""

    program_family = "turboaggregate_resident"

    def __init__(self, trainer, data, cfg, scale: int = 2 ** 16,
                 prime: int = mpc.DEFAULT_PRIME, device=None):
        super().__init__(trainer, data, cfg, device=device)
        self.scale = scale
        self.prime = prime

    def train_cohort(self, variables: dict, round_idx: int):
        """Every sampled client's local training from `variables`, each on
        its own shard: (trained flat rows, sample counts as float64
        numpy)."""
        ids = self.sampler.sample(round_idx)
        shards, _ = self.data.device_shards(self.device)
        flat = self.trainer.flatten(variables)
        rows, ns = [], []
        for k, cid in enumerate(ids):
            v, _loss, n = self.trainer.local_train(
                flat, {key: t[int(cid)] for key, t in shards.items()},
                self.cfg.epochs,
                generator=client_generator(self.cfg.seed, round_idx, k,
                                           self.device))
            rows.append(v)
            ns.append(float(n))
        return rows, np.asarray(ns)

    def secure_mean(self, rows: list, ns: np.ndarray, round_idx: int) -> dict:
        """The weighted mean of `rows` through the protocol: party i
        quantizes (n_i / sum n) w_i and splits it into K additive shares;
        party j accumulates everyone's j-th share; the server sums the K
        accumulators and dequantizes."""
        K, n = len(rows), self.trainer.spec.n
        total = ns.sum()
        accum = np.zeros((K, n), np.int64)
        for i, row in enumerate(rows):
            flat = row[:n].double().cpu().numpy()
            contrib = mpc.quantize(flat * (ns[i] / total), self.scale,
                                   self.prime)
            shares = mpc.additive_shares(contrib, K, self.prime,
                                         seed=round_idx * 997 + i)
            accum = np.mod(accum + shares, self.prime)
        masked_sums = np.mod(accum.astype(object).sum(axis=0),
                             self.prime).astype(np.int64)
        agg = mpc.dequantize(masked_sums, self.scale, self.prime)
        return self.trainer.unflatten(
            torch.from_numpy(agg.astype(np.float32)).to(self.device))

    def plain_mean(self, rows: list, ns: np.ndarray) -> dict:
        """The plain sample-weighted mean of the same rows."""
        return weighted_mean(stack_rows(self.trainer, rows),
                             torch.from_numpy(ns).float().to(self.device))

    def secure_round(self, variables: dict, round_idx: int) -> dict:
        return self.secure_mean(*self.train_cohort(variables, round_idx),
                                round_idx)

    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None) -> dict:
        cfg = self.cfg
        variables = variables if variables is not None else self.init_variables()
        rounds = rounds if rounds is not None else cfg.comm_round
        for round_idx in range(rounds):
            variables = self.secure_round(variables, round_idx)
            if (round_idx % cfg.frequency_of_the_test == 0
                    or round_idx == rounds - 1):
                stats = self.evaluate(variables)
                stats["round"] = round_idx
                self.metrics_history.append(stats)
                log.info("TA round %d: %s", round_idx, stats)
        return variables


def lcc_coded_groups(group_updates: np.ndarray, N: int, K: int, T: int = 1,
                     drop: Optional[list[int]] = None,
                     p: int = mpc.DEFAULT_PRIME) -> np.ndarray:
    """Straggler-resilient group aggregation: LCC-encode K group updates into
    N coded blocks, lose `drop` workers, decode from the survivors
    (TA_decentralized_worker.py + mpc_function.py:111-213)."""
    coded = mpc.LCC_encoding(group_updates, N, K, T, p)
    alive = [i for i in range(N) if not drop or i not in drop]
    if len(alive) < K + T:
        raise ValueError(f"too many stragglers for the code rate: {len(alive)} "
                         f"of {N} workers left, decoding needs {K + T}")
    return mpc.LCC_decoding(coded[alive[:K + T]], np.asarray(alive[:K + T]),
                            N, K, T, p)
