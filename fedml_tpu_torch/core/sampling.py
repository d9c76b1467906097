"""Deterministic per-round client sampling (port of fedml_tpu/core/sampling.py).

Reproduces the reference's sampling semantics exactly
(FedAVGAggregator.client_sampling, reference
fedml_api/distributed/fedavg/FedAVGAggregator.py:90-98):
``np.random.seed(round_idx); np.random.choice(range(N), k, replace=False)``.
This is host-side numpy, bitwise equal to the JAX package's sampler.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)


class ClientSampler:
    """Seeded-by-round sampler with the reference's numpy semantics."""

    def __init__(self, client_num_in_total: int, client_num_per_round: int):
        self.client_num_in_total = client_num_in_total
        self.client_num_per_round = client_num_per_round

    @classmethod
    def for_data(cls, data, cfg) -> "ClientSampler":
        """Sampler over the clients the DATA actually has (which can differ
        from cfg.client_num_in_total for real-file loaders): sampling cfg's
        range would gather out-of-range ids."""
        n_total = data.client_num
        if n_total != cfg.client_num_in_total:
            log.warning("dataset has %d clients but client_num_in_total=%d; "
                        "sampling over the dataset's %d",
                        n_total, cfg.client_num_in_total, n_total)
        return cls(n_total, cfg.client_num_per_round)

    def sample(self, round_idx: int) -> np.ndarray:
        # >= (not ==): per_round beyond the population is full participation
        if self.client_num_per_round >= self.client_num_in_total:
            return np.arange(self.client_num_in_total, dtype=np.int64)
        num = min(self.client_num_per_round, self.client_num_in_total)
        np.random.seed(round_idx)  # deterministic, matches reference
        return np.asarray(
            np.random.choice(range(self.client_num_in_total), num, replace=False),
            dtype=np.int64,
        )

    def sample_fast(self, round_idx: int,
                    k: Optional[int] = None) -> np.ndarray:
        """Bitwise-equal twin of `sample` that does not reseed the global
        numpy RNG: a private ``RandomState(r)`` walks the same Mersenne
        Twister stream, and ``choice(N, ...)`` indexes the same permutation
        as the ``range(N)`` path.  `k` overrides the cohort size."""
        k = self.client_num_per_round if k is None else int(k)
        if k >= self.client_num_in_total:
            return np.arange(self.client_num_in_total, dtype=np.int64)
        rs = np.random.RandomState(round_idx)
        return np.asarray(
            rs.choice(self.client_num_in_total, k, replace=False),
            dtype=np.int64,
        )
