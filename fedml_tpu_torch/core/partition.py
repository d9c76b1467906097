"""Non-IID dataset partitioners (port of fedml_tpu/core/partition.py;
host-side numpy, bitwise equal to the JAX package's).

Parity target: reference fedml_core/non_iid_partition/noniid_partition.py:6-103
(LDA-Dirichlet with a min-samples rebalance loop) and the `homo` /
`power-law` styles used by the dataset loaders
(e.g. cifar10/data_loader.py:125-156).  Partitioning is host-side metadata —
it produces index maps that the data layer turns into padded per-client
shards.
"""
from __future__ import annotations

import numpy as np


def partition_homo(n_samples: int, n_clients: int, seed: int = 0) -> dict[int, np.ndarray]:
    """Uniform random split ("homo" in the reference loaders)."""
    rng = np.random.RandomState(seed)
    idxs = rng.permutation(n_samples)
    return {i: np.sort(part) for i, part in enumerate(np.array_split(idxs, n_clients))}


def partition_dirichlet(
    labels: np.ndarray,
    n_clients: int,
    alpha: float,
    min_size_floor: int = 10,
    seed: int = 0,
    task: str = "classification",
) -> dict[int, np.ndarray]:
    """Latent-Dirichlet partition over class proportions.

    For each class k, draw p ~ Dir(alpha * 1_C) and split that class's sample
    indices among clients in proportion p, capping clients that already hold
    >= n/C samples (the same balancing rule as the reference's
    partition_class_samples_with_dirichlet_distribution,
    noniid_partition.py:76-91).  Re-draw until every client holds at least
    ``min_size_floor`` samples (reference's min-10 rebalance loop,
    noniid_partition.py:28-52).
    """
    labels = np.asarray(labels)
    n = labels.shape[0]
    classes = np.unique(labels)
    rng = np.random.RandomState(seed)

    # Termination fix over the reference: clamp the floor to the FEASIBLE
    # n // n_clients (the reference's ``n/C + 1`` bound cannot be met by
    # all clients simultaneously — k·(⌊n/k⌋+1) > n — so any call with
    # n < 10·n_clients would loop forever there), and relax it by 1 after
    # every 200 unlucky draws so tiny-n/small-α configs still return.
    target = max(min(min_size_floor, n // n_clients), 0)
    attempts = 0
    idx_batch: list[list[int]] = []
    while True:   # at least one draw, even when target == 0 (n < n_clients)
        attempts += 1
        if attempts % 200 == 0 and target > 0:
            target -= 1
        idx_batch = [[] for _ in range(n_clients)]
        for k in classes:
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            proportions = rng.dirichlet(np.repeat(alpha, n_clients))
            # Cap clients already at their fair share.
            proportions = np.array(
                [p * (len(b) < n / n_clients) for p, b in zip(proportions, idx_batch)]
            )
            proportions = proportions / proportions.sum()
            cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
            idx_batch = [b + part.tolist() for b, part in zip(idx_batch, np.split(idx_k, cuts))]
        min_size = min(len(b) for b in idx_batch)
        if min_size >= target:
            break

    out = {}
    for i in range(n_clients):
        rng.shuffle(idx_batch[i])
        out[i] = np.asarray(idx_batch[i], dtype=np.int64)
    return out


def partition_power_law(
    labels: np.ndarray,
    n_clients: int,
    seed: int = 0,
    a: float = 3.0,
    min_per_client: int = 10,
) -> dict[int, np.ndarray]:
    """Power-law sample-count partition (the MNIST/LEAF "power-law" style of
    benchmark/README.md:12): client sizes follow a power-law, samples drawn
    from a label-sorted pool so clients also skew by class."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    rng = np.random.RandomState(seed)
    raw = rng.power(a, n_clients) + 1e-3
    sizes = np.maximum((raw / raw.sum() * (n - min_per_client * n_clients)).astype(int)
                       + min_per_client, min_per_client)
    # Trim/extend to exactly n so every sample is assigned.
    while sizes.sum() > n:
        sizes[np.argmax(sizes)] -= 1
    while sizes.sum() < n:
        sizes[np.argmin(sizes)] += 1
    order = np.argsort(labels, kind="stable")
    out, off = {}, 0
    for i in range(n_clients):
        out[i] = np.sort(order[off:off + sizes[i]])
        off += sizes[i]
    return out


def record_data_stats(labels: np.ndarray, net_dataidx_map: dict[int, np.ndarray]) -> dict:
    """Per-client class histogram (reference noniid_partition.py:94-103)."""
    stats = {}
    for cid, idxs in net_dataidx_map.items():
        unq, cnt = np.unique(np.asarray(labels)[idxs], return_counts=True)
        stats[cid] = {int(u): int(c) for u, c in zip(unq, cnt)}
    return stats
