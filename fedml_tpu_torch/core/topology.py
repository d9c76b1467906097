"""Topology managers for decentralized algorithms (port of
fedml_tpu/core/topology.py; host-side numpy, bitwise equal to the JAX
package's).

Parity with reference fedml_core/distributed/topology/: symmetric
(ring + Watts-Strogatz rewiring, row-normalized weights,
symmetric_topology_manager.py:21-52) and asymmetric (directed, random link
deletion, asymmetric_topology_manager.py:23-100).  The adjacency matrix
doubles as the gossip mixing matrix consumed by the decentralized engine
(neighbor exchange = a matmul over the client axis).
"""
from __future__ import annotations

import numpy as np


class BaseTopologyManager:
    topology: np.ndarray  # [n, n] row-normalized mixing weights

    def get_in_neighbor_idx_list(self, node_index: int) -> list[int]:
        col = self.topology[:, node_index]
        return [i for i in range(len(col)) if col[i] != 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> list[int]:
        row = self.topology[node_index]
        return [i for i in range(len(row)) if row[i] != 0 and i != node_index]

    def get_in_neighbor_weights(self, node_index: int) -> np.ndarray:
        return self.topology[:, node_index]

    def get_out_neighbor_weights(self, node_index: int) -> np.ndarray:
        return self.topology[node_index]

    def mixing_matrix(self) -> np.ndarray:
        return self.topology


class SymmetricTopologyManager(BaseTopologyManager):
    """Undirected ring with `neighbor_num` extra Watts-Strogatz style links,
    symmetrized, rows normalized to sum to 1."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = n
        self.neighbor_num = min(neighbor_num, n - 1)
        self.seed = seed
        self.topology = np.zeros((n, n))
        self.generate_topology()

    def generate_topology(self):
        n, k = self.n, self.neighbor_num
        rng = np.random.RandomState(self.seed)
        adj = np.eye(n)
        # ring base
        for i in range(n):
            adj[i, (i + 1) % n] = 1
            adj[i, (i - 1) % n] = 1
        # extra random links per node (Watts-Strogatz flavored rewiring)
        extra = max(0, k - 2)
        for i in range(n):
            choices = [j for j in range(n) if j != i and adj[i, j] == 0]
            rng.shuffle(choices)
            for j in choices[:extra]:
                adj[i, j] = 1
        adj = np.maximum(adj, adj.T)  # symmetrize
        self.topology = adj / adj.sum(axis=1, keepdims=True)


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed variant: start from the symmetric graph, randomly delete
    out-links (keeping the ring connected), renormalize rows."""

    def __init__(self, n: int, neighbor_num: int = 3, deleted_ratio: float = 0.3,
                 seed: int = 0):
        self.n = n
        self.neighbor_num = neighbor_num
        self.deleted_ratio = deleted_ratio
        self.seed = seed
        self.topology = np.zeros((n, n))
        self.generate_topology()

    def generate_topology(self):
        base = SymmetricTopologyManager(self.n, self.neighbor_num, self.seed)
        adj = (base.topology > 0).astype(float)
        rng = np.random.RandomState(self.seed + 1)
        for i in range(self.n):
            for j in range(self.n):
                ring = j in ((i + 1) % self.n, (i - 1) % self.n, i)
                if adj[i, j] and not ring and rng.rand() < self.deleted_ratio:
                    adj[i, j] = 0
        self.topology = adj / adj.sum(axis=1, keepdims=True)
