"""On-demand client-shard stores: cohort stacks without the all-client
stack (port of fedml_tpu/scale/shardstore.py).

`FederatedData` keeps every client's padded shard in one stacked array
set ([C, B, bs, ...]) in host memory, the right layout up to a few
hundred thousand clients and a dead end at millions: the stack is built
and held for clients that may never be sampled.  A ShardStore inverts
that: client shards materialize on demand, per cohort, so host memory is
O(cohort * shard) plus a bounded reuse cache.

Every store speaks the cohort contract

    cohort(ids) -> ({x, y, mask} stacked [K, B, bs, ...], weights [K])

with tensors on the store's device (the card unless the caller names
another), so the async scheduler and anything else that gathers cohorts
takes any of them, and `prefetcher()` wraps the double buffer
(parallel/prefetch.py) around a store so cohort k+1 builds and uploads
while the card trains on k.  The shards themselves are host numpy,
bitwise the JAX package's.

Backends:

    MaterializedShardStore   adapter over an existing FederatedData, the
                             oracle the others are held against.
    MmapShardStore           the stacked arrays live in .npy files opened
                             memory-mapped: a cohort gather touches only
                             the cohort's pages (`build` writes them, in
                             the JAX package's layout: its directories
                             open here too).
    GeneratorShardStore      shards synthesized per client id by a seeded
                             factory, deterministic per (seed, client); no
                             population-sized array ever exists.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.parallel.prefetch import Prefetcher, upload
from fedml_tpu_torch.utils.device import resolve_device


class ShardStore:
    """Base: per-client fetch, a bounded LRU reuse cache and cohort
    stacking.  Subclasses implement `_fetch(cid) -> {x, y, mask}` (host
    numpy, one client's [B, bs, ...] arrays) and `_weight(cid)`."""

    def __init__(self, n_clients: int, cache_clients: int = 0, device=None):
        self.n_clients = int(n_clients)
        self.cache_clients = int(cache_clients)
        self.device = resolve_device(device)
        self._cache: "OrderedDict[int, dict]" = OrderedDict()
        self._m_hits = obs.counter("shardstore_cache_hits_total")
        self._m_miss = obs.counter("shardstore_cache_misses_total")

    # -- subclass surface ----------------------------------------------------
    def _fetch(self, cid: int) -> dict:
        raise NotImplementedError

    def _weight(self, cid: int) -> float:
        raise NotImplementedError

    # -- the cohort contract -------------------------------------------------
    def client_shard(self, cid: int) -> dict:
        """One client's {x, y, mask} (host numpy), through the cache."""
        if not 0 <= cid < self.n_clients:
            raise IndexError(f"client id {cid} out of range "
                             f"[0, {self.n_clients})")
        if self.cache_clients > 0:
            hit = self._cache.get(cid)
            if hit is not None:
                self._cache.move_to_end(cid)
                self._m_hits.inc()
                return hit
        self._m_miss.inc()
        shard = self._fetch(cid)
        if self.cache_clients > 0:
            self._cache[cid] = shard
            while len(self._cache) > self.cache_clients:
                self._cache.popitem(last=False)
        return shard

    def host_cohort(self, client_indices) -> tuple[dict, np.ndarray]:
        """The cohort stacked on the host: ({x, y, mask} numpy, weights)."""
        ids = np.asarray(client_indices, np.int64).reshape(-1)
        with obs.span("serve.cohort_build", clients=int(ids.size)):
            shards = [self.client_shard(int(c)) for c in ids]
            stacked = ({k: np.stack([s[k] for s in shards])
                        for k in shards[0]} if shards else {})
            w = np.asarray([self._weight(int(c)) for c in ids], np.float32)
        return stacked, w

    def cohort(self, client_indices) -> tuple[dict, torch.Tensor]:
        """({x, y, mask} [K, ...], weights [K]) on the store's device,
        built from on-demand shards (pinned, asynchronous copies on the
        card)."""
        stacked, w = self.host_cohort(client_indices)
        return ({k: upload(torch.from_numpy(v), self.device)
                 for k, v in stacked.items()},
                upload(torch.from_numpy(w), self.device))

    def prefetcher(self, cohorts: Sequence, depth: int = 2) -> Prefetcher:
        """One `Prefetcher` whose items are cohort id arrays and whose
        produce() is `self.cohort`: cohort k+1 gathers and uploads on the
        background thread while k trains."""
        return Prefetcher(self.cohort, list(cohorts), depth=depth,
                          name="shardstore-prefetch", device=self.device)


class MaterializedShardStore(ShardStore):
    """Adapter over an existing FederatedData stack: the oracle (its
    cohort() is data.cohort())."""

    def __init__(self, data, cache_clients: int = 0, device=None):
        super().__init__(data.client_num, cache_clients, device)
        self._data = data

    def _fetch(self, cid: int) -> dict:
        return {k: np.asarray(v[cid])
                for k, v in self._data.client_shards.items()}

    def _weight(self, cid: int) -> float:
        return float(self._data.client_num_samples[cid])

    def cohort(self, client_indices):
        # the stack's own device-side gather: this adapter gives
        # materialized data the ShardStore interface, not a slower path
        return self._data.cohort(np.asarray(client_indices, np.int64),
                                 self.device)


class MmapShardStore(ShardStore):
    """Client shards in .npy files opened memory-mapped: the OS pages in
    only the clients a cohort touches.  `build()` writes a
    FederatedData's stack out once; reopening is O(1)."""

    def __init__(self, directory: str, cache_clients: int = 0, device=None):
        self.directory = directory
        self._arrays = {name: np.load(os.path.join(directory, f"{name}.npy"),
                                      mmap_mode="r")
                        for name in ("x", "y", "mask")}
        self._weights = np.load(os.path.join(directory, "weights.npy"))
        super().__init__(self._arrays["mask"].shape[0], cache_clients,
                         device)

    @classmethod
    def build(cls, data, directory: str, cache_clients: int = 0,
              device=None) -> "MmapShardStore":
        os.makedirs(directory, exist_ok=True)
        for name, arr in data.client_shards.items():
            arr = np.asarray(arr)
            # open_memmap + copy writes without doubling host memory
            out = np.lib.format.open_memmap(
                os.path.join(directory, f"{name}.npy"), mode="w+",
                dtype=arr.dtype, shape=arr.shape)
            out[:] = arr
            out.flush()
            del out
        np.save(os.path.join(directory, "weights.npy"),
                np.asarray(data.client_num_samples, np.float32))
        return cls(directory, cache_clients, device)

    def _fetch(self, cid: int) -> dict:
        # np.array copies the page-in out of the mmap, so a cached shard
        # never pins mmap pages
        return {k: np.array(v[cid]) for k, v in self._arrays.items()}

    def _weight(self, cid: int) -> float:
        return float(self._weights[cid])


class GeneratorShardStore(ShardStore):
    """Shards synthesized per client id, deterministic per (seed, client);
    nothing population-sized is ever allocated.  `make_shard` takes
    (client_id, rng) and returns host {x, y, mask} arrays; omitted, a small
    seeded gaussian shard is generated (the serve simulation's default)."""

    def __init__(self, n_clients: int, seed: int = 0,
                 make_shard: Optional[Callable] = None,
                 batches: int = 2, batch_size: int = 8,
                 sample_shape: tuple = (16,), n_classes: int = 10,
                 cache_clients: int = 0, device=None):
        super().__init__(n_clients, cache_clients, device)
        self.seed = int(seed)
        self._make = make_shard
        self._batches = batches
        self._bs = batch_size
        self._shape = tuple(sample_shape)
        self._classes = n_classes

    def _rng(self, cid: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, cid])

    def _fetch(self, cid: int) -> dict:
        rng = self._rng(cid)
        if self._make is not None:
            return self._make(cid, rng)
        shape = (self._batches, self._bs) + self._shape
        return {
            "x": rng.standard_normal(shape).astype(np.float32),
            "y": rng.integers(0, self._classes,
                              (self._batches, self._bs)).astype(np.int64),
            "mask": np.ones((self._batches, self._bs), np.float32),
        }

    def _weight(self, cid: int) -> float:
        # a dedicated stream per client: the weight is the same whether or
        # not the shard was ever fetched
        return float(np.random.default_rng(
            [self.seed, cid, 1]).integers(1, 40))
