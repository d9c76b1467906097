"""Streaming cohort sampling over the sharded client registry (port of
fedml_tpu/scale/sampler.py: host numpy, bitwise the JAX package's draws).

`ClientSampler` (core/sampling.py) draws uniform cohorts by permuting
the whole population — exact reference semantics, O(N) per draw.  At a
million clients the server needs cohort draws that (a) never
materialize the population, (b) respect an eligibility
mask from the registry (banned/dead/crashed/in-flight clients are not
candidates; repeat-quarantined clients auto-BAN past the registry's
`quarantine_ban_threshold` — below it a quarantined sender returns to
the pool), and (c) stay pure functions of (seed, round) like every
other stochastic stream of the package (comm/chaos.py,
async_/adversary.py convention: identical traces per seed, two seeds
differ).

Three modes:

    uniform     the degenerate anchor: ClientSampler.sample_fast (the
                non-mutating exact twin of the reference draw) filtered
                by eligibility — with every client eligible this
                reproduces the existing ClientSampler cohorts BITWISE,
                which is what pins the new spine to the old sampler.
    reservoir   one-pass weighted-key reservoir (Efraimidis–Spirakis
                with uniform weights): per shard, draw one uniform key
                per eligible client and keep the global top-k.
                O(population) draws per cohort but O(shard + k) MEMORY
                — the "streaming" property; exactly uniform over the
                eligible set.
    stratified  per-shard quotas proportional to the registry's
                incrementally-maintained eligible counts (largest-
                remainder rounding, deterministic tie-break), then
                rejection-sampled ids inside each chosen shard.  O(k)
                EXPECTED per cohort — per-round cost independent of the
                population, the serve spine's default.  Falls back to a
                full-shard draw when a shard is too depleted for
                rejection to converge.

All randomness comes from `np.random.default_rng([seed, round, shard])`
streams — no global state, no cross-shard coupling, so a shard's draw
is reproducible in isolation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.scale.registry import ClientRegistry

SAMPLER_MODES = ("uniform", "reservoir", "stratified")

# stratified draws touch at most this many shards per round: per-draw
# cost stays O(k + subset) however large the population, and the
# seeded mass-weighted subset rotation keeps the long-run inclusion
# probability uniform
MAX_STRATA_PER_DRAW = 8


class StreamingCohortSampler:
    """Seeded per-round cohort draws over a ClientRegistry."""

    def __init__(self, registry: ClientRegistry, cohort_size: int,
                 seed: int = 0, mode: str = "reservoir"):
        if mode not in SAMPLER_MODES:
            raise ValueError(f"unknown sampler mode {mode!r} "
                             f"(choose one of {SAMPLER_MODES})")
        if cohort_size < 1:
            raise ValueError(f"cohort_size must be >= 1, got {cohort_size}")
        self.registry = registry
        self.cohort_size = int(cohort_size)
        self.seed = int(seed)
        self.mode = mode
        self._uniform = ClientSampler(registry.n_clients, cohort_size)
        # peak per-draw scratch bytes (keys + candidate ids): the
        # O(shard + k) memory claim
        self.peak_scratch_bytes = 0

    def _note_scratch(self, *arrays: np.ndarray) -> None:
        b = sum(a.nbytes for a in arrays)
        if b > self.peak_scratch_bytes:
            self.peak_scratch_bytes = b

    # -- the one public draw -------------------------------------------------
    def sample(self, round_idx: int,
               k: Optional[int] = None) -> np.ndarray:
        """[<=k] int64 eligible client ids for this round.  Fewer than
        k come back only when fewer are eligible."""
        k = self.cohort_size if k is None else int(k)
        reg = self.registry
        elig = reg.eligible_per_shard()
        total = int(elig.sum())
        if total <= k:
            # degenerate full participation over the eligible set
            out = reg.free_ids(total)
            self._note_scratch(out)
            return out
        if self.mode == "uniform":
            draw = self._uniform.sample_fast(round_idx, k=k)
            keep = reg.eligible(draw)
            out = draw[keep][:k]
            if out.size < k:
                # top up from the id-ordered free pool, skipping clients
                # the draw already took (rare: heavy ineligibility)
                pool = reg.free_ids(k + draw.size)
                out = np.concatenate(
                    [out, np.setdiff1d(pool, out, assume_unique=False)])[:k]
            return out.astype(np.int64)
        if self.mode == "reservoir":
            return self._reservoir(round_idx, k, elig)
        return self._stratified(round_idx, k, elig)

    # -- reservoir: exact uniform, O(shard + k) memory -----------------------
    def _reservoir(self, round_idx: int, k: int,
                   elig: np.ndarray) -> np.ndarray:
        reg = self.registry
        best_keys = np.empty(0, np.float64)
        best_ids = np.empty(0, np.int64)
        for s in range(reg.n_shards):
            if elig[s] == 0:
                continue
            rng = np.random.default_rng([self.seed, round_idx, s])
            mask = reg.eligible_mask(s)
            keys = rng.random(mask.shape[0])
            ids = np.flatnonzero(mask) + s * reg.shard_size
            keys = keys[mask]
            self._note_scratch(keys, ids, best_keys, best_ids)
            cat_k = np.concatenate([best_keys, keys])
            cat_i = np.concatenate([best_ids, ids])
            if cat_k.size > k:
                top = np.argpartition(cat_k, cat_k.size - k)[-k:]
                best_keys, best_ids = cat_k[top], cat_i[top]
            else:
                best_keys, best_ids = cat_k, cat_i
        # deterministic output order: by key descending (the reservoir's
        # arrival-independent canonical order)
        order = np.argsort(-best_keys, kind="stable")
        return best_ids[order].astype(np.int64)

    # -- stratified: O(k) expected, proportional to eligible counts ----------
    def _stratified(self, round_idx: int, k: int,
                    elig: np.ndarray) -> np.ndarray:
        reg = self.registry
        total = int(elig.sum())
        active = np.flatnonzero(elig)
        if active.size > MAX_STRATA_PER_DRAW:
            # seeded shard-subset rotation, mass-weighted: this round
            # draws only from MAX_STRATA shards, the next from another
            # seeded subset — per-round cost decouples from the shard
            # count while long-run coverage stays proportional
            rng0 = np.random.default_rng([self.seed, round_idx, 1 << 20])
            p = elig[active] / total
            sub = active[rng0.choice(active.size, MAX_STRATA_PER_DRAW,
                                     replace=False, p=p)]
            masked = np.zeros_like(elig)
            masked[sub] = elig[sub]
            elig = masked
            total = int(elig.sum())
        exact = elig * (k / total)
        quota = np.floor(exact).astype(np.int64)
        quota = np.minimum(quota, elig)
        short = k - int(quota.sum())
        if short > 0:
            # largest-remainder rounding with shard-id tie-break, capped
            # at each shard's eligible count
            frac = np.where(elig > quota, exact - quota, -1.0)
            for s in np.argsort(-frac, kind="stable"):
                if short == 0:
                    break
                if quota[s] < elig[s]:
                    quota[s] += 1
                    short -= 1
        out = []
        for s in np.flatnonzero(quota):
            s = int(s)
            rng = np.random.default_rng([self.seed, round_idx, s])
            out.append(self._draw_in_shard(rng, s, int(quota[s]),
                                           int(elig[s])))
        ids = (np.concatenate(out) if out else np.zeros((0,), np.int64))
        return np.sort(ids).astype(np.int64)

    def _draw_in_shard(self, rng: np.random.Generator, s: int, q: int,
                       m: int) -> np.ndarray:
        """q distinct eligible ids from shard s (m eligible there).
        Rejection sampling against the status array — O(q) expected
        when the shard is mostly eligible; a depleted shard (< 50%
        eligible, or rejection failing to converge) falls back to one
        materialized O(shard) choice."""
        reg = self.registry
        base = s * reg.shard_size
        n = min(reg.shard_size, reg.n_clients - base)
        if q >= m or m < max(2 * q, n // 2):
            mask = reg.eligible_mask(s)
            ids = np.flatnonzero(mask) + base
            self._note_scratch(mask, ids)
            if q >= ids.size:
                return ids.astype(np.int64)
            return np.sort(ids[rng.choice(ids.size, q, replace=False)])
        got = np.zeros(0, np.int64)
        for _ in range(8):
            need = q - got.size
            loc = rng.integers(0, n, size=2 * need + 8)
            self._note_scratch(loc, got)
            loc = np.unique(loc)
            cand = base + loc[reg.eligible_in_shard(s, loc)]
            got = np.unique(np.concatenate([got, cand]))
            if got.size >= q:
                # keep a seeded subset so overshoot stays unbiased
                return np.sort(got[rng.choice(got.size, q, replace=False)])
        mask = reg.eligible_mask(s)            # pathological: materialize
        ids = np.flatnonzero(mask) + base
        return np.sort(ids[rng.choice(ids.size, min(q, ids.size),
                                      replace=False)])
