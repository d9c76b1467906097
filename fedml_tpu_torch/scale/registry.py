"""Sharded client registry — O(1)-per-round server-side client state
(port of fedml_tpu/scale/registry.py; host numpy, bitwise equal to the
JAX package's, state dicts included).

The FedML paper's target regime (arXiv:2007.13518) is millions of
intermittent clients.  Instead of per-client Python containers, the
async scheduler and server keep ONE struct-of-arrays registry, sharded
into fixed-width numpy blocks:

    participation   uint32   commits this client contributed to
    quarantined     uint32   admission-pipeline rejections
    last_staleness  float32  staleness of the last admitted uplink
    last_seen       int64    server version of the last admitted uplink
    outstanding     int64    version of the in-flight dispatch (-1 idle)
    status          uint8    FREE / IN_FLIGHT / CRASHED / DEAD / BANNED

29 bytes per client and no per-client Python objects: a round touches
only its cohort's rows (vectorized fancy indexing), so per-round cost is
O(cohort), not O(population).

Shards are allocated LAZILY: a shard materializes the first time one of
its clients deviates from the default row (FREE, never seen), so a
10M-client registry where only 10k clients ever participated holds
10k clients' worth of shards.  Aggregate counters (in-flight / dead /
eligible per shard) are maintained incrementally so scheduler decisions
("any free client?", "how many dead?") are O(1) reads, never scans.

Checkpointing: `state()` emits a SHAPE-STABLE stacked snapshot
([n_shards, shard_size] per field, defaults filled in for unallocated
shards); `load_state()` re-sparsifies — shards that round-trip as all
default stay unallocated.  Memory is accounted in the
`registry_bytes` / `registry_clients_total` obs gauges.
"""
from __future__ import annotations

import threading

import numpy as np

from fedml_tpu_torch import obs

# status codes (uint8)
FREE = 0          # dispatchable, sampler-eligible
IN_FLIGHT = 1     # dispatched, result pending
CRASHED = 2       # crashed mid-round, awaiting rejoin
DEAD = 3          # crashed with no rejoin — gone for good
BANNED = 4        # operator/defense ban — never sampled again

_FIELDS = (
    ("participation", np.uint32, 0),
    ("quarantined", np.uint32, 0),
    ("last_staleness", np.float32, 0.0),
    ("last_seen", np.int64, -1),
    ("outstanding", np.int64, -1),
    ("status", np.uint8, FREE),
)
BYTES_PER_CLIENT = sum(np.dtype(d).itemsize for _, d, _v in _FIELDS)

DEFAULT_SHARD_SIZE = 1 << 16


class ClientRegistry:
    """Sharded per-client counters with O(1) aggregate reads.

    Thread-safe: the async messaging server mutates it from recv/pool
    threads while the deadline watchdog reads it — every mutation takes
    the registry lock (scalar touches are one uncontended acquire).
    The virtual-time scheduler is single-threaded and pays the same
    uncontended cost."""

    def __init__(self, n_clients: int, shard_size: int | None = None,
                 quarantine_ban_threshold: int = 0):
        """`quarantine_ban_threshold` > 0 auto-BANs a client whose
        quarantine counter reaches it (excluded from sampling forever).
        0 (default): a quarantined sender
        returns to the pool and redispatches, so one false positive
        can never exile an honest client and the admission screen's
        reject-but-keep-teaching loop keeps working; repeat offenders
        are the operator's call via the counter or the threshold."""
        if n_clients < 1:
            raise ValueError(f"n_clients must be >= 1, got {n_clients}")
        if shard_size is None:
            # small fleets get one exact-width shard; big ones tile at
            # the fixed width so shard scratch stays bounded
            shard_size = min(DEFAULT_SHARD_SIZE, n_clients)
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self.n_clients = int(n_clients)
        self.shard_size = int(shard_size)
        self.quarantine_ban_threshold = int(quarantine_ban_threshold)
        self.n_shards = -(-self.n_clients // self.shard_size)
        self._lock = threading.RLock()
        self._shards: dict[int, dict[str, np.ndarray]] = {}
        # aggregate counters — O(1) scheduler reads
        self.count_in_flight = 0
        self.count_crashed = 0
        self.count_dead = 0
        self.count_banned = 0
        # eligible (= FREE) clients per shard; unallocated shards are
        # all-FREE by construction.  The stratified sampler's shard
        # allocation reads this vector instead of scanning statuses.
        self._elig = np.minimum(
            self.shard_size,
            self.n_clients - np.arange(self.n_shards) * self.shard_size
        ).astype(np.int64)
        self._m_clients = obs.gauge("registry_clients_total")
        self._m_bytes = obs.gauge("registry_bytes")
        self._m_clients.set(self.n_clients)
        self._m_bytes.set(0)

    # -- shard plumbing ------------------------------------------------------
    def _shard_len(self, s: int) -> int:
        return min(self.shard_size, self.n_clients - s * self.shard_size)

    def _alloc(self, s: int) -> dict[str, np.ndarray]:
        sh = self._shards.get(s)
        if sh is None:
            n = self._shard_len(s)
            sh = {name: np.full(n, dv, dtype=dt)
                  for name, dt, dv in _FIELDS}
            self._shards[s] = sh
            self._m_bytes.set(self.nbytes)
        return sh

    @property
    def nbytes(self) -> int:
        """Allocated registry bytes (the `registry_bytes` gauge)."""
        return sum(a.nbytes for sh in self._shards.values()
                   for a in sh.values())

    @property
    def bytes_per_client(self) -> float:
        """Allocated bytes over the FULL population — the sub-linear
        memory headline (<= BYTES_PER_CLIENT even fully allocated)."""
        return self.nbytes / self.n_clients

    @property
    def count_free(self) -> int:
        return (self.n_clients - self.count_in_flight - self.count_crashed
                - self.count_dead - self.count_banned)

    def _check(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_clients):
            raise IndexError(
                f"client id out of range [0, {self.n_clients}): "
                f"{ids[(ids < 0) | (ids >= self.n_clients)][:4]}")
        return ids

    def contains(self, cid: int) -> bool:
        return 0 <= int(cid) < self.n_clients

    def _check_scalar(self, cid) -> int:
        cid = int(cid)
        if not 0 <= cid < self.n_clients:
            raise IndexError(f"client id {cid} out of range "
                             f"[0, {self.n_clients})")
        return cid

    # status -> aggregate-counter attribute (FREE tracks via _elig)
    _COUNTER = {IN_FLIGHT: "count_in_flight", CRASHED: "count_crashed",
                DEAD: "count_dead", BANNED: "count_banned"}

    def _set_status_scalar(self, cid: int, status: int) -> tuple:
        """One client's status transition — the per-arrival fast path
        (no array building, no grouping).  Caller holds _lock.  Returns
        (shard dict, local index).  BANNED is STICKY: no lifecycle
        transition leaves it (only unban()/load_state) — otherwise a
        redispatch or rejoin racing a ban would silently re-admit the
        client the ban was supposed to exile."""
        s, loc = divmod(cid, self.shard_size)
        sh = self._alloc(s)
        old = int(sh["status"][loc])
        if old == BANNED and status != BANNED:
            return sh, loc
        if old != status:
            a = self._COUNTER.get(old)
            if a is not None:
                setattr(self, a, getattr(self, a) - 1)
            a = self._COUNTER.get(status)
            if a is not None:
                setattr(self, a, getattr(self, a) + 1)
            self._elig[s] += int(status == FREE) - int(old == FREE)
            sh["status"][loc] = status
        return sh, loc

    def _field_of(self, ids: np.ndarray, name: str,
                  dtype, default) -> np.ndarray:
        out = np.full(ids.shape, default, dtype=dtype)
        for s in np.unique(ids // self.shard_size):
            sh = self._shards.get(int(s))
            sel = (ids // self.shard_size) == s
            if sh is not None:
                out[sel] = sh[name][ids[sel] - int(s) * self.shard_size]
        return out

    def _update_elig(self, s: int, old_status: np.ndarray,
                     new_status: np.ndarray) -> None:
        self._elig[s] += (int(np.count_nonzero(new_status == FREE))
                          - int(np.count_nonzero(old_status == FREE)))

    def _set_status(self, ids: np.ndarray, status: int) -> None:
        """Vectorized status transition; keeps the aggregate +
        per-shard eligibility counters exact.  Deduplicates (a repeated
        id must count once — the status cell stores it once) and skips
        BANNED rows (sticky, like the scalar path)."""
        ids = np.unique(ids)
        for s in np.unique(ids // self.shard_size):
            s = int(s)
            sh = self._alloc(s)
            loc = ids[(ids // self.shard_size) == s] - s * self.shard_size
            if status != BANNED:
                loc = loc[sh["status"][loc] != BANNED]
                if not loc.size:
                    continue
            old = sh["status"][loc]
            for st, attr in ((IN_FLIGHT, "count_in_flight"),
                             (CRASHED, "count_crashed"),
                             (DEAD, "count_dead"),
                             (BANNED, "count_banned")):
                delta = (int(status == st) * loc.size
                         - int(np.count_nonzero(old == st)))
                setattr(self, attr, getattr(self, attr) + delta)
            sh["status"][loc] = status
            new = sh["status"][loc]
            self._update_elig(s, old, new)

    # -- lifecycle transitions (the scheduler/manager write API) -------------
    def note_dispatch(self, ids, version: int) -> None:
        """Clients handed work at `version`: FREE -> IN_FLIGHT."""
        with self._lock:
            ids = self._check(ids)
            if not ids.size:
                return
            self._set_status(ids, IN_FLIGHT)
            for s in np.unique(ids // self.shard_size):
                s = int(s)
                sh = self._alloc(s)
                loc = ids[(ids // self.shard_size) == s] - s * self.shard_size
                # only rows the (ban-sticky) transition actually moved
                loc = loc[sh["status"][loc] == IN_FLIGHT]
                sh["outstanding"][loc] = np.int64(version)

    def note_dispatch_one(self, cid: int, version: int) -> None:
        """Scalar twin of note_dispatch — the per-lane hot path (no
        array build, no shard grouping)."""
        with self._lock:
            cid = self._check_scalar(cid)
            sh, loc = self._set_status_scalar(cid, IN_FLIGHT)
            if int(sh["status"][loc]) == IN_FLIGHT:   # ban is sticky
                sh["outstanding"][loc] = version

    def note_return(self, cid: int) -> int:
        """An uplink (or a quarantine decision) returned this client to
        the pool: IN_FLIGHT -> FREE.  Returns the version it was
        dispatched at (-1 if it was never in flight)."""
        with self._lock:
            cid = self._check_scalar(cid)
            sh, loc = self._set_status_scalar(cid, FREE)
            v = int(sh["outstanding"][loc])
            sh["outstanding"][loc] = -1
            return v

    def note_contribution(self, cid: int, staleness: float,
                          version: int) -> None:
        """An ADMITTED uplink: bump participation, record staleness and
        the server version that folded it."""
        with self._lock:
            cid = self._check_scalar(cid)
            s, loc = divmod(cid, self.shard_size)
            sh = self._alloc(s)
            sh["participation"][loc] += 1
            sh["last_staleness"][loc] = staleness
            sh["last_seen"][loc] = version

    def note_push(self, cid: int, staleness: float,
                  version: int) -> None:
        """A PUSH-mode uplink (live-socket serving, scale/cluster.py):
        the client contributed without a server dispatch, so there is
        no IN_FLIGHT marker to retire — participation/staleness/
        last_seen update exactly as note_contribution, status stays
        untouched."""
        with self._lock:
            cid = self._check_scalar(cid)
            s, loc = divmod(cid, self.shard_size)
            sh = self._alloc(s)
            sh["participation"][loc] += 1
            sh["last_staleness"][loc] = staleness
            sh["last_seen"][loc] = version

    def note_quarantine(self, cid: int) -> bool:
        """Count one admission rejection; returns True when the client
        crossed `quarantine_ban_threshold` and was auto-BANNED (never
        sampled again)."""
        with self._lock:
            cid = self._check_scalar(cid)
            s, loc = divmod(cid, self.shard_size)
            sh = self._alloc(s)
            sh["quarantined"][loc] += 1
            if (self.quarantine_ban_threshold > 0
                    and int(sh["quarantined"][loc])
                    >= self.quarantine_ban_threshold):
                self._set_status_scalar(cid, BANNED)
                return True
            return False

    def note_crash(self, cid: int, rejoins: bool) -> None:
        """Crash mid-round: IN_FLIGHT/FREE -> CRASHED (a rejoin event is
        scheduled) or DEAD (gone for good)."""
        with self._lock:
            cid = self._check_scalar(cid)
            sh, loc = self._set_status_scalar(
                cid, CRASHED if rejoins else DEAD)
            sh["outstanding"][loc] = -1

    def note_rejoin(self, cid: int) -> None:
        with self._lock:
            self._set_status_scalar(self._check_scalar(cid), FREE)

    def ban(self, ids) -> None:
        """Operator/defense ban: excluded from eligibility until an
        explicit unban() — sticky against every lifecycle transition."""
        with self._lock:
            self._set_status(self._check(ids), BANNED)

    def unban(self, ids) -> None:
        """Explicit operator reversal of ban() — the ONLY way out of
        BANNED (lifecycle transitions skip banned rows)."""
        with self._lock:
            ids = np.unique(self._check(ids))
            for s in np.unique(ids // self.shard_size):
                s = int(s)
                sh = self._alloc(s)
                loc = ids[(ids // self.shard_size) == s] - s * self.shard_size
                loc = loc[sh["status"][loc] == BANNED]
                self.count_banned -= int(loc.size)
                self._elig[s] += int(loc.size)
                sh["status"][loc] = FREE

    # -- read API ------------------------------------------------------------
    def status_of(self, ids) -> np.ndarray:
        with self._lock:
            return self._field_of(self._check(ids), "status", np.uint8, FREE)

    def outstanding_of(self, ids) -> np.ndarray:
        with self._lock:
            return self._field_of(self._check(ids), "outstanding",
                                  np.int64, -1)

    def participation(self, ids) -> np.ndarray:
        with self._lock:
            return self._field_of(self._check(ids), "participation",
                                  np.uint32, 0)

    def last_staleness(self, ids) -> np.ndarray:
        with self._lock:
            return self._field_of(self._check(ids), "last_staleness",
                                  np.float32, 0.0)

    def quarantines(self, ids) -> np.ndarray:
        with self._lock:
            return self._field_of(self._check(ids), "quarantined",
                                  np.uint32, 0)

    def total_participation(self) -> int:
        with self._lock:
            return int(sum(int(sh["participation"].sum(dtype=np.int64))
                           for sh in self._shards.values()))

    def outstanding_ids(self) -> np.ndarray:
        """Ids with a dispatch in flight — allocated shards only
        (unallocated shards are idle by construction)."""
        with self._lock:
            out = []
            for s in sorted(self._shards):
                sh = self._shards[s]
                loc = np.flatnonzero(sh["outstanding"] >= 0)
                if loc.size:
                    out.append(loc + s * self.shard_size)
            return (np.concatenate(out) if out
                    else np.zeros((0,), np.int64))

    def free_ids(self, limit: int) -> np.ndarray:
        """First `limit` FREE ids in ascending order.  Unallocated
        shards are all-FREE, so the scan touches at most
        O(limit + allocated shards) entries — never the population."""
        out: list[np.ndarray] = []
        got = 0
        with self._lock:
            for s in range(self.n_shards):
                if got >= limit:
                    break
                base = s * self.shard_size
                sh = self._shards.get(s)
                if sh is None:
                    take = min(self._shard_len(s), limit - got)
                    out.append(np.arange(base, base + take, dtype=np.int64))
                else:
                    loc = np.flatnonzero(sh["status"] == FREE)[:limit - got]
                    out.append(loc.astype(np.int64) + base)
                got += len(out[-1])
        return (np.concatenate(out) if out else np.zeros((0,), np.int64))

    def eligible_per_shard(self) -> np.ndarray:
        """[n_shards] FREE counts (incrementally maintained — an O(S)
        copy, never an O(N) scan)."""
        with self._lock:
            return self._elig.copy()

    def eligible_mask(self, shard: int) -> np.ndarray:
        """Bool eligibility over one shard's clients (the reservoir
        sampler's per-shard stream); O(shard_size) scratch."""
        with self._lock:
            sh = self._shards.get(int(shard))
            if sh is None:
                return np.ones(self._shard_len(int(shard)), bool)
            return sh["status"] == FREE

    def eligible(self, ids) -> np.ndarray:
        return self.status_of(ids) == FREE

    def eligible_in_shard(self, shard: int, loc: np.ndarray) -> np.ndarray:
        """Eligibility of LOCAL indices within one shard — the
        rejection sampler's fast path (no id grouping)."""
        with self._lock:
            sh = self._shards.get(int(shard))
            if sh is None:
                return np.ones(loc.shape, bool)
            return sh["status"][loc] == FREE

    # -- run-boundary + checkpoint protocol ----------------------------------
    def reset_transient(self) -> None:
        """Start-of-run reset: IN_FLIGHT/CRASHED/DEAD -> FREE with
        outstanding cleared (a fresh run re-pools every client; a
        resumed run restarts the event clock but keeps participation /
        staleness / quarantine history).  BANNED survives — a ban is
        state, not schedule."""
        with self._lock:
            for s, sh in self._shards.items():
                old = sh["status"].copy()
                transient = np.isin(old, (IN_FLIGHT, CRASHED, DEAD))
                sh["status"][transient] = FREE
                sh["outstanding"][:] = -1
                self._update_elig(s, old, sh["status"])
            self.count_in_flight = 0
            self.count_crashed = 0
            self.count_dead = 0

    def state(self) -> dict:
        """Shape-stable snapshot: every field stacked to
        [n_shards, shard_size] (defaults filled in for unallocated
        shards and the last shard's tail), plus the geometry — a fresh
        registry's template always matches a saved one."""
        with self._lock:
            out = {"n_clients": np.asarray(self.n_clients, np.int64),
                   "shard_size": np.asarray(self.shard_size, np.int64)}
            for name, dt, dv in _FIELDS:
                stacked = np.full((self.n_shards, self.shard_size), dv,
                                  dtype=dt)
                for s, sh in self._shards.items():
                    stacked[s, :sh[name].shape[0]] = sh[name]
                out[name] = stacked
            return out

    def load_state(self, state: dict) -> None:
        """Restore from `state()`, re-sparsifying: shards whose saved
        rows are all default stay unallocated."""
        n = int(state["n_clients"])
        ssz = int(state["shard_size"])
        if (n, ssz) != (self.n_clients, self.shard_size):
            raise ValueError(
                f"registry shape mismatch: checkpoint ({n} clients, "
                f"shard {ssz}) vs configured ({self.n_clients}, "
                f"{self.shard_size})")
        with self._lock:
            self._shards.clear()
            self.count_in_flight = self.count_crashed = 0
            self.count_dead = self.count_banned = 0
            self._elig = np.minimum(
                self.shard_size,
                self.n_clients - np.arange(self.n_shards) * self.shard_size
            ).astype(np.int64)
            for s in range(self.n_shards):
                nrow = self._shard_len(s)
                rows = {name: np.asarray(state[name][s][:nrow], dtype=dt)
                        for name, dt, _dv in _FIELDS}
                if all(np.all(rows[name] == dv)
                       for name, _dt, dv in _FIELDS):
                    continue                      # default shard: stay lazy
                sh = self._alloc(s)
                for name in rows:
                    np.copyto(sh[name], rows[name])
                st = sh["status"]
                self.count_in_flight += int(np.count_nonzero(
                    st == IN_FLIGHT))
                self.count_crashed += int(np.count_nonzero(st == CRASHED))
                self.count_dead += int(np.count_nonzero(st == DEAD))
                self.count_banned += int(np.count_nonzero(st == BANNED))
                self._elig[s] = int(np.count_nonzero(st == FREE))
            self._m_bytes.set(self.nbytes)
