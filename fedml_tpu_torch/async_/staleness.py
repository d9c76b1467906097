"""Staleness-aware buffered aggregation: the async commit math (port of
fedml_tpu/async_/staleness.py).

The async scheduler (async_/scheduler.py) and the async server
(async_/lifecycle.py) accumulate client results into a bounded buffer
and commit when K results arrived or a deadline fired (FedBuff-style
semi-async).  Each result carries a STALENESS s, the number of server
commits since the model version it trained from, and is discounted by
one of three weight families (FedAsync, arXiv:1903.03934 §5):

    constant      λ(s) = 1
    polynomial    λ(s) = (1 + s)^-a
    hinge         λ(s) = 1 if s <= b else 1 / (a·(s - b) + 1)

Commit rule (mixing form):

    w̃_i   = n_i · λ(s_i)
    avg   = Σ w̃_i v_i / Σ w̃_i
    v_new = (1 - α) · v + α · avg

Rows.  A buffer row is one flat f32 vector of the variables in the
template dict's order (for a trainer's variables, ``trainer.spec``'s),
zero-padded to a multiple of ``ops.aggregate.TILE`` as the trainer's
flat vectors are, so that trained rows enter the buffer without a copy
of leaves and every row is 16-byte aligned for the kernels.
``flat_dim`` is that padded width; ``RowLayout.p`` is the unpadded
length the wire codec fills.

Where the reductions run, on the card (on the CPU each kernel's plain
version runs, as everywhere in the port):

* the arrival fold (``make_fold_fn``) is kernel B.3's accumulate form on
  a [1, P] row, ``ops.aggregate.fold``, with w̃ = n·λ(s) computed on the
  accumulator's device.  One arrival adds round(w̃·row) to the
  accumulator;
* the drain twin (``make_drain_fold_fn``) folds the lanes one at a time,
  in arrival order, through the same call.  One [K, P] launch would not
  be bitwise the arrivals' sum: the kernel sums a launch's lanes in
  registers, and the compiler contracts the second lane on into an FMA.
  Zero-weight pad lanes add round(0·row) = ±0, an exact no-op;
* the legacy drain commit (``make_commit_fn``) is B.3's finalize form
  over the [K, P] buffer matrix (``weighted_mean_flat``), the same
  launch the port's FedAvgEngine aggregates with;
* λ comes from one function (``staleness_weight``) evaluated on the
  accumulator's device, so the λ of an arrival and the λ of the drain
  twin's lane are one computation.  ``torch.pow`` and XLA's pow may
  differ in the last bit, so λ holds to the JAX package's within 2 ulp.

The legacy drain commit normalises before it sums (JAX's
``tree_weighted_mean``) and the streaming commit divides after; the two
families agree to float tolerance, never bitwise.  The streaming path is
pinned against its own drain twin.

The secure field fold (``make_field_fold_fn``) is integer math in int64
tensors: (acc + row) mod p, bitwise JAX's u32 result.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.obs import programs as obs_programs
from fedml_tpu_torch.ops.aggregate import (TILE, TreeSpec, fold, spec_of,
                                           unflatten_to_tree,
                                           weighted_mean_flat)
from fedml_tpu_torch.utils.device import resolve_device

STALENESS_MODES = ("constant", "polynomial", "hinge")
BUCKET_COMBINE_MODES = ("mean", "trimmed_mean", "median")


def _check_mode(mode: str) -> None:
    if mode not in STALENESS_MODES:
        raise ValueError(f"unknown staleness mode {mode!r} "
                         f"(choose one of {STALENESS_MODES})")


def staleness_weight(mode: str, s, a: float = 0.5, b: float = 4.0):
    """λ(s) for a staleness tensor (f32 in, f32 out, on s's device).  `a`/
    `b` are the FedAsync shape parameters (polynomial exponent / hinge
    knee)."""
    _check_mode(mode)
    s = torch.as_tensor(s, dtype=torch.float32)
    if mode == "constant":
        return torch.ones_like(s)
    if mode == "polynomial":
        return torch.pow(1.0 + s, -float(np.float32(a)))
    a32 = torch.tensor(a, dtype=torch.float32, device=s.device)
    return torch.where(s <= b, torch.ones_like(s), 1.0 / (a32 * (s - b) + 1.0))


def _f32(x, device) -> torch.Tensor:
    """A Python or numpy scalar (or a one-element tensor) as a [1] f32
    tensor on `device`."""
    return torch.as_tensor(x, dtype=torch.float32).reshape(1).to(device)


def discounted_weight(mode: str, a: float, b: float, weight, staleness,
                      device) -> torch.Tensor:
    """w̃ = weight·λ(staleness) as a [1] f32 tensor on `device`: the one
    computation of an arrival's weight, shared by the arrival fold, its
    drain twin and the screened fold."""
    return _f32(weight, device) * staleness_weight(
        mode, _f32(staleness, device), a, b)


# ---------------------------------------------------------------------------
# flat rows
# ---------------------------------------------------------------------------

def row_spec(template: dict) -> TreeSpec:
    """The TreeSpec of a variables dict: names, shapes and dtypes in the
    dict's order; ``.n`` the row length, ``.padded`` the buffer width."""
    return spec_of({k: torch.as_tensor(v) for k, v in template.items()})


def flat_dim(template: dict) -> int:
    """P, the buffer row width: the template's element count padded to a
    multiple of TILE."""
    return row_spec(template).padded


def flatten_vars_row(tree: dict, device=None) -> torch.Tensor:
    """A variables dict -> one [P] f32 row in the dict's order, zero-padded
    (on `device`, default the leaves' own)."""
    leaves = [torch.as_tensor(v).reshape(-1).float() for v in tree.values()]
    n = sum(l.numel() for l in leaves)
    dev = device if device is not None else leaves[0].device
    row = torch.zeros(n + (-n) % TILE, dtype=torch.float32, device=dev)
    off = 0
    for l in leaves:
        row[off:off + l.numel()] = l
        off += l.numel()
    return row


def unflatten_row(row: torch.Tensor, template: dict) -> dict:
    """[P] (or [n]) row -> dict of the template's names, shapes and
    dtypes; f32 leaves are views of `row`."""
    return unflatten_to_tree(row, row_spec(template))


class RowLayout:
    """Flat-row decode layout for ``MessageCodec.decode_into``: the codec's
    array path of each leaf ("/key/name") -> (offset, size, shape) in the
    row, in the template's order, so a frame decoded into the row is
    bitwise ``flatten_vars_row`` of the decoded dict.  ``p`` is the
    unpadded length the frame must cover; ``padded`` the buffer width."""

    def __init__(self, template: dict, key: str):
        self.key = key
        self.offsets: dict[str, tuple[int, int, tuple]] = {}
        off = 0
        for name, leaf in template.items():
            shape = tuple(np.shape(leaf))
            size = int(np.prod(shape)) if shape else 1
            self.offsets[f"/{key}/{name}"] = (off, size, shape)
            off += size
        self.p = off
        self.padded = off + (-off) % TILE


def _mix(variables: dict, avg_row: torch.Tensor, alpha) -> dict:
    """(1 - α)·v + α·avg per leaf, in f32, cast back to each leaf's dtype.
    With α = 1 this is avg exactly: 0·v + avg."""
    alpha = _f32(alpha, avg_row.device)[0]
    avg = unflatten_to_tree(avg_row, row_spec(variables), torch.float32)
    return {k: ((1.0 - alpha) * v.float() + alpha * avg[k]).to(v.dtype)
            for k, v in variables.items()}


# ---------------------------------------------------------------------------
# the legacy drain commit
# ---------------------------------------------------------------------------

def make_commit_fn(template: dict, mode: str = "constant", a: float = 0.5,
                   b: float = 4.0):
    """The drain commit:

        commit(variables, rows [K, P] f32, weights [K], staleness [K],
               alpha) -> (new_variables, stats)

    `weights` are per-result sample counts with zero-weight pad lanes (a
    deadline commit drains a part-full buffer padded to capacity; a zero
    lane drops out of the weighted mean exactly).  The mean is one
    finalize launch of the fold kernel over the rows.  `template` fixes
    the row layout (its names and shapes; `variables` must match)."""
    _check_mode(mode)
    spec = row_spec(template)

    def commit(variables, rows, weights, staleness, alpha):
        if row_spec(variables).names != spec.names:
            raise ValueError("commit variables do not match the template")
        dev = rows.device
        weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
        lam = staleness_weight(mode, torch.as_tensor(staleness).to(dev), a, b)
        w = (weights * lam).contiguous()
        new = _mix(variables, weighted_mean_flat(rows, w), alpha)
        stats = {"discount_mass": w.sum() / torch.clamp(weights.sum(),
                                                        min=1e-12)}
        return new, stats

    return obs_programs.instrument("async_commit", commit)


# ---------------------------------------------------------------------------
# streaming aggregation-on-arrival
# ---------------------------------------------------------------------------

def _arrival_fold(mode, a, b):
    """acc += w̃·row in place (one accumulate launch of the fold kernel on
    the card), w̃ = weight·λ(staleness) computed on acc's device; returns
    (acc, wsum + w̃)."""
    def arrive(acc, wsum, row, weight, staleness):
        dev = acc.device
        wt = discounted_weight(mode, a, b, weight, staleness, dev)
        row = torch.as_tensor(row, dtype=torch.float32).to(dev)
        fold(acc, row.reshape(1, -1), wt)
        return acc, wsum + wt[0]
    return arrive


def make_fold_fn(mode: str = "constant", a: float = 0.5, b: float = 4.0):
    """The arrival fold, the streaming partial sum's one step:

        fold(acc [P], wsum, row [P], weight, staleness)
            -> (acc + w̃·row, wsum + w̃),   w̃ = weight·λ(staleness)

    `acc` is updated in place (the same tensor comes back); `row` may lie
    on the host, it is copied to acc's device first."""
    _check_mode(mode)
    return obs_programs.instrument("async_fold", _arrival_fold(mode, a, b))


def make_sparse_fold_fn(mode: str = "constant", a: float = 0.5,
                        b: float = 4.0):
    """The SPARSE twin of the arrival fold:

        fold(acc [P], wsum, idx [k], vals [k], weight, staleness)
            -> (acc + w̃·scatter(idx, vals), wsum + w̃)

    The k (index, value) pairs of a sparse_topk frame are scattered into a
    zero row on acc's device, which then takes the dense arrival fold's
    path: a sparse arrival is bitwise the dense arrival of the densified
    row (a scatter-add of pre-multiplied w̃·vals would round otherwise)."""
    _check_mode(mode)
    arrive = _arrival_fold(mode, a, b)

    def sparse_fold(acc, wsum, idx, vals, weight, staleness):
        dev = acc.device
        row = torch.zeros_like(acc)
        row[torch.as_tensor(idx, dtype=torch.int64).to(dev)] = \
            torch.as_tensor(vals, dtype=torch.float32).to(dev)
        return arrive(acc, wsum, row, weight, staleness)

    return obs_programs.instrument("async_sparse_fold", sparse_fold)


def make_field_fold_fn(prime: int):
    """The INTEGER-FIELD twin of the arrival fold, secure aggregation's
    mask-and-fold:

        fold(acc [W] int64, row [W] int64) -> (acc + row) mod prime

    Both operands are field residues below prime <= 2^31 - 1, so the int64
    sum is exact and the result is bitwise the JAX package's u32 fold.
    `acc` is updated in place."""
    p = int(prime)

    def field_fold(acc, row):
        return acc.add_(row.to(acc.device)).remainder_(p)

    return obs_programs.instrument("secagg_fold", field_fold)


def make_drain_fold_fn(mode: str = "constant", a: float = 0.5,
                       b: float = 4.0):
    """The drained twin of the arrival fold: drain(rows [K, P], weights [K],
    staleness [K]) -> (acc, wsum), the lanes folded one at a time in lane
    order through the arrival fold's own call, so it is bitwise the
    arrivals' accumulator (zero-weight pad lanes are exact no-ops, so a
    capacity-padded deadline drain matches a partial streaming fold)."""
    _check_mode(mode)
    arrive = _arrival_fold(mode, a, b)

    def drain(rows, weights, staleness):
        dev = rows.device
        weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
        staleness = torch.as_tensor(staleness, dtype=torch.float32).to(dev)
        acc = torch.zeros(rows.shape[1], dtype=torch.float32, device=dev)
        wsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(rows.shape[0]):
            acc, wsum = arrive(acc, wsum, rows[i], weights[i:i + 1],
                               staleness[i:i + 1])
        return acc, wsum

    return obs_programs.instrument("async_drain_fold", drain)


def make_stream_commit_fn(template: dict):
    """The O(P) streaming commit:

        commit(variables, acc [P], wsum, alpha) -> (new_variables, stats)

    The K-wide reduction happened at arrival time (make_fold_fn), so the
    commit is one divide and the mixing update."""
    spec = row_spec(template)

    def commit(variables, acc, wsum, alpha):
        if row_spec(variables).names != spec.names:
            raise ValueError("commit variables do not match the template")
        wsum = torch.as_tensor(wsum, dtype=torch.float32).to(acc.device)
        return _mix(variables, acc / wsum, alpha), {"discount_wsum": wsum}

    return obs_programs.instrument("async_stream_commit", commit)


def make_bucket_commit_fn(template: dict, combine: str = "trimmed_mean",
                          trim_k: int = 0, dp_noise: float = 0.0,
                          dp_clip: float = 1.0):
    """The O(B·P) bucketed ROBUST streaming commit:

        commit(variables, accs [B, P], wsums [B], alpha[, n_contrib, rng])
            -> (new_variables, stats)

    Each non-empty bucket divides into its discounted mean, and the commit
    combines ACROSS bucket means per coordinate (empty buckets masked to
    +inf before the sort, so they fall outside every rank window):

        mean           trimmed_mean with k_eff = 0
        trimmed_mean   drop the k_eff = min(trim_k, ⌊(m-1)/2⌋) largest and
                       smallest bucket means, average the rest
        median         per-coordinate median of the m bucket means

    B = 1 with trim 0 (or "mean") is the streaming commit
    (make_stream_commit_fn) bitwise: one bucket's acc/wsum, a sort of one
    row, a sum of one row and a division by 1.

    DP-FedAvg: `dp_noise` > 0 adds σ·N(0, I) to the combined mean, σ =
    dp_noise·dp_clip / n_contrib (the per-client clip bounds each
    contribution, so the n-client average has sensitivity S/n).  `rng` is
    a torch.Generator on the accumulators' device, or the standard normal
    draws themselves (a [P] tensor)."""
    if combine not in BUCKET_COMBINE_MODES:
        raise ValueError(f"unknown bucket combine {combine!r} "
                         f"(choose one of {BUCKET_COMBINE_MODES})")
    if trim_k < 0:
        raise ValueError(f"trim_k must be >= 0, got {trim_k}")
    spec = row_spec(template)

    def _combine(accs, wsums):
        valid = wsums > 0.0
        m = valid.float().sum()
        safe_w = torch.where(valid, wsums, torch.ones_like(wsums))
        means = accs / safe_w[:, None]
        inf = torch.full_like(means, float("inf"))
        s = torch.sort(torch.where(valid[:, None], means, inf), dim=0).values
        if combine == "median":
            mi = m.to(torch.int64)
            lo = s.index_select(0, torch.clamp((mi - 1) // 2, min=0)
                                .reshape(1))[0]
            hi = s.index_select(0, (mi // 2).reshape(1))[0]
            row = 0.5 * (lo + hi)
        else:
            zero = torch.zeros((), dtype=torch.float32, device=accs.device)
            k_eff = (torch.minimum(zero + trim_k, torch.floor((m - 1.0) / 2.0))
                     if combine == "trimmed_mean" and trim_k > 0 else zero)
            ranks = torch.arange(s.shape[0], dtype=torch.float32,
                                 device=accs.device)[:, None]
            keep = (ranks >= k_eff) & (ranks < m - k_eff)
            row = (torch.where(keep, s, torch.zeros_like(s)).sum(dim=0)
                   / (m - 2.0 * k_eff))
        stats = {"bucket_means": torch.where(valid[:, None], means,
                                             torch.zeros_like(means)),
                 "n_buckets": m, "bucket_wsum": wsums}
        return row, stats

    def commit(variables, accs, wsums, alpha, n_contrib=None, rng=None):
        if row_spec(variables).names != spec.names:
            raise ValueError("commit variables do not match the template")
        wsums = torch.as_tensor(wsums, dtype=torch.float32).to(accs.device)
        row, stats = _combine(accs, wsums)
        if dp_noise > 0.0:
            if n_contrib is None or rng is None:
                raise ValueError("a DP bucket commit takes n_contrib and rng")
            sigma = (torch.tensor(dp_noise * dp_clip, dtype=torch.float32)
                     / max(float(np.float32(n_contrib)), 1.0))
            noise = (rng if isinstance(rng, torch.Tensor) else torch.randn(
                row.shape, generator=rng, dtype=torch.float32,
                device=row.device))
            row = row + sigma.to(row.device) * noise.to(row.device)
        return _mix(variables, row, alpha), stats

    return obs_programs.instrument("async_bucket_commit", commit)


# ---------------------------------------------------------------------------
# the bounded aggregation buffer
# ---------------------------------------------------------------------------

class AsyncBuffer:
    """Bounded aggregation buffer on `device`, in one of two modes:

    * drain mode (default): a [capacity, P] f32 row matrix plus per-row
      sample weights and staleness.  `drain()` returns capacity-sized
      arrays (zero-weight pad lanes beyond `count`) and the real count;
    * streaming mode: no row matrix.  `add` folds w̃·row into a running
      [P] f32 accumulator through the arrival fold (make_fold_fn), so
      `take_stream()` hands the commit one accumulator and Σw̃.  The
      per-lane weights and staleness are still recorded, and a drain-mode
      state restores into a streaming buffer by replaying its rows
      through the same fold.

    Bucketed mode (streaming only): `buckets` = B > 1 keeps B [P]
    accumulators; each arrival folds into a SEEDED bucket (a fresh
    permutation of range(B) every B inserts, from
    ``np.random.default_rng([bucket_seed, 5])``, bitwise the JAX
    package's stream).  `take_stream_buckets()` hands the bucketed robust
    commit the stacked [B, P] / [B] state.

    Thread-safe: every public method takes the buffer's own lock.  The
    weights and staleness stay host numpy; the rows, accumulators and Σw̃
    live on `device` (the card unless the caller names another)."""

    def __init__(self, capacity: int, p: int, *, streaming: bool = False,
                 staleness_mode: str = "constant", staleness_a: float = 0.5,
                 staleness_b: float = 4.0, buckets: int = 1,
                 bucket_seed: int = 0, device=None):
        if capacity < 1:
            raise ValueError(f"buffer capacity must be >= 1, got {capacity}")
        if buckets < 1:
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        if buckets > 1 and not streaming:
            raise ValueError("bucketed aggregation needs streaming=True "
                             "(drain mode already holds the full [K, P] "
                             "matrix — bucket it at commit time instead)")
        if buckets > capacity:
            raise ValueError(f"buckets ({buckets}) cannot exceed buffer "
                             f"capacity ({capacity}): a full buffer could "
                             f"never populate every bucket")
        self.capacity = capacity
        self.p = p
        self.streaming = streaming
        self.buckets = int(buckets)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.weights = np.zeros((capacity,), np.float32)
        self.staleness = np.zeros((capacity,), np.float32)
        self.count = 0
        if streaming:
            self.rows = None
            self._fold = make_fold_fn(staleness_mode, staleness_a,
                                      staleness_b)
            self._sparse_fold = None          # built on first sparse arrival
            self._staleness_args = (staleness_mode, staleness_a,
                                    staleness_b)
            if self.buckets > 1:
                self._accs, self._wsums = self._zero_buckets()
                self._bucket_rng = np.random.default_rng([bucket_seed, 5])
                self._bucket_order: list[int] = []
                self._bucket_draws = 0       # assignment-stream position
            else:
                self.acc, self.wsum = self._zero_acc()
            self.raw_wsum = 0.0              # un-discounted Σweight (stats)
        else:
            self.rows = torch.zeros(capacity, p, dtype=torch.float32,
                                    device=self.device)

    def _zero_acc(self):
        return (torch.zeros(self.p, dtype=torch.float32, device=self.device),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def _zero_buckets(self):
        pairs = [self._zero_acc() for _ in range(self.buckets)]
        return [a for a, _ in pairs], [w for _, w in pairs]

    def _next_bucket(self) -> int:
        """Seeded bucket draw (caller holds _lock)."""
        b = self._peek_bucket()
        self._bucket_order.pop()
        self._bucket_draws += 1
        return b

    def _peek_bucket(self) -> int:
        """The bucket the NEXT accepted insert will take, without consuming
        the draw: a quarantined row must not advance the assignment stream."""
        if not self._bucket_order:
            self._bucket_order = [int(b) for b in
                                  self._bucket_rng.permutation(self.buckets)]
        return self._bucket_order[-1]

    def _record(self, weight: float, staleness: float) -> bool:
        """Book one inserted row (caller holds _lock); True when full."""
        i = self.count
        self.weights[i] = np.float32(weight)
        self.staleness[i] = np.float32(staleness)
        if self.streaming:
            self.raw_wsum += float(weight)
        self.count += 1
        return self.count >= self.capacity

    def _check_room(self) -> None:
        if self.count >= self.capacity:
            raise RuntimeError("async buffer overflow: commit before add")

    def add_screened(self, row, weight: float, staleness: float,
                     admission, *, sender: int = -1,
                     version: Optional[int] = None):
        """The defended insert: the admission screens the row and folds the
        accepted (clipped) contribution into the target accumulator
        (defense.UpdateAdmission.screened_fold).  Returns (admitted,
        reason, full); a quarantined row leaves the accumulator bitwise
        unchanged and takes no slot and no bucket draw.  Streaming only."""
        with self._lock:
            if not self.streaming:
                raise RuntimeError(
                    "add_screened() on a drain-mode AsyncBuffer — the "
                    "admission pipeline rides the streaming fold")
            self._check_room()
            if self.buckets > 1:
                b = self._peek_bucket()
                ok, why, self._accs[b], self._wsums[b] = \
                    admission.screened_fold(
                        self._accs[b], self._wsums[b], row, weight,
                        staleness, sender=sender, version=version)
                if ok:
                    self._next_bucket()
            else:
                ok, why, self.acc, self.wsum = admission.screened_fold(
                    self.acc, self.wsum, row, weight, staleness,
                    sender=sender, version=version)
            if not ok:
                return False, why, False
            return True, why, self._record(weight, staleness)

    def add(self, row, weight: float, staleness: float) -> bool:
        """Insert one result; True when the buffer reached capacity.
        Streaming mode folds the row into the accumulator instead of
        storing it.  `row` may lie on the host or on the buffer's device;
        it is read before this returns, so the caller may reuse it."""
        with self._lock:
            self._check_room()
            if self.streaming:
                if self.buckets > 1:
                    b = self._next_bucket()
                    self._accs[b], self._wsums[b] = self._fold(
                        self._accs[b], self._wsums[b], row, weight, staleness)
                else:
                    self.acc, self.wsum = self._fold(
                        self.acc, self.wsum, row, weight, staleness)
            else:
                self.rows[self.count].copy_(
                    torch.as_tensor(row, dtype=torch.float32))
            return self._record(weight, staleness)

    def add_sparse(self, idx, vals, weight: float, staleness: float) -> bool:
        """Insert one SPARSE result: scatter the k (global row index,
        value) pairs of a sparse_topk frame through the sparse fold.
        Streaming B = 1 only: the bucketed path and the admission screen
        need dense rows."""
        with self._lock:
            if not self.streaming:
                raise RuntimeError(
                    "add_sparse() on a drain-mode AsyncBuffer — sparse "
                    "arrivals ride the streaming fold")
            if self.buckets > 1:
                raise RuntimeError(
                    "add_sparse() on a bucketed AsyncBuffer — the robust "
                    "bucket screens need dense rows; decode the frame via "
                    "decode_into instead")
            self._check_room()
            if self._sparse_fold is None:
                self._sparse_fold = make_sparse_fold_fn(*self._staleness_args)
            self.acc, self.wsum = self._sparse_fold(
                self.acc, self.wsum, idx, vals, weight, staleness)
            return self._record(weight, staleness)

    def _reset_lanes(self) -> None:
        self.weights[:] = 0.0
        self.staleness[:] = 0.0
        self.count = 0
        if self.streaming:
            self.raw_wsum = 0.0

    def drain(self):
        """(rows [K, P], weights [K], staleness [K], n_real), padded to
        capacity with zero-weight lanes; resets the buffer.  Drain mode
        only."""
        with self._lock:
            if self.streaming:
                raise RuntimeError(
                    "drain() on a streaming AsyncBuffer — use take_stream()")
            out = (self.rows.clone(), self.weights.copy(),
                   self.staleness.copy(), self.count)
            self.rows.zero_()
            self._reset_lanes()
            return out

    def take_stream(self):
        """(acc [P], wsum, weights [K], staleness [K], n_real, raw_wsum),
        the streaming commit's inputs; resets the buffer.  Streaming B = 1
        only."""
        with self._lock:
            if not self.streaming:
                raise RuntimeError(
                    "take_stream() on a drain-mode AsyncBuffer — use "
                    "drain()")
            if self.buckets > 1:
                raise RuntimeError(
                    "take_stream() on a bucketed AsyncBuffer — use "
                    "take_stream_buckets()")
            out = (self.acc, self.wsum, self.weights.copy(),
                   self.staleness.copy(), self.count, self.raw_wsum)
            self.acc, self.wsum = self._zero_acc()
            self._reset_lanes()
            return out

    def take_stream_buckets(self):
        """(accs [B, P], wsums [B], weights [K], staleness [K], n_real,
        raw_wsum), the bucketed commit's inputs; resets the buffer.  Any
        streaming buffer (B = 1 stacks its one accumulator)."""
        with self._lock:
            if not self.streaming:
                raise RuntimeError("take_stream_buckets() on a drain-mode "
                                   "AsyncBuffer — use drain()")
            if self.buckets > 1:
                accs, wsums = torch.stack(self._accs), torch.stack(self._wsums)
                self._accs, self._wsums = self._zero_buckets()
            else:
                accs, wsums = self.acc[None, :], self.wsum[None]
                self.acc, self.wsum = self._zero_acc()
            out = (accs, wsums, self.weights.copy(), self.staleness.copy(),
                   self.count, self.raw_wsum)
            self._reset_lanes()
            return out

    def state(self) -> dict:
        """Checkpointable snapshot of host numpy arrays (the JAX package's
        keys), restored by load_state.  Streaming mode carries the
        accumulator fields instead of the row matrix; a bucketed buffer
        also its assignment-stream position."""
        with self._lock:
            common = {"weights": self.weights.copy(),
                      "staleness": self.staleness.copy(),
                      "count": np.asarray(self.count, np.int64)}
            if not self.streaming:
                common["rows"] = self.rows.cpu().numpy().copy()
                return common
            if self.buckets > 1:
                accs, wsums = self._accs, self._wsums
                common["bucket_draws"] = np.asarray(self._bucket_draws,
                                                    np.int64)
            else:
                accs, wsums = [self.acc], [self.wsum]
            acc = np.stack([a.cpu().numpy() for a in accs])
            wsum = np.stack([w.cpu().numpy() for w in wsums])
            if self.buckets == 1:
                acc, wsum = acc[0], wsum[0]
            common.update(acc=acc, wsum=wsum,
                          raw_wsum=np.asarray(self.raw_wsum, np.float64))
            return common

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def load_state(self, state: dict) -> None:
        with self._lock:
            w = np.asarray(state["weights"], np.float32)
            if w.shape != self.weights.shape:
                raise ValueError(
                    f"async buffer shape mismatch: checkpoint weights "
                    f"{w.shape} vs configured {self.weights.shape} "
                    f"(buffer_k changed)")
            np.copyto(self.weights, w)
            np.copyto(self.staleness,
                      np.asarray(state["staleness"], np.float32))
            self.count = int(state["count"])
            if not self.streaming:
                if "rows" not in state:
                    raise ValueError(
                        "streaming-buffer checkpoint cannot restore into a "
                        "drain-mode AsyncBuffer: the row matrix is not "
                        "reconstructible from the accumulator")
                rows = np.asarray(state["rows"], np.float32)
                if tuple(rows.shape) != tuple(self.rows.shape):
                    raise ValueError(
                        f"async buffer shape mismatch: checkpoint "
                        f"{rows.shape} vs configured "
                        f"{tuple(self.rows.shape)} (buffer_k or model "
                        f"changed)")
                self.rows.copy_(torch.from_numpy(rows))
                return
            if "acc" in state:
                acc = np.asarray(state["acc"], np.float32)
                want = ((self.buckets, self.p) if self.buckets > 1
                        else (self.p,))
                if acc.shape != want:
                    raise ValueError(
                        f"async buffer shape mismatch: checkpoint acc "
                        f"{acc.shape} vs configured {want} (buckets or "
                        f"model changed)")
                wsum = np.asarray(state["wsum"], np.float32)
                if self.buckets > 1:
                    self._accs = [self._tensor(a) for a in acc]
                    self._wsums = [self._tensor(x) for x in wsum]
                    # resume the assignment stream where the saved run left
                    # it: post-resume inserts continue the same permutation
                    draws = int(state.get("bucket_draws", 0))
                    for _ in range(draws):
                        self._next_bucket()
                    self._bucket_draws = draws
                else:
                    self.acc, self.wsum = self._tensor(acc), self._tensor(wsum)
                self.raw_wsum = float(state.get(
                    "raw_wsum", float(np.sum(self.weights))))
            elif "rows" in state:
                # drain-mode state into a streaming buffer: replay the saved
                # rows through the fold, bitwise the live arrivals' state
                rows = np.asarray(state["rows"], np.float32)
                if rows.shape[1] != self.p:
                    raise ValueError(
                        f"async buffer shape mismatch: checkpoint rows "
                        f"{rows.shape} vs row width {self.p}")
                if self.buckets > 1:
                    self._accs, self._wsums = self._zero_buckets()
                    for i in range(self.count):
                        b = self._next_bucket()
                        self._accs[b], self._wsums[b] = self._fold(
                            self._accs[b], self._wsums[b], rows[i],
                            self.weights[i], self.staleness[i])
                else:
                    self.acc, self.wsum = self._zero_acc()
                    for i in range(self.count):
                        self.acc, self.wsum = self._fold(
                            self.acc, self.wsum, rows[i], self.weights[i],
                            self.staleness[i])
                self.raw_wsum = float(np.sum(self.weights[:self.count]))
            else:
                raise ValueError(
                    "async buffer checkpoint carries neither 'acc' nor "
                    "'rows'")
