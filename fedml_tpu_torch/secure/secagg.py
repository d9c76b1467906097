"""Pairwise-mask additive secure aggregation (port of
fedml_tpu/secure/secagg.py; the masks, keyring, client rows, recovery
and DP are host numpy, bitwise equal to the JAX package's).

Bonawitz-style pairwise masking over the field primitives of
core/mpc.py:

* every client pair (i, j) owns a DH shared secret that seeds a
  counter-mode PRG stream (numpy Philox: key = the pairwise secret,
  counter HIGH word = the round index) of field elements;
* client i uploads ``quantize(weight·update) + Σ_{j>i} m_ij − Σ_{j<i}
  m_ij (mod p)``: every mask appears once with each sign, so the cohort
  sum cancels them exactly and the masked aggregate is BITWISE the plain
  fixed-point sum;
* the sample weight rides as ONE extra masked word at the row's end;
* dropout recovery: each client's DH secret key is BGW-shared across the
  cohort and escrowed at dispatch; at the commit barrier the survivors
  reconstruct a dead client's key, replay its pairwise streams and
  subtract the uncancelled masks.  Fewer survivors than the threshold
  fail BY NAME (:class:`SecAggBelowThreshold`).

Trust model (simulation grade): the keyring draws every client's secret
key from one seeded generator and the server holds the escrowed shares.
That keeps the protocol's ARITHMETIC (cancellation, threshold
reconstruction, below-threshold failure), not the trust boundary of a
real deployment.  Masking blinds the admission screen; the one
per-update check that survives is quantization's norm bound
(``mpc.quantize`` refuses a row whose fixed-point magnitude exceeds the
client's slice of the field's signed half-range).

The server's fold is the integer field fold of async_/staleness.py on
the server's device: int64 tensors, (acc + row) mod p.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Iterable, Optional

import numpy as np
import torch

from fedml_tpu_torch.core import mpc
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_SCALE = 2 ** 16


class SecAggBelowThreshold(RuntimeError):
    """A secure round's surviving set fell below the share-reconstruction
    threshold: the dead clients' uncancelled masks cannot be rebuilt, so
    the round fails by name instead of committing a mask-polluted
    aggregate."""


@dataclasses.dataclass
class SecAggConfig:
    """Knobs of the secure-aggregation data plane.

    threshold: minimum SURVIVING clients for a round to commit, and the
    BGW share count that reconstructs a dead client's key (0 = a majority
    of the cohort).  dp_clip/dp_noise: the private mode: each client clips
    its weighted update to dp_clip and adds Gaussian noise of sigma
    dp_noise·dp_clip BEFORE quantizing and masking."""
    threshold: int = 0
    scale: int = DEFAULT_SCALE
    prime: int = mpc.DEFAULT_PRIME
    seed: int = 0
    dp_clip: Optional[float] = None
    dp_noise: float = 0.0

    def __post_init__(self):
        if self.threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {self.threshold}")
        if self.scale < 2:
            raise ValueError(f"scale must be >= 2, got {self.scale}")
        if self.dp_noise > 0.0 and self.dp_clip is None:
            raise ValueError("dp_noise needs dp_clip: the noise sigma is "
                             "calibrated to the per-client clip")

    def resolve_threshold(self, n_clients: int) -> int:
        t = self.threshold if self.threshold > 0 else n_clients // 2 + 1
        if not 1 <= t <= n_clients:
            raise ValueError(
                f"secagg threshold {t} outside [1, {n_clients}] for a "
                f"{n_clients}-client cohort")
        return t


def pairwise_mask(pair_key: int, round_idx: int, n_words: int,
                  p: int = mpc.DEFAULT_PRIME) -> np.ndarray:
    """Counter-mode PRG stream of `n_words` field elements for one pair at
    one round: Philox keyed by the DH pairwise secret, the round index in
    the counter's HIGH word, so rounds start 2^192 blocks apart and never
    overlap.  Same (key, round) -> same stream, which is what dropout
    recovery replays.  Returns int64 residues in [0, p)."""
    key = int(pair_key)
    bg = np.random.Philox(key=np.array([key & 0xFFFFFFFFFFFFFFFF,
                                        0x5EC466], dtype=np.uint64),
                          counter=np.array([0, 0, 0, int(round_idx)],
                                           dtype=np.uint64))
    return np.random.Generator(bg).integers(0, p, size=n_words,
                                            dtype=np.int64)


class SecAggKeyring:
    """Per-cohort DH key material and the escrowed key shares.  Client ids
    are the federation ranks (1..N).  ``escrow(cid)`` materializes the BGW
    shares of that client's secret key (at dispatch);
    ``reconstruct_sk(dead, survivors)`` rebuilds it, and raises
    :class:`SecAggBelowThreshold` below the threshold."""

    def __init__(self, client_ids: Iterable[int], threshold: int,
                 cfg: SecAggConfig):
        self.cfg = cfg
        self.ids = sorted(int(c) for c in client_ids)
        if len(set(self.ids)) != len(self.ids):
            raise ValueError(f"duplicate client ids in {self.ids}")
        self.threshold = int(threshold)
        p = cfg.prime
        rs = np.random.RandomState(cfg.seed)
        # secret keys in [2, p-2]: exclude the degenerate exponents
        self.sk = {c: int(rs.randint(2, p - 1)) for c in self.ids}
        self.pk = {c: mpc.pk_gen(self.sk[c], p=p) for c in self.ids}
        # escrowed BGW shares of sk, by owner: shares[owner][slot], slot k
        # held by self.ids[k] (built at dispatch)
        self._shares: dict[int, np.ndarray] = {}
        self._pos = {c: k for k, c in enumerate(self.ids)}

    def pair_key(self, a: int, b: int) -> int:
        """The symmetric DH pairwise secret of clients a and b."""
        return mpc.shared_key(self.pk[b], self.sk[a], self.cfg.prime)

    def escrow(self, cid: int) -> None:
        """Materialize the BGW shares of `cid`'s secret key (a polynomial of
        degree threshold−1).  Idempotent; seeded off (cfg.seed, cid), so
        every rank of a deployment escrows the same shares."""
        if cid in self._shares:
            return
        self._shares[cid] = mpc.BGW_encoding(
            np.array([self.sk[cid]], np.int64), len(self.ids),
            self.threshold - 1, self.cfg.prime,
            seed=(self.cfg.seed * 1_000_003 + cid) % (2 ** 31))

    def reconstruct_sk(self, dead: int, survivors: Iterable[int]) -> int:
        """Rebuild a dead client's secret key from the survivors' escrowed
        shares.  Fails by name below the threshold."""
        self.escrow(dead)
        surv = sorted(int(s) for s in set(survivors) if s != dead
                      and s in self._pos)
        if len(surv) < self.threshold:
            raise SecAggBelowThreshold(
                f"cannot reconstruct client {dead}'s pairwise masks: "
                f"{len(surv)} survivors hold shares, threshold is "
                f"{self.threshold} — the round must not commit")
        idx = np.array([self._pos[s] for s in surv[:self.threshold]],
                       np.int64)
        shares = self._shares[dead][idx]
        return int(mpc.BGW_decoding(shares, idx, self.cfg.prime)[0])


class SecureAggregator:
    """The aggregation-stage seam of the secure data plane, for the async
    server and its in-process clients.

    Client side: :meth:`client_row` quantizes the weighted flat update and
    the weight word and adds the pairwise masks.  Server side:
    :meth:`fold` is the field fold at arrival, on `device` (the card
    unless the caller names another); the arrived row is also kept until
    the barrier, because an uploaded-then-died client cannot be taken out
    of a running sum otherwise.  :meth:`commit` runs the unmask barrier
    and returns the (acc, wsum) pair the streaming commit consumes."""

    def __init__(self, cfg: SecAggConfig, client_ids: Iterable[int],
                 flat_dim: int, device=None):
        self.cfg = cfg
        self.dim = int(flat_dim)
        self.words = self.dim + 1            # + the masked weight word
        self.ids = sorted(int(c) for c in client_ids)
        self.threshold = cfg.resolve_threshold(len(self.ids))
        self.keyring = SecAggKeyring(self.ids, self.threshold, cfg)
        self.device = resolve_device(device)
        self._fold_fn = None                 # built at the first fold
        self._acc: Optional[torch.Tensor] = None   # int64 running field sum
        self._rows: dict[int, np.ndarray] = {}   # unmask-window retention
        self._lock = threading.Lock()
        self.below_threshold_rounds = 0
        self.recovered_rounds = 0            # commits that rebuilt masks

    # -- client side ---------------------------------------------------------
    def client_row(self, cid: int, round_idx: int, flat: np.ndarray,
                   weight: float) -> np.ndarray:
        """One client's masked uplink row: [quantize(weight·flat),
        quantize(weight)] plus the pairwise masks, as uint32 field words.
        The DP stage clips and noises the weighted update BEFORE
        quantization, from a generator derived per (seed, client, round).
        Quantization enforces the client's slice of the aggregate bound,
        |q| <= (p−1)//(2K) for a K-client cohort, so the field SUM never
        crosses the signed half-range."""
        p = self.cfg.prime
        x = np.asarray(flat, np.float64) * float(weight)
        if x.shape != (self.dim,):
            raise ValueError(f"client_row expects a [{self.dim}] flat "
                             f"row, got {x.shape}")
        if self.cfg.dp_clip is not None:
            nrm = float(np.linalg.norm(x))
            if nrm > self.cfg.dp_clip:
                x = x * (self.cfg.dp_clip / nrm)
            if self.cfg.dp_noise > 0.0:
                rng = np.random.default_rng(
                    (self.cfg.seed, 41, int(cid), int(round_idx)))
                x = x + rng.normal(
                    0.0, self.cfg.dp_noise * self.cfg.dp_clip, x.shape)
        head = (p - 1) // (2 * len(self.ids))
        q = np.empty((self.words,), np.int64)
        q[:self.dim] = mpc.quantize(x, self.cfg.scale, p, max_abs=head)
        q[self.dim] = mpc.quantize(np.array([float(weight)]),
                                   self.cfg.scale, p, max_abs=head)[0]
        for j in self.ids:
            if j == cid:
                continue
            m = pairwise_mask(self.keyring.pair_key(cid, j), round_idx,
                              self.words, p)
            q = (q + m) % p if cid < j else (q - m) % p
        return q.astype(np.uint32)

    # -- server side ---------------------------------------------------------
    @property
    def arrived(self) -> list[int]:
        with self._lock:
            return sorted(self._rows)

    @property
    def count(self) -> int:
        return len(self._rows)

    def escrow(self, cid: int) -> None:
        """Dispatch-time share escrow (see SecAggKeyring.escrow)."""
        self.keyring.escrow(cid)

    def _words(self, row: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(row.astype(np.int64)).to(self.device)

    def fold(self, cid: int, row) -> int:
        """The field fold at arrival; returns the arrived count.  A client's
        re-upload within one round replaces its kept row (the earlier one
        is backed out of the field sum first)."""
        from fedml_tpu_torch.async_.staleness import make_field_fold_fn
        if isinstance(row, torch.Tensor):
            row = row.cpu().numpy()
        row = np.ascontiguousarray(row, np.uint32)
        if row.shape != (self.words,):
            raise ValueError(f"secagg row must be [{self.words}] u32 "
                             f"words, got {row.shape}")
        if int(cid) not in self.keyring._pos:
            raise ValueError(f"unknown secagg client id {cid} "
                             f"(cohort is {self.ids})")
        with self._lock:
            if self._fold_fn is None:
                self._fold_fn = make_field_fold_fn(self.cfg.prime)
            if self._acc is None:
                self._acc = torch.zeros(self.words, dtype=torch.int64,
                                        device=self.device)
            prev = self._rows.pop(int(cid), None)
            if prev is not None:
                # additive inverse in the field: acc + (p - prev) mod p
                inv = (self.cfg.prime - prev.astype(np.int64)) % self.cfg.prime
                self._acc = self._fold_fn(self._acc, self._words(inv))
            self._acc = self._fold_fn(self._acc, self._words(row))
            self._rows[int(cid)] = row.copy()
            return len(self._rows)

    def field_sum(self, round_idx: int,
                  survivors: Iterable[int]) -> tuple[np.ndarray, list[int]]:
        """The unmask barrier in the field: (words int64 in [0, p), included
        ids).  Included = arrived ∩ survivors; an uploaded-then-died
        client's kept row is subtracted whole, then every non-included
        cohort member's masks against the included set are rebuilt from
        escrowed shares and backed out.  What remains is exactly
        Σ_{i∈included} quantize(w_i·x_i) mod p.  Raises
        SecAggBelowThreshold by name when the survivors cannot
        reconstruct."""
        p = self.cfg.prime
        with self._lock:
            rows = dict(self._rows)
            acc = (np.zeros((self.words,), np.int64) if self._acc is None
                   else self._acc.cpu().numpy().copy())
        survivors = sorted(int(s) for s in set(survivors))
        included = sorted(set(rows) & set(survivors))
        if len(survivors) < self.threshold:
            self.below_threshold_rounds += 1
            raise SecAggBelowThreshold(
                f"secure round {round_idx}: {len(survivors)} survivors "
                f"< threshold {self.threshold} — refusing to commit a "
                f"mask-polluted aggregate")
        for d in set(rows) - set(included):
            # uploaded then excluded: back the whole masked row out
            acc = (acc - rows[d].astype(np.int64)) % p
        dead = [c for c in self.ids if c not in included]
        if dead and included:
            self.recovered_rounds += 1
        for d in dead:
            # each included row carries one uncancelled mask for the pair
            # (i, d); replay d's streams from the reconstructed key
            sk_d = self.keyring.reconstruct_sk(d, survivors)
            for i in included:
                s = mpc.shared_key(self.keyring.pk[i], sk_d, p)
                m = pairwise_mask(s, round_idx, self.words, p)
                # client i applied +m if i < d else −m; subtract that
                acc = (acc - m) % p if i < d else (acc + m) % p
        return acc, included

    def commit(self, round_idx: int, survivors: Iterable[int],
               reset: bool = True) -> tuple[np.ndarray, float, list[int]]:
        """Unmask and dequantize: (acc f32 [dim] = Σ w_i·x_i, wsum = Σ w_i,
        included ids), the (acc, wsum) the streaming commit consumes.
        `reset` clears the round window."""
        words, included = self.field_sum(round_idx, survivors)
        total = mpc.dequantize(words, self.cfg.scale, self.cfg.prime)
        acc = total[:self.dim].astype(np.float32)
        wsum = float(total[self.dim])
        if reset:
            self.reset()
        return acc, wsum, included

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()
            self._acc = None

    def report(self) -> dict:
        return {"cohort": len(self.ids), "threshold": self.threshold,
                "below_threshold_rounds": self.below_threshold_rounds,
                "recovered_rounds": self.recovered_rounds}
