"""Seeded adversarial client simulator (port of
fedml_tpu/async_/adversary.py; host numpy, bitwise equal to the JAX
package's).

A byzantine cohort rides the client lifecycle (same dispatch path, same
latencies) but corrupts what it uploads.  Attack families, applied to
the flat f32 uplink row:

    signflip    row' = g − (row − g)          (reversed update direction)
    boost       row' = g + β·(row − g)        (scaled model replacement)
    gaussian    row' = row + σ·N(0, I)        (additive noise)
    labelflip   honest protocol, poisoned DATA (data/poison.py label flip)
    backdoor    honest protocol, pixel-trigger backdoor shards
    mixed       boost + labelflip together

Orthogonal modifiers: ``collude`` (every byzantine client at one model
version sends the IDENTICAL crafted row, from a per-version stream) and
``stale`` (``stale_lag`` extra latency per byzantine dispatch).

Determinism: the byzantine set is a seeded choice
(``default_rng([seed, 6])``) and every per-client corruption stream a
pure function of ``[seed, 7, client_id]`` (colluding draws of ``[seed,
8, version]``), so two sims with the same seed corrupt identically.
The rows here are host numpy: the engines move a byzantine lane's row
and global off the device, corrupt them, and move the result back.
"""
from __future__ import annotations

import dataclasses
import logging
import threading

import numpy as np
import torch

from fedml_tpu_torch import obs

log = logging.getLogger(__name__)

ATTACK_MODES = ("none", "signflip", "boost", "gaussian", "labelflip",
                "backdoor", "mixed")
# modes that corrupt the uplink row (vs. poisoning the training data)
_MODEL_ATTACKS = ("signflip", "boost", "gaussian", "mixed")
# modes that poison the attacker clients' shards
_DATA_ATTACKS = ("labelflip", "backdoor", "mixed")

_MAX_EVENTS = 50_000


@dataclasses.dataclass
class AttackConfig:
    """Knobs of the seeded adversarial cohort."""
    mode: str = "none"
    frac: float = 0.2                # byzantine fraction of the fleet
    boost: float = 10.0              # model-replacement scale β
    noise_std: float = 1.0           # gaussian attack σ
    target_label: int = 0            # label-flip / backdoor target
    poison_frac: float = 0.5         # poisoned fraction of attacker data
    collude: bool = False            # identical crafted rows per version
    stale: bool = False              # time uplinks to land stale
    stale_lag: float = 3.0           # extra latency (sim/real seconds)
    seed: int = 0

    def __post_init__(self):
        if self.mode not in ATTACK_MODES:
            raise ValueError(f"unknown attack mode {self.mode!r} "
                             f"(choose one of {ATTACK_MODES})")
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError(f"attack frac must be in [0, 1], got "
                             f"{self.frac}")


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class AdversarySim:
    """Seeded byzantine cohort.  Thread-safe (the messaging clients corrupt
    from concurrent threads); per-client streams are lazily created
    Generators keyed [seed, 7, client_id], so one client's corruption
    trace never depends on another's interleaving."""

    def __init__(self, cfg: AttackConfig, n_clients: int):
        self.cfg = cfg
        self.n_clients = n_clients
        self._lock = threading.Lock()
        self._streams: dict[int, np.random.Generator] = {}
        self.events: list[tuple] = []
        self.injected = 0                # unbounded (events list is capped)
        self._m_corrupted = obs.counter("async_attacks_injected_total")
        rng = np.random.default_rng([cfg.seed, 6])
        n_byz = int(round(cfg.frac * n_clients)) if cfg.mode != "none" else 0
        self.byzantine = (frozenset(
            int(c) for c in rng.choice(n_clients, size=n_byz, replace=False))
            if n_byz else frozenset())

    def is_byzantine(self, client_id: int) -> bool:
        return int(client_id) in self.byzantine

    def attacks_model(self) -> bool:
        return self.cfg.mode in _MODEL_ATTACKS

    def attacks_data(self) -> bool:
        return self.cfg.mode in _DATA_ATTACKS

    def _stream(self, client_id: int) -> np.random.Generator:
        with self._lock:
            st = self._streams.get(client_id)
            if st is None:
                st = self._streams[client_id] = np.random.default_rng(
                    [self.cfg.seed, 7, int(client_id)])
            return st

    def _record(self, kind: str, client_id: int, version: int) -> None:
        with self._lock:
            self.injected += 1
            if len(self.events) < _MAX_EVENTS:
                self.events.append((kind, int(client_id), int(version)))
        self._m_corrupted.inc()
        obs.instant(f"attack.{kind}", client=client_id, version=version)

    def trace(self) -> list[tuple]:
        with self._lock:
            return list(self.events)

    def stale_extra_latency(self, client_id: int) -> float:
        """Extra dispatch latency of a stale-attacking byzantine client (0
        otherwise)."""
        if self.cfg.stale and self.is_byzantine(client_id):
            return float(self.cfg.stale_lag)
        return 0.0

    def corrupt_row(self, client_id: int, row, global_row,
                    version: int = 0):
        """The model-level attack on one flat uplink row (numpy or a
        tensor; a corrupted row comes back as a fresh f32 numpy array).
        `global_row` is the model the client trained FROM; honest clients
        and data-only attacks pass `row` through unchanged."""
        c = self.cfg
        if not self.is_byzantine(client_id) or not self.attacks_model():
            return row
        row = _host(row)
        g = _host(global_row)
        if c.collude:
            # every colluder at this version sends g + β·σ·(a shared unit
            # direction), from a per-VERSION stream
            rng = np.random.default_rng([c.seed, 8, int(version)])
            d = rng.standard_normal(row.shape[0]).astype(np.float32)
            d *= np.float32(c.noise_std) / np.float32(
                max(np.linalg.norm(d), 1e-12))
            out = g + np.float32(c.boost) * d
            self._record("collude", client_id, version)
            return out
        if c.mode == "signflip":
            out = g - (row - g)
            self._record("signflip", client_id, version)
            return out
        if c.mode in ("boost", "mixed"):
            out = g + np.float32(c.boost) * (row - g)
            self._record("boost", client_id, version)
            return out
        # gaussian
        noise = self._stream(client_id).standard_normal(
            row.shape[0]).astype(np.float32)
        self._record("gaussian", client_id, version)
        return row + np.float32(c.noise_std) * noise

    def corrupt_update(self, client_id: int, new_vars: dict,
                       base_vars: dict, version: int = 0) -> dict:
        """Dict form of corrupt_row for the messaging clients: both dicts
        flattened in `new_vars`' order (unpadded), corrupted, and cut back
        into f32 numpy leaves of `new_vars`' shapes."""
        if not self.is_byzantine(client_id) or not self.attacks_model():
            return new_vars
        flat = lambda t: np.concatenate(
            [_host(t[k]).reshape(-1) for k in new_vars])
        row = self.corrupt_row(client_id, flat(new_vars), flat(base_vars),
                               version)
        out, off = {}, 0
        for k, leaf in new_vars.items():
            shape = tuple(leaf.shape)
            size = int(np.prod(shape)) if shape else 1
            out[k] = np.asarray(row[off:off + size], np.float32).reshape(shape)
            off += size
        return out


def apply_data_attack(data, cfg: AttackConfig, adversary: AdversarySim):
    """Poison the byzantine clients' shards for the data-level attacks
    (labelflip/backdoor/mixed) through data/poison.py: label-flip is
    poison_federated_data with trigger_fn=None, backdoor the pixel
    trigger.  Identity for model-only attacks."""
    if not adversary.attacks_data() or not adversary.byzantine:
        return data
    from fedml_tpu_torch.data.poison import (pixel_trigger,
                                             poison_federated_data)
    trigger = pixel_trigger if cfg.mode == "backdoor" else None
    return poison_federated_data(
        data, sorted(adversary.byzantine), cfg.target_label,
        poison_frac=cfg.poison_frac, trigger_fn=trigger, seed=cfg.seed)
