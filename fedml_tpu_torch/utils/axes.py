"""Named mesh axes bound for the code that runs inside a round.

JAX binds an axis name to the devices of a ``shard_map`` while the
program is traced, and a collective over an unbound name fails at trace
time.  The port's counterpart is a binding of the host exchange of a
mesh of ranks (``parallel/engine.py::MeshExchange``) for the code that
runs inside a round on this thread: the trainer's per-step gradient
fold over its `batch_axes` and ``sync_batch_norm``'s statistics fold
look their axis up here, and a lookup of an unbound name raises.

``bound(exchange)`` binds every axis of the exchange's mesh (a mesh of
one rank binds them too: its folds are the identity); `batch_norm_axes`
additionally makes every BatchNorm layer, synchronized or not, fold its
statistics over those axes, which is what XLA does for a plain flax
BatchNorm on a batch-sharded array (the centralized trainer's data
parallelism).

An exchange folds f32 host arrays left in mesh order, so every rank of
an axis group holds the same bits; no float goes through an all-reduce.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np

_state = threading.local()


class AxisEnv:
    """The exchange bound for a round, and the axes every BatchNorm folds
    over (None: only the synchronized ones, each over its own)."""

    def __init__(self, exchange, batch_norm_axes: Optional[tuple] = None):
        self.exchange = exchange
        self.batch_norm_axes = batch_norm_axes

    def check(self, axes: Sequence[str]) -> tuple:
        axes = tuple(axes)
        names = self.exchange.mesh.axis_names
        missing = [a for a in axes if a not in names]
        if missing:
            raise NameError(f"unbound axis name {missing[0]!r}: the bound "
                            f"mesh has axes {names}")
        return axes

    def size(self, axes: Sequence[str]) -> int:
        return len(self.exchange.mesh.axis_ranks(self.check(axes)))

    def fold(self, array: np.ndarray, axes: Sequence[str]) -> np.ndarray:
        """Every rank's f32 `array` along `axes`, folded left in mesh
        order (the array itself on an axis of one rank)."""
        axes = self.check(axes)
        if len(self.exchange.mesh.axis_ranks(axes)) == 1:
            return np.asarray(array, np.float32)
        return self.exchange.fold(np.ascontiguousarray(array, np.float32),
                                  axes)


def current() -> Optional[AxisEnv]:
    return getattr(_state, "env", None)


def lookup(axes: Sequence[str]) -> AxisEnv:
    """The bound environment that holds `axes`; raises when none does."""
    env = current()
    if env is None:
        raise NameError(f"unbound axis name {tuple(axes)[0]!r}: no mesh is "
                        f"bound on this thread (a mesh engine binds its "
                        f"mesh for the round)")
    env.check(axes)
    return env


@contextlib.contextmanager
def bound(exchange, batch_norm_axes: Optional[Sequence[str]] = None):
    """Bind every axis of `exchange.mesh` on this thread for the block."""
    prev = current()
    _state.env = AxisEnv(exchange, None if batch_norm_axes is None
                         else tuple(batch_norm_axes))
    try:
        yield _state.env
    finally:
        _state.env = prev
