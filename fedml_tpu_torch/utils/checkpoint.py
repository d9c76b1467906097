"""Round-level checkpoint and resume (port of fedml_tpu/utils/checkpoint.py).

The reference has essentially no FL-state checkpointing.  Here any
engine's (round_idx, variables, server_state) saves every N rounds and a
run resumes exactly: the per-round client sampler and the per-(seed,
round, lane) client generators make a resumed run bitwise the
uninterrupted one.

The on-disk format is the port's own (no orbax, and JAX's directories are
not read): one ``round-<N>.pt`` file per saved round, a ``torch.save`` of
host copies of every tensor, written to a temporary name and moved into
place with ``os.replace``, so a crash mid-save never leaves a torn
checkpoint behind.  Restore maps the tensors onto the device of the
caller's template.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import numpy as np
import torch

Pytree = Any
_NAME = re.compile(r"^round-(\d+)\.pt$")


def _to_host(tree):
    """Tensors -> CPU copies (numpy arrays and plain values as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _like(saved, template):
    """`saved` with each tensor moved to its template leaf's device (and,
    where the template is a numpy array, made one)."""
    if isinstance(template, dict) and isinstance(saved, dict):
        return {k: _like(v, template.get(k)) for k, v in saved.items()}
    if isinstance(template, (tuple, list)) and isinstance(saved,
                                                          (tuple, list)):
        return type(saved)(_like(s, t) for s, t in zip(saved, template))
    if isinstance(saved, torch.Tensor):
        if isinstance(template, torch.Tensor):
            return saved.to(template.device)
        if isinstance(template, np.ndarray):
            return saved.numpy()
    return saved


class FedCheckpointManager:
    """Save and restore (round_idx, variables, server_state[, extra_state])
    under `directory`, keeping the `max_to_keep` newest rounds."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, round_idx: int) -> str:
        return os.path.join(self.directory, f"round-{int(round_idx)}.pt")

    def rounds(self) -> list[int]:
        """The saved rounds, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, round_idx: int, variables: Pytree,
             server_state: Pytree = (),
             extra_state: Optional[Pytree] = None) -> None:
        """`extra_state` carries engine state beyond (variables,
        server_state): the async engines' buffer, version and registry,
        a robust engine's noise generator.  Written only when given."""
        state = {"round": int(round_idx), "variables": _to_host(variables),
                 "server_state": _to_host(server_state)}
        if extra_state is not None:
            state["extra_state"] = _to_host(extra_state)
        path = self._path(round_idx)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        for old in self.rounds()[:-self.max_to_keep]:
            try:
                os.unlink(self._path(old))
            except FileNotFoundError:
                pass

    def latest_round(self) -> Optional[int]:
        rounds = self.rounds()
        return rounds[-1] if rounds else None

    def latest_step_or_raise(self) -> int:
        step = self.latest_round()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return step

    def restore(self, variables_template: Pytree,
                server_state_template: Pytree = (),
                round_idx: Optional[int] = None,
                extra_template: Optional[Pytree] = None):
        """(round_idx, variables, server_state), each tensor on its
        template leaf's device; with `extra_template` the saved
        extra_state too, as a 4-tuple."""
        step = (round_idx if round_idx is not None
                else self.latest_step_or_raise())
        with open(self._path(step), "rb") as f:
            state = torch.load(f, map_location="cpu", weights_only=False)
        variables = _like(state["variables"], variables_template)
        server_state = _like(state["server_state"], server_state_template)
        if extra_template is not None:
            if "extra_state" not in state:
                raise ValueError(f"checkpoint of round {step} holds no "
                                 "extra_state")
            return (step, variables, server_state,
                    _like(state["extra_state"], extra_template))
        return step, variables, server_state

    def close(self) -> None:
        """Nothing runs in the background; kept for the JAX interface."""
