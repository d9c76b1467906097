"""The chunked FedAvg engine on one card (the single-device subset of
fedml_tpu/parallel/engine.py::MeshFedAvgEngine).

A round trains the cohort in chunks of at most `chunk` clients.  Every
client of a chunk trains from the round's global model (cast once to the
local dtype: bf16 local masters on the main path), its trained flat vector
becomes one row of a [chunk, P] lane matrix, and the fold kernel adds
sum_k w_k * row_k into ONE flat f32 accumulator.  Beside it ride sum(w) and
sum(w * loss); finalize divides in f32 and casts back to the global
model's dtype (engine.py:653-660), so the global model stays f32.

The JAX engine vmaps a chunk's clients; ``torch.func.vmap`` cannot map
over a ctypes kernel, so here a chunk's lanes run one after another.
Multi-card meshes, block streaming and upload prefetch are later slices
of the port (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.ops.aggregate import fold
from fedml_tpu_torch.utils.config import FedConfig


def cast_local(variables: dict, dtype) -> dict:
    """Cast the float leaves to the LOCAL training dtype; None is the
    identity."""
    if dtype is None:
        return variables
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in variables.items()}


def pad_and_chunk(cohort: dict, weights: torch.Tensor, chunk_cap: int):
    """Balanced chunk sizing: ceil(k / cap) chunks with the lanes spread
    evenly (k=12, cap=8 gives 2x6, not 2x8); a cohort that is not a
    multiple is padded with zero-data, zero-weight lanes.  Returns
    (cohort, weights) reshaped to [n_chunks, chunk, ...]."""
    k = weights.shape[0]
    n_trips = -(-k // min(chunk_cap, k))
    chunk = -(-k // n_trips)
    pad = (-k) % chunk
    if pad:
        cohort = {key: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                  for key, a in cohort.items()}
        weights = torch.cat([weights, weights.new_zeros(pad)])
    n_chunks = (k + pad) // chunk
    resh = lambda a: a.reshape((n_chunks, chunk) + a.shape[1:])
    return {key: resh(a) for key, a in cohort.items()}, resh(weights)


def default_chunk(local_dtype) -> int:
    """The JAX engine's defaults (2 with bf16 local masters, else 8); they
    were chosen on its TPU, not measured for the port."""
    return 2 if local_dtype == torch.bfloat16 else 8


def chunked_weighted_train(trainer: ClientTrainer, variables: dict,
                           cohort: dict, weights: torch.Tensor, epochs: int,
                           chunk_cap: int = 8):
    """Train the cohort chunk by chunk, folding each chunk's trained lanes
    into the flat f32 carry.  Returns (num [P] f32 = sum w*v, den = sum w,
    lsum = sum w*loss)."""
    flat = trainer.flatten(variables)
    cohort, weights = pad_and_chunk(cohort, weights.float(), chunk_cap)
    num = torch.zeros(flat.shape[0], dtype=torch.float32, device=flat.device)
    den = torch.zeros((), dtype=torch.float32, device=flat.device)
    lsum = torch.zeros_like(den)
    for c in range(weights.shape[0]):
        lanes, losses = [], []
        for j in range(weights.shape[1]):
            v, loss, _ = trainer.local_train(
                flat, {k: t[c, j] for k, t in cohort.items()}, epochs)
            lanes.append(v)
            losses.append(loss)
        cw = weights[c].contiguous()
        fold(num, torch.stack(lanes), cw)
        den = den + cw.sum()
        lsum = lsum + (torch.stack(losses) * cw).sum()
    return num, den, lsum


class MeshFedAvgEngine(FedAvgEngine):
    """FedAvg over chunks of `chunk` clients on one card, with optional
    bf16 local masters (`local_dtype`).  Aggregation is unchanged by the
    local dtype: each client's weights enter the fold in f32 and the
    global model stays f32 across rounds."""

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, chunk: int | None = None, local_dtype=None,
                 device=None):
        super().__init__(trainer, data, cfg, device=device)
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.chunk = chunk if chunk is not None else default_chunk(local_dtype)
        self.local_dtype = local_dtype

    # -- cohort upload --------------------------------------------------------
    def stream_cohort(self, round_idx: int):
        """Host-side gather of the round's sampled clients, uploaded to the
        engine's device: ({x, y, mask} [K, B, bs, ...], weights [K] f32)."""
        ids = self.sampler.sample(round_idx)
        cohort = {k: torch.from_numpy(np.take(np.asarray(v), ids, axis=0))
                  .to(self.device) for k, v in self.data.client_shards.items()}
        w = np.take(np.asarray(self.data.client_num_samples, np.float32), ids)
        return cohort, torch.from_numpy(w).to(self.device)

    def _round_args(self, round_idx: int) -> tuple:
        return self.stream_cohort(round_idx)

    # -- the round ------------------------------------------------------------
    def _shard_sums(self, variables: dict, cohort: dict, weights: torch.Tensor):
        """(sum w*v as a flat f32 vector, sum w, sum w*loss) over the cohort."""
        return chunked_weighted_train(
            self.trainer, cast_local(variables, self.local_dtype), cohort,
            weights, self.cfg.epochs, chunk_cap=self.chunk)

    def _finalize_from_sums(self, variables: dict, sums):
        """(aggregated model, mean loss): divide in f32, cast each leaf back
        to the global model's dtype."""
        num, den, lsum = sums
        avg = self.trainer.unflatten(num / den, torch.float32)
        return ({k: v.to(variables[k].dtype) for k, v in avg.items()},
                lsum / den)

    def round_fn_streaming(self, variables: dict, server_state, cohort: dict,
                           weights: torch.Tensor):
        """One round on an uploaded cohort (stream_cohort): returns
        (new variables, server state, {"train_loss"})."""
        avg, train_loss = self._finalize_from_sums(
            variables, self._shard_sums(variables, cohort, weights))
        new_variables, server_state = self.server_update(avg, variables,
                                                         server_state)
        return new_variables, server_state, {"train_loss": train_loss}

    round_fn = round_fn_streaming
