"""The chunked engines on one card: the single-device subset of
fedml_tpu/parallel/engine.py (MeshFedAvgEngine, MeshFedProxEngine,
MeshFedOptEngine, MeshFedNovaEngine, MeshRobustEngine).

A round trains the cohort in chunks of at most `chunk` clients.  Every
client of a chunk trains from the round's global model (cast once to the
local dtype: bf16 local masters on the main path), its trained flat vector
becomes one row of a [chunk, P] lane matrix, and a fold folds the chunk
into ONE flat f32 accumulator: FedAvg's fold kernel adds sum_k w_k * row_k;
norm_clip's squared-distance and clipped-fold kernels add the clipped
rows; FedNova's clipped-fold adds sum_k (w_k / tau_k) * (g - row_k).
Beside it ride sum(w) and sum(w * loss); finalize divides in f32 and casts
back to the global model's dtype (engine.py:653-660), so the global model
stays f32.  The order-statistic defenses (krum, multi-krum, median,
trimmed mean) keep the chunk's rows instead, as the [K, P] f32 matrix they
need.

A row is the trainer's flat vector: the parameters, then the collections
(BatchNorm statistics) and the zero pad.  FedAvg folds the whole row in
one launch, statistics and parameters alike (fedavg.py:74-84).  The other
engines apply their rule to the parameter segment ``[:trainer.train_len]``
only and fold the rest, statistics and pad, with the plain weighted fold
(engine.py:1101, :1158-1160, :1336): a norm clip or a server optimizer
applied to BatchNorm statistics would be a wrong result.

The JAX engine vmaps a chunk's clients; ``torch.func.vmap`` cannot map
over a ctypes kernel, so here a chunk's lanes run one after another.
`stack_dtype` stores the client stack's input leaf ("x") in a narrower
dtype for the host gather and the upload (engine.py:338-364): bf16 (cast
on the host before the upload) or uint8 with an affine DequantSpec
(data/quant.py), which the chunk loop undoes on the device as the first
operation of each chunk (`_restore_chunk_x`), so dequantized memory is
O(chunk).  A loader-quantized stack (`load_data(store_uint8=True)`) is
dequantized with or without the knob.  y and mask never change dtype,
and integer inputs (token ids) are never cast or quantized.

Multi-card meshes, block streaming and upload prefetch are later slices
of the port (ROADMAP.md).
"""
from __future__ import annotations

import copy
import logging
from typing import Callable, Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import programs as obs_programs
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.algorithms.fedavg_robust import check_defense
from fedml_tpu_torch.algorithms.fednova import fednova_tau
from fedml_tpu_torch.algorithms.fedopt import make_server_optimizer, server_step
from fedml_tpu_torch.core import robust as robust_ops
from fedml_tpu_torch.core.pytree import clip_scale
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.data.quant import quantize_uint8, spec_from_minmax
from fedml_tpu_torch.ops.aggregate import client_sqnorms, clip_fold, fold
from fedml_tpu_torch.utils.config import FedConfig

log = logging.getLogger(__name__)


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


def fedavg_fold(num: torch.Tensor, lanes: torch.Tensor, w: torch.Tensor,
                chunk_shards: dict) -> None:
    """FedAvg's chunk fold: num += sum_k w_k * lanes[k] (the fold kernel)."""
    fold(num, lanes, w)


def fold_collections(trainer: ClientTrainer, num: torch.Tensor,
                     lanes: torch.Tensor, w: torch.Tensor) -> None:
    """The plain weighted fold of the segment after the parameters
    (collections and pad), where a model has collections."""
    if trainer.n_stats:
        r = trainer.train_len
        fold(num[r:], lanes[:, r:], w)


def chunked_weighted_train(trainer: ClientTrainer, flat: torch.Tensor,
                           cohort: dict, weights: torch.Tensor, epochs: int,
                           chunk_cap: int = 8,
                           fold_fn: Optional[Callable] = fedavg_fold,
                           emit_flat_params: bool = False, seed: int = 0,
                           round_idx: int = 0,
                           restore_x: Optional[Callable] = None):
    """Train the cohort chunk by chunk from the round's flat vector `flat`
    (in the local dtype), folding each chunk's trained [chunk, P] lanes
    into the flat f32 carry with ``fold_fn(num, lanes, w, chunk_shards)``.
    Lane i trains with ``client_generator(seed, round_idx, i)`` for
    dropout and augmentation.  `restore_x` maps each chunk's shards before
    its clients train (the engine's dequantize of a uint8 stack, engine.py
    :236-237), so what it makes is O(chunk).  Returns (num [P] f32,
    den = sum w, lsum = sum w*loss).

    With `emit_flat_params` it also returns the [K, P] f32 matrix of
    trained rows, chunk-pad lanes dropped (engine.py:1339), for the
    order-statistic defenses, which fold only the collections
    (``fold_fn=None`` for a model without them)."""
    k = weights.shape[0]
    global_params = flat if trainer.prox_mu > 0 else None
    cohort, weights = pad_and_chunk(cohort, weights.float(), chunk_cap)
    num = torch.zeros(flat.shape[0], dtype=torch.float32, device=flat.device)
    den = torch.zeros((), dtype=torch.float32, device=flat.device)
    lsum = torch.zeros_like(den)
    rows = []
    for c in range(weights.shape[0]):
        chunk_shards = {key: t[c] for key, t in cohort.items()}
        if restore_x is not None:
            chunk_shards = restore_x(chunk_shards)
        lanes, losses = [], []
        for j in range(weights.shape[1]):
            v, loss, _ = trainer.local_train(
                flat, {key: t[j] for key, t in chunk_shards.items()}, epochs,
                global_params=global_params,
                generator=client_generator(seed, round_idx,
                                           c * weights.shape[1] + j,
                                           flat.device))
            lanes.append(v)
            losses.append(loss)
        lanes = torch.stack(lanes)
        cw = weights[c].contiguous()
        if fold_fn is not None:
            fold_fn(num, lanes, cw, chunk_shards)
        if emit_flat_params:
            rows.append(lanes.float())
        den = den + cw.sum()
        lsum = lsum + (torch.stack(losses) * cw).sum()
    if emit_flat_params:
        return num, den, lsum, torch.cat(rows)[:k]
    return num, den, lsum


class MeshFedAvgEngine(FedAvgEngine):
    """FedAvg over chunks of `chunk` clients on one card, with optional
    bf16 local masters (`local_dtype`) and narrower cohort storage
    (`stack_dtype`: torch.uint8 or torch.bfloat16; see the module
    docstring).  Aggregation is unchanged by either dtype: each client's
    weights enter the fold in f32 and the global model stays f32 across
    rounds.  Its rounds count under the JAX family of the round on an
    uploaded cohort (``round_fn_streaming``)."""

    program_family = "fedavg_streaming"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, chunk: int | None = None, local_dtype=None,
                 stack_dtype=None, device=None):
        super().__init__(trainer, data, cfg, device=device)
        self.round_fn_streaming = obs_programs.instrument(
            self.program_family, self.round_fn_streaming)
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if stack_dtype not in (None, torch.uint8) and not (
                isinstance(stack_dtype, torch.dtype)
                and stack_dtype.is_floating_point):
            raise ValueError(f"stack_dtype must be torch.uint8 or a float "
                             f"dtype, got {stack_dtype!r}")
        self.chunk = chunk if chunk is not None else default_chunk(local_dtype)
        self.local_dtype = local_dtype
        self.stack_dtype = stack_dtype
        self._stack_dtype_noop_warned = False
        self._x_dequant = None          # DequantSpec when the stack is uint8
        self._dequant_consts = None     # (scale, offset) on the device
        self._u8_host_shards = None     # the quantized host view (`data`
        #                                 stays untouched: it may be shared)
        x = data.client_shards.get("x")
        # a loader-quantized stack is dequantized even without the knob:
        # the dequantize is a correctness requirement, not a preference
        if stack_dtype == torch.uint8 or (
                x is not None and np.asarray(x).dtype == np.uint8):
            self._prepare_uint8_stack(data)

    # -- cohort upload --------------------------------------------------------
    def _prepare_uint8_stack(self, data: FederatedData) -> None:
        """Resolve the DequantSpec and the uint8 host view of the client
        stack, once: a loader-quantized stack passes through with
        `data.x_dequant`; a float stack is quantized here with a min/max
        spec into the engine's own view.  Integer inputs are refused with
        a warning and keep their dtype."""
        shards = data.client_shards
        x = np.asarray(shards["x"]) if "x" in shards else None
        if x is None or (x.dtype != np.uint8
                         and not np.issubdtype(x.dtype, np.floating)):
            if x is not None:
                self._warn_noop(x.dtype)
            return
        if x.dtype == np.uint8:
            spec = data.x_dequant
            if spec is None:
                raise ValueError(
                    "client stack x is uint8 but data.x_dequant is unset: "
                    "a uint8 stack needs its DequantSpec (load_data "
                    "store_uint8=True sets it)")
            self._u8_host_shards = shards
        else:
            spec = spec_from_minmax(x)
            self._u8_host_shards = {**shards, "x": quantize_uint8(x, spec)}
        self._x_dequant = spec
        self._dequant_consts = (torch.from_numpy(spec.scale).to(self.device),
                                torch.from_numpy(spec.offset).to(self.device))

    def _warn_noop(self, dtype) -> None:
        if not self._stack_dtype_noop_warned:
            self._stack_dtype_noop_warned = True
            log.warning("stack_dtype=%s ignored: the input leaf is %s "
                        "(token-id datasets keep integer inputs: casting or "
                        "quantizing would remap the vocabulary)",
                        self.stack_dtype, dtype)

    def _host_shards(self) -> dict:
        """The host-side client stack every upload gathers from: the uint8
        view when the stack is quantized, else the data's own shards."""
        return (self._u8_host_shards if self._u8_host_shards is not None
                else self.data.client_shards)

    def _cast_stack_x(self, shards: dict) -> dict:
        """numpy shards -> host tensors, with a float stack_dtype applied to
        a float input leaf (numpy has no bfloat16, so the cast is torch's,
        on the host, before the upload).  Integer inputs keep their dtype
        (bf16 holds integers exactly only up to 256); the uint8 view is
        already in its dtype."""
        out = {k: torch.from_numpy(np.asarray(v)) for k, v in shards.items()}
        if (self.stack_dtype is not None and self._x_dequant is None
                and "x" in out):
            if out["x"].is_floating_point():
                out["x"] = out["x"].to(self.stack_dtype)
            else:
                self._warn_noop(out["x"].dtype)
        return out

    def _restore_chunk_x(self, chunk_shards: dict) -> dict:
        """Dequantize one chunk's uint8 input on the device, x * scale +
        offset in f32 (the per-channel spec broadcasts over [..., h, w, c]);
        identity for a stack that is not quantized and for float leaves."""
        x = chunk_shards.get("x")
        if self._x_dequant is None or x is None or x.is_floating_point():
            return chunk_shards
        scale, offset = self._dequant_consts
        return {**chunk_shards, "x": x.float() * scale + offset}

    def stream_cohort(self, round_idx: int):
        """Host-side gather of the round's sampled clients from
        `_host_shards()`, stack_dtype applied, uploaded to the engine's
        device: ({x, y, mask} [K, B, bs, ...], weights [K] f32)."""
        ids = self.sampler.sample(round_idx)
        with obs.span("h2d.upload_cohort", clients=len(ids)):
            cohort = self._cast_stack_x({
                k: np.take(np.asarray(v), ids, axis=0)
                for k, v in self._host_shards().items()})
            w = np.take(np.asarray(self.data.client_num_samples, np.float32),
                        ids)
            return ({k: v.to(self.device) for k, v in cohort.items()},
                    torch.from_numpy(w).to(self.device))

    def _local_train_stack(self) -> dict:
        return self._cast_stack_x(self._host_shards())

    _local_eval_transform = _restore_chunk_x

    def _round_args(self, round_idx: int) -> tuple:
        return (*self.stream_cohort(round_idx), round_idx)

    # -- the round ------------------------------------------------------------
    def _local_flat(self, variables: dict) -> torch.Tensor:
        """The round's global model as one flat vector in the local dtype."""
        return self.trainer.flatten(cast_local(variables, self.local_dtype))

    def _chunked(self, flat: torch.Tensor, cohort: dict,
                 weights: torch.Tensor, round_idx: int, **kw):
        """chunked_weighted_train with the engine's epochs, chunk, seed and
        dequantize."""
        return chunked_weighted_train(
            self.trainer, flat, cohort, weights, self.cfg.epochs,
            chunk_cap=self.chunk, seed=self.cfg.seed, round_idx=round_idx,
            restore_x=self._restore_chunk_x, **kw)

    def _shard_sums(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        """(sum w*v as a flat f32 vector, sum w, sum w*loss) over the cohort."""
        return self._chunked(self._local_flat(variables), cohort, weights,
                             round_idx)

    def _finalize_from_sums(self, variables: dict, sums):
        """(aggregated model, mean loss): divide in f32, cast each leaf back
        to the global model's dtype."""
        num, den, lsum = sums
        avg = self.trainer.unflatten(num / den, torch.float32)
        return ({k: v.to(variables[k].dtype) for k, v in avg.items()},
                lsum / den)

    def _shard_body(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        """(aggregated model, mean loss) of the cohort: sums, then divide."""
        return self._finalize_from_sums(
            variables, self._shard_sums(variables, cohort, weights, round_idx))

    def round_fn_streaming(self, variables: dict, server_state, cohort: dict,
                           weights: torch.Tensor, round_idx: int = 0):
        """One round on an uploaded cohort (stream_cohort): returns
        (new variables, server state, {"train_loss"}).  `round_idx` seeds
        the clients' dropout generators."""
        avg, train_loss = self._shard_body(variables, cohort, weights,
                                           round_idx)
        new_variables, server_state = self.server_update(avg, variables,
                                                         server_state)
        return new_variables, server_state, {"train_loss": train_loss}

    round_fn = round_fn_streaming


class MeshFedProxEngine(MeshFedAvgEngine):
    """FedProx on the chunked engine: the proximal term lives in the
    trainer's loss; the aggregation is FedAvg's."""

    program_family = "fedprox_streaming"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, **kw):
        if trainer.prox_mu <= 0:
            # never mutate the caller's trainer: another engine may share it
            trainer = copy.copy(trainer)
            trainer.prox_mu = cfg.prox_mu
        super().__init__(trainer, data, cfg, **kw)


class MeshFedOptEngine(MeshFedAvgEngine):
    """Server-optimizer FL: the pseudo-gradient w_global - w_avg goes to
    `cfg.server_optimizer` (FedOptAggregator.py:94-123); its state persists
    across rounds in server_state."""

    program_family = "fedopt_streaming"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, **kw):
        self.server_tx = make_server_optimizer(
            cfg.server_optimizer, cfg.server_lr, cfg.server_momentum)
        super().__init__(trainer, data, cfg, **kw)

    def server_init(self, variables: dict):
        return self.server_tx.init({k: variables[k]
                                    for k in self.trainer.param_names})

    def server_update(self, avg_variables: dict, global_variables: dict,
                      server_state):
        return server_step(self.server_tx, avg_variables, global_variables,
                           server_state, self.trainer.param_names)


class MeshFedNovaEngine(MeshFedAvgEngine):
    """FedNova on the chunked engine (engine.py:1106-1194):
    d = sum_i w_i (g - v_i) / tau_i, w_new = g - tau_eff * d / sum(w) with
    tau_eff = sum_i w_i tau_i / sum(w).  The d-fold is the clipped-fold
    kernel's accumulate form with base 0 and cf = -w / max(tau, 1); g is
    the round's model in the local dtype, as the JAX engine's chunk body
    reads it.  The collections take the plain weighted mean
    (engine.py:1158-1160)."""

    program_family = "fednova_streaming"

    def _shard_sums(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        """(sum w*(g - v)/tau over the parameters then sum w*v over the
        collections, sum w, sum w*tau, sum w*loss)."""
        g = self._local_flat(variables)
        epochs, r = self.cfg.epochs, self.trainer.train_len

        def nova_fold(num, lanes, w, chunk_shards):
            tau = fednova_tau(chunk_shards, epochs)
            clip_fold(num[:r], lanes[:, :r], g[:r],
                      (-w / torch.clamp(tau, min=1.0)).contiguous(), 0.0)
            fold_collections(self.trainer, num, lanes, w)

        dsum, den, lsum = self._chunked(g, cohort, weights, round_idx,
                                        fold_fn=nova_fold)
        tsum = (weights.float() * fednova_tau(cohort, epochs)).sum()
        return dsum, den, tsum, lsum

    def _finalize_from_sums(self, variables: dict, sums):
        dsum, den, tsum, lsum = sums
        tau_eff = tsum / den
        r = self.trainer.train_len
        g = self.trainer.flatten(variables, torch.float32)
        new = self.trainer.unflatten(torch.cat(
            [g[:r] - tau_eff * dsum[:r] / den, dsum[r:] / den]))
        return ({k: v.to(variables[k].dtype) for k, v in new.items()},
                lsum / den)


class MeshRobustEngine(MeshFedAvgEngine):
    """Byzantine-robust FedAvg on the chunked engine (engine.py:1197-1375).

    defense="norm_clip" (the reference's clip + weak DP) clips each client
    inside the chunk fold: sqnorm(lanes, g) -> s = clip_scale -> the
    clipped fold's accumulate form num += sum(w) * g + sum_k w_k s_k
    (v_k - g), which is the JAX engine's client_transform followed by its
    fold, with g the round's model in the local dtype.  Zero-weight pad
    lanes add nothing.  With cfg.stddev > 0 the server adds weak-DP noise
    from a generator the engine owns, seeded from cfg.seed.

    defense in {"krum", "multi_krum", "median", "trimmed_mean"} needs order
    statistics over the whole cohort's parameter vectors, which a weighted
    sum cannot express: the chunk loop keeps every client's trained row as
    the [K, P] f32 matrix and the defense runs there.

    `stream_block` (the two-phase beyond-HBM order-statistic path) is a
    later slice of the port.  Every defense counts under the JAX family
    "robust_orderstat" (norm_clip shares it there too)."""

    program_family = "robust_orderstat"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, defense: str = "norm_clip",
                 n_byzantine: int = 0, multi_krum_m: Optional[int] = None,
                 stream_block: Optional[int] = None, **kw):
        check_defense(defense)
        if stream_block is not None:
            raise NotImplementedError(
                "MeshRobustEngine(stream_block=...), the block-streamed "
                "order-statistic path, is not ported yet (slice 6 of the port)")
        self.defense = defense
        self.n_byzantine = n_byzantine
        self.multi_krum_m = robust_ops.default_multi_krum_m(
            min(cfg.client_num_per_round, data.client_num), n_byzantine,
            multi_krum_m)
        super().__init__(trainer, data, cfg, **kw)
        self.noise_generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def server_update(self, avg_variables: dict, global_variables: dict,
                      server_state):
        if self.defense == "norm_clip" and self.cfg.stddev > 0:
            avg_variables = robust_ops.add_weak_dp_noise(
                avg_variables, self.noise_generator, self.cfg.stddev)
        return avg_variables, server_state

    def _shard_sums(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        g = self._local_flat(variables)
        bound, row = self.cfg.norm_bound, self.trainer.spec.padded
        r = self.trainer.train_len

        def clipped_fold(num, lanes, w, chunk_shards):
            # the norm is over the parameter segment: a row must be the
            # trainer's layout and nothing else
            if lanes.shape[1] != row:
                raise ValueError(f"norm_clip lanes hold {lanes.shape[1]} "
                                 f"elements, the trainer's layout {row}")
            s = clip_scale(client_sqnorms(lanes[:, :r], g[:r]), bound)
            clip_fold(num[:r], lanes[:, :r], g[:r], (w * s).contiguous(),
                      w.sum())
            fold_collections(self.trainer, num, lanes, w)

        return self._chunked(g, cohort, weights, round_idx,
                             fold_fn=clipped_fold)

    def _shard_body(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        if self.defense == "norm_clip":
            return super()._shard_body(variables, cohort, weights, round_idx)
        trainer, r = self.trainer, self.trainer.train_len
        num, den, lsum, flats = self._chunked(
            self._local_flat(variables), cohort, weights, round_idx,
            fold_fn=((lambda num, lanes, w, _: fold_collections(
                trainer, num, lanes, w)) if trainer.n_stats else None),
            emit_flat_params=True)
        flats = flats[:, :r]
        if self.defense == "krum":
            new_flat = flats[robust_ops.krum_select_flat(flats,
                                                         self.n_byzantine)]
        elif self.defense == "multi_krum":
            idx = robust_ops.multi_krum_select_flat(flats, self.n_byzantine,
                                                    self.multi_krum_m)
            new_flat = flats[idx].mean(dim=0)
        elif self.defense == "median":
            new_flat = robust_ops.median_axis0(flats)
        else:
            new_flat = robust_ops.trimmed_mean_axis0(
                flats, max(self.n_byzantine, 1))
        new = self.trainer.unflatten(torch.cat([new_flat, num[r:] / den]))
        return ({k: v.to(variables[k].dtype) for k, v in new.items()},
                lsum / den)
