"""The chunked engines (port of fedml_tpu/parallel/engine.py:
MeshFedAvgEngine, MeshFedProxEngine, MeshFedOptEngine, MeshFedNovaEngine,
MeshRobustEngine), on one card or over a client-axis mesh of ranks.

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

The run loop can upload round k+1's cohort while round k trains
(`streaming`, `prefetch`), and `stream_block` streams a cohort through
the round in blocks (MeshRobustEngine's order statistics in two phases
through a pinned host matrix); see MeshFedAvgEngine and
parallel/prefetch.py.  The `_twolevel_*` programs split a round into
per-block partials and one commit for the multi-process runner
(parallel/multihost.py).

Over a mesh of ranks (`mesh=`, parallel/mesh.py: one process a device,
joined by torch.distributed over gloo) the cohort is padded to a
multiple of the client shards with zero-weight repeats of client 0
(`pad_ids`), each rank gathers and uploads only its share, trains it
through the chunk loop from its first GLOBAL lane, copies its sums to
the host as the two-level carry (the unpadded trainer vector, then the
scalar sums), and every rank gathers every rank's carry and folds them
in rank order on the host (the two-level runner's left fold), then
commits the same finalize and server update: one rank's result bits
are every rank's, and a run is the same bits every time.  No float sum
goes through an all-reduce.  The order statistics gather each rank's
trained rows into the replicated [K, P] f32 matrix instead.  A mesh of
one rank (the default) is the one-card engine, with no collective.

A mesh with a "batch" axis (``make_mesh_batch``) also splits every
client's per-step batch over the ranks of that axis (engine.py:366-385):
each rank uploads only its rows of every batch (``_batch_rows``), the
trainer (a copy, with ``batch_axes``) folds each step's gradient over the
batch group, and every rank of a batch group trains the same client
lanes to the same bits.  The cohort pads over the client axes only, and
each batch column of the mesh folds the round's sums over its own client
group: the columns hold the same bits, so no client shard is counted
twice (a column's fold is batch index 0's fold, on every column).  A
model with collections (BatchNorm statistics) is refused under a batch
axis unless ``allow_batch_stats=True`` says its BatchNorm is
``sync_batch_norm(axis_name="batch")``.  The round runs with the mesh's
axes bound (``utils/axes.py``), which the trainer's fold and the
synchronized BatchNorm read.
"""
from __future__ import annotations

import copy
import logging
import threading
import time
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
from fedml_tpu_torch.parallel.mesh import (BATCH_AXIS, Mesh, batch_sharding,
                                           client_axes, client_sharding)
from fedml_tpu_torch.parallel.multihost import (fold_block_partials,
                                                make_local_mesh)
from fedml_tpu_torch.parallel.prefetch import (AsyncValue, InlineFetcher,
                                               Prefetcher, upload)
from fedml_tpu_torch.utils import axes as mesh_axes
from fedml_tpu_torch.utils.config import FedConfig
from fedml_tpu_torch.utils.profiling import TransferOverlapStats

log = logging.getLogger(__name__)


def cast_local(variables: dict, dtype) -> dict:
    """Cast the float leaves to the LOCAL training dtype; None is the
    identity."""
    if dtype is None:
        return variables
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in variables.items()}


def pad_ids(ids: np.ndarray, n_shards: int):
    """THE cohort-padding policy of the mesh engines (host side): pad the
    sampled client ids to a mesh-size multiple with zero-weight repeats of
    client 0; wmask 0 drops them from every weighted sum."""
    ids = np.asarray(ids)
    pad = (-len(ids)) % n_shards
    wmask = np.concatenate([np.ones(len(ids), np.float32),
                            np.zeros(pad, np.float32)])
    ids = np.concatenate([ids, np.zeros(pad, ids.dtype)])
    return ids, wmask


def sums_to_host(trainer: ClientTrainer, sums: tuple) -> np.ndarray:
    """Linear sums (a flat f32 vector, then 0-d scalars) as one flat f32
    host vector: the unpadded vector, then the scalars.  The copy off the
    card is synchronous, so no fold reads a half-copied vector."""
    num, *scalars = sums
    carry = torch.cat([num[:trainer.spec.n], torch.stack(
        [s.float().reshape(()) for s in scalars])])
    return carry.to("cpu").numpy()


def sums_from_host(trainer: ClientTrainer, flat_sums: np.ndarray,
                   n_scalars: int, device) -> tuple:
    """Inverse of `sums_to_host` on `device`: the vector zero-padded to the
    trainer's layout, each scalar a 0-d device tensor (a CPU scalar would
    divide as a multiply by its reciprocal on the card, which is not the
    one-card round's division)."""
    spec = trainer.spec
    carry = torch.from_numpy(np.array(flat_sums, np.float32)).to(device)
    if carry.numel() != spec.n + n_scalars:
        raise ValueError(f"a carry of {carry.numel()} elements against "
                         f"this engine's sums {spec.n} + {n_scalars}")
    num = torch.zeros(spec.padded, dtype=torch.float32, device=device)
    num[:spec.n] = carry[:spec.n]
    return (num, *(carry[spec.n + i] for i in range(n_scalars)))


class MeshExchange:
    """The host exchange of a mesh engine: gather host arrays along mesh
    axes and fold sums in rank order; each gather's wall, received bytes
    and axes are kept per call (`walls`, `bytes`, `axes`: the per-step
    gradient folds are the ("batch",) entries)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.walls: list[float] = []
        self.bytes: list[int] = []
        self.axes: list[tuple] = []

    def gather(self, array: np.ndarray, axes) -> list:
        if len(self.mesh.axis_ranks(axes)) == 1:
            return [array]
        t0 = time.perf_counter()
        with obs.span("mesh.gather", nbytes=int(array.nbytes)):
            parts = self.mesh.all_gather(array, axes)
        self.walls.append(time.perf_counter() - t0)
        self.bytes.append(int(array.nbytes) * (len(parts) - 1))
        self.axes.append(tuple(axes))
        return parts

    def log(self, axes) -> tuple:
        """(walls, bytes) of the gathers along exactly `axes`."""
        axes = tuple(axes)
        keep = [i for i, a in enumerate(self.axes) if a == axes]
        return ([self.walls[i] for i in keep], [self.bytes[i] for i in keep])

    def fold(self, array: np.ndarray, axes) -> np.ndarray:
        """Every rank's f32 `array` along `axes`, folded left in rank order
        on the host."""
        parts = self.gather(array, axes)
        return fold_block_partials(dict(enumerate(parts)), len(parts))

    def fold_sums(self, trainer: ClientTrainer, sums: tuple, axes,
                  device) -> tuple:
        """Every rank's sums along `axes`, folded in rank order, back on
        `device`; the sums themselves when `axes` span one rank."""
        if len(self.mesh.axis_ranks(axes)) == 1:
            return sums
        return sums_from_host(trainer, self.fold(
            sums_to_host(trainer, sums), axes), len(sums) - 1, device)

    def gather_rows(self, rows: torch.Tensor, axes) -> torch.Tensor:
        """Every rank's [k, N] rows along `axes`, stacked in rank order, on
        the rows' device."""
        if len(self.mesh.axis_ranks(axes)) == 1:
            return rows
        parts = self.gather(rows.to("cpu").numpy(), axes)
        return torch.from_numpy(np.concatenate(parts)).to(rows.device)


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


def zero_sums(flat: torch.Tensor) -> tuple:
    """The chunk loop's zero carry: (num [P] f32, den, lsum) on `flat`'s
    device."""
    den = torch.zeros((), dtype=torch.float32, device=flat.device)
    return (torch.zeros(flat.shape[0], dtype=torch.float32,
                        device=flat.device), den, torch.zeros_like(den))


def chunked_weighted_train(trainer: ClientTrainer, flat: torch.Tensor,
                           cohort: dict, weights: torch.Tensor, epochs: int,
                           chunk_cap: int = 8,
                           fold_fn: Optional[Callable] = fedavg_fold,
                           emit_flat_params: bool = False, seed: int = 0,
                           round_idx: int = 0,
                           restore_x: Optional[Callable] = None,
                           carry: Optional[tuple] = None, lane0: int = 0,
                           batch_shard: Optional[int] = None):
    """Train the cohort chunk by chunk from the round's flat vector `flat`
    (in the local dtype), folding each chunk's trained [chunk, P] lanes
    into the flat f32 carry with ``fold_fn(num, lanes, w, chunk_shards)``.
    Lane i trains with ``client_generator(seed, round_idx, lane0 + i)``
    for dropout and augmentation (keyed on `batch_shard` too when each
    client's batch is split over ranks).  `restore_x` maps each chunk's
    shards before its clients train (the engine's dequantize of a uint8
    stack, engine.py:236-237), so what it makes is O(chunk).  Returns
    (num [P] f32, den = sum w, lsum = sum w*loss), continuing from `carry`
    (a (num, den, lsum) triple, folded into in place) when given: a
    block-streamed round carries one accumulator across its blocks, lane0
    being the block's first lane in the cohort.

    With `emit_flat_params` it also returns the [K, P] f32 matrix of
    trained rows, chunk-pad lanes dropped (engine.py:1339), for the
    order-statistic defenses, which fold only the collections
    (``fold_fn=None`` for a model without them)."""
    k = weights.shape[0]
    global_params = flat if trainer.prox_mu > 0 else None
    cohort, weights = pad_and_chunk(cohort, weights.float(), chunk_cap)
    if carry is None:
        carry = zero_sums(flat)
    num, den, lsum = carry
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
                                           lane0 + c * weights.shape[1] + j,
                                           flat.device, batch_shard))
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
    """FedAvg over chunks of `chunk` clients, on one card or over a
    client-axis mesh of ranks (`mesh`, the module docstring), with optional
    bf16 local masters (`local_dtype`) and narrower cohort storage
    (`stack_dtype`: torch.uint8 or torch.bfloat16; see the module
    docstring).  Aggregation is unchanged by either dtype: each client's
    weights enter the fold in f32 and the global model stays f32 across
    rounds.

    Every round gathers its cohort on the host and uploads it
    (``stream_cohort``).  `streaming=True` makes the run loop upload round
    k+1's cohort on a background thread while round k trains
    (`prefetch`, parallel/prefetch.py; two cohorts on the device at most).
    `stream_block` streams the cohort within the round, `stream_block`
    clients at a time (double-buffered when `prefetch`), the linear sums
    carried in one accumulator across blocks: device data memory is
    O(2 * stream_block), whatever the cohort.  `prefetch=False` is the
    strictly synchronous escape hatch, bitwise the same rounds.
    `transfer_stats` (utils/profiling.py) is always on.

    Its rounds count under the JAX program families: ``<stem>_streaming``
    for the round on an uploaded cohort (the port has no resident round),
    ``<stem>_blockstream`` for the block-streamed one.

    `mesh` (parallel/mesh.py) defaults to this process alone.  Over more
    than one rank every rank runs the same loop; only the mesh's first
    rank evaluates and writes checkpoints (every rank restores), and
    `exchange` keeps the host gathers' walls and bytes.  With
    `stream_block` over ranks each block splits evenly over the client
    shards (the block must be a multiple of them): every rank streams its
    share of every block through its producer thread into one
    accumulator, and the sums fold once at the end of the round, so a
    rank holds O(2 * stream_block / shards) clients on its device.  A
    "batch" mesh axis splits each client's batch (the module docstring;
    `allow_batch_stats`)."""

    _family_stem = "fedavg"

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, chunk: int | None = None, local_dtype=None,
                 stack_dtype=None, streaming: bool = False,
                 prefetch: bool = True, stream_block: Optional[int] = None,
                 device=None, mesh: Optional[Mesh] = None,
                 allow_batch_stats: bool = False):
        self.mesh = mesh if mesh is not None else make_local_mesh()
        self.client_axes = client_axes(self.mesh)
        self.shard = client_sharding(self.mesh)
        self.n_shards = self.shard.count
        self.exchange = MeshExchange(self.mesh)
        self.allow_batch_stats = allow_batch_stats
        # the "batch" axis: each client's per-step batch over its ranks
        self.batch_axes = tuple(a for a in self.mesh.axis_names
                                if a == BATCH_AXIS)
        self.batch_shard = batch_sharding(self.mesh)
        if self.batch_axes:
            nb = self.mesh.shape[BATCH_AXIS]
            bs = int(np.shape(data.client_shards["mask"])[2])
            if bs % nb:
                raise ValueError(
                    f"batch mesh axis ({nb}) must divide the per-step "
                    f"batch size ({bs})")
            if trainer.batch_axes != self.batch_axes:
                # never mutate the caller's trainer: another engine may
                # share it
                trainer = copy.copy(trainer)
                trainer.batch_axes = self.batch_axes
        if stream_block is not None:
            if stream_block < 1:
                raise ValueError(f"stream_block must be >= 1, got "
                                 f"{stream_block}")
            if stream_block % self.n_shards:
                raise ValueError(
                    f"stream_block ({stream_block}) must be a multiple of "
                    f"the mesh's client shards ({self.n_shards}): every "
                    f"rank streams an equal share of each block")
            streaming = True
        self.streaming = streaming
        self.prefetch = prefetch
        self.stream_block = stream_block
        self.program_family = self._program_family_name(stream_block)
        super().__init__(trainer, data, cfg, device=device)
        self.round_fn_streaming = obs_programs.instrument(
            self.program_family, self.round_fn_streaming)
        if stream_block is not None:
            self.round_fn = obs_programs.instrument(
                self.program_family, self._blockstream_round_fn())
        self.transfer_stats = TransferOverlapStats()
        self._prefetched = None          # (round, AsyncValue) when streaming
        self._live_lock = threading.Lock()
        self.resident_block_bytes = 0    # uploaded blocks not yet retired
        self.peak_resident_block_bytes = 0
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

    def _program_family_name(self, stream_block) -> str:
        suffix = "blockstream" if stream_block is not None else "streaming"
        return f"{self._family_stem}_{suffix}"

    def _blockstream_round_fn(self):
        return self._round_blockstream

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

    def _host_gather_upload(self, ids) -> dict:
        """The one host-gather upload (shared by stream_cohort and the block
        uploads): slice the host arrays (the uint8 view when quantized),
        apply stack_dtype, copy to the device (pinned and asynchronous on
        the card); every byte counts in transfer_stats."""
        host = self._cast_stack_x({k: self._batch_rows(
            np.take(np.asarray(v), ids, axis=0))
            for k, v in self._host_shards().items()})
        self.transfer_stats.add_h2d_bytes(
            sum(v.numel() * v.element_size() for v in host.values()))
        return {k: upload(v, self.device) for k, v in host.items()}

    def _batch_rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's rows of every per-step batch (axis 2) of a gathered
        stack leaf under a "batch" axis (stack_leaf_sharding); the leaf
        itself otherwise."""
        if self.batch_shard is None or a.ndim < 3:
            return a
        return np.ascontiguousarray(a[:, :, self.batch_shard.rows(
            a.shape[2])])

    def _upload_weights(self, w: np.ndarray) -> torch.Tensor:
        w = np.ascontiguousarray(w, np.float32)
        self.transfer_stats.add_h2d_bytes(w.nbytes)
        return upload(torch.from_numpy(w), self.device)

    def _rank_ids(self, round_idx: int) -> tuple:
        """This rank's share of the round's cohort: (ids, wmask), the cohort
        padded to a multiple of the client shards (`pad_ids`); wmask is
        None on a mesh of one rank (no padding)."""
        ids = self.sampler.sample(round_idx)
        if self.n_shards == 1:
            return ids, None
        ids, wmask = pad_ids(ids, self.n_shards)
        rows = self.shard.rows(len(ids))
        return ids[rows], wmask[rows]

    def stream_cohort(self, round_idx: int):
        """Host-side gather of this rank's share of the round's sampled
        clients from `_host_shards()`, stack_dtype applied, uploaded to the
        engine's device: ({x, y, mask} [K, B, bs, ...], weights [K] f32)."""
        return self._stream_gather(*self._rank_ids(round_idx))

    def _stream_gather(self, ids, wmask=None):
        """The upload half of stream_cohort, split from the sampling: this
        part runs on the prefetch thread, while the sampler (it reseeds the
        process-global numpy RNG) stays on the caller's thread."""
        with obs.span("h2d.upload_cohort", clients=len(ids)), \
                self.transfer_stats.uploading():
            cohort = self._host_gather_upload(ids)
            w = np.take(np.asarray(self.data.client_num_samples, np.float32),
                        ids)
            if wmask is not None:
                w = w * wmask
            return cohort, self._upload_weights(w)

    def _local_train_stack(self) -> dict:
        return self._cast_stack_x(self._host_shards())

    _local_eval_transform = _restore_chunk_x

    def _round_args(self, round_idx: int) -> tuple:
        if self.stream_block is not None:
            return (round_idx,)        # the round uploads its own blocks
        if not self.streaming:
            return (*self.stream_cohort(round_idx), round_idx)
        # round r+1's gather and upload run on a background thread while
        # round r trains; sampling stays on this thread, so the knob never
        # changes cohorts; two cohorts on the device at most.  Without the
        # prefetch the gather runs here, unhidden
        pre, self._prefetched = self._prefetched, None
        if pre is not None and pre[0] != round_idx:
            # a stale prefetch (rounds replayed out of order): join it
            # before gathering anew, so no third cohort is resident
            try:
                pre[1].result()
            except Exception:
                log.warning("discarding failed stale prefetch for round %d",
                            pre[0], exc_info=True)
            pre = None
        if pre is not None:
            args = pre[1].result()
        else:
            with self.transfer_stats.waiting():     # unhidden gather
                args = self.stream_cohort(round_idx)
        limit = getattr(self, "_rounds_limit", None)
        if self.prefetch and (limit is None or round_idx + 1 < limit):
            self._prefetched = (round_idx + 1, AsyncValue(
                self._stream_gather, *self._rank_ids(round_idx + 1),
                stats=self.transfer_stats, device=self.device))
        return (*args, round_idx)

    # -- the round ------------------------------------------------------------
    def _local_flat(self, variables: dict) -> torch.Tensor:
        """The round's global model as one flat vector in the local dtype."""
        return self.trainer.flatten(cast_local(variables, self.local_dtype))

    def _chunked(self, flat: torch.Tensor, cohort: dict,
                 weights: torch.Tensor, round_idx: int, **kw):
        """chunked_weighted_train with the engine's epochs, chunk, seed and
        dequantize, under the mesh's bound axes; a client split over batch
        ranks keys its generator on its batch index."""
        split = self.batch_shard is not None and self.batch_shard.count > 1
        with mesh_axes.bound(self.exchange):
            return chunked_weighted_train(
                self.trainer, flat, cohort, weights, self.cfg.epochs,
                chunk_cap=self.chunk, seed=self.cfg.seed,
                round_idx=round_idx, restore_x=self._restore_chunk_x,
                batch_shard=self.batch_shard.index if split else None, **kw)

    def run(self, variables: Optional[dict] = None,
            rounds: Optional[int] = None, logger=None, ckpt=None,
            ckpt_every: int = 0, resume: bool = False) -> dict:
        """FedAvgEngine.run, after refusing a model with collections under
        a batch axis unless `allow_batch_stats` (engine.py:976-985)."""
        if self.batch_axes and not self.allow_batch_stats \
                and self.trainer.n_stats:
            raise ValueError(
                f"model carries a stats collection "
                f"({list(self.trainer.stat_names)[:4]}...) and the mesh "
                "has a 'batch' axis: plain BatchNorm would normalize by "
                "shard-local statistics.  Use per-sample normalization "
                "(GroupNorm/LayerNorm), or sync_batch_norm(axis_name="
                "'batch') (models/norms.py) and pass "
                "allow_batch_stats=True")
        return super().run(variables, rounds, logger=logger, ckpt=ckpt,
                           ckpt_every=ckpt_every, resume=resume)

    def _fold_fn(self, g: torch.Tensor) -> Callable:
        """The chunk fold of this engine's linear sums (g: the round's model
        in the local dtype)."""
        return fedavg_fold

    def _zero_sums(self, g: torch.Tensor) -> tuple:
        """The zero carry of this engine's linear sums."""
        return zero_sums(g)

    def _accumulate(self, g: torch.Tensor, sums: tuple, cohort: dict,
                    weights: torch.Tensor, round_idx: int, lane0: int = 0):
        """Train `cohort` (lanes lane0.. of the round) from g and fold it
        into the carried sums; returns the new sums."""
        return self._chunked(g, cohort, weights, round_idx,
                             fold_fn=self._fold_fn(g), carry=sums,
                             lane0=lane0)

    def _lane0(self, weights: torch.Tensor) -> int:
        """This rank's first lane in the round's (padded) cohort: every rank
        holds an equal share, so lane j of rank r is global lane
        r * k + j, whatever the mesh."""
        return self.shard.index * weights.shape[0]

    def _shard_sums(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        """(sum w*v as a flat f32 vector, sum w, sum w*loss) over the
        cohort: this rank's share, then every rank's folded in rank order."""
        g = self._local_flat(variables)
        sums = self._accumulate(g, self._zero_sums(g), cohort, weights,
                                round_idx, lane0=self._lane0(weights))
        return self.exchange.fold_sums(self.trainer, sums, self.client_axes,
                                       self.device)

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

    # -- two-level (multi-process) programs (engine.py:700-791) ---------------
    # parallel/multihost.py::MultihostRunner splits a round into per-block
    # PARTIALS (this engine's linear sums over one block's cohort, through
    # the chunk loop and its fold kernels) and one replicated COMMIT after
    # the host fold of every block's flat carry.  The carry is the
    # unpadded trainer vector of the first sum followed by the engine's
    # scalar sums (P + 2 for FedAvg, P + 3 for FedNova): JAX's
    # flatten_carry_f32 length, its leaves in the trainer's order.  The
    # commit rebuilds the sums and runs _finalize_from_sums and
    # server_update, so FedNova's tau sums, FedOpt's optimizer and
    # norm_clip's weak-DP noise ride the two-level path unchanged.
    def _ensure_twolevel(self) -> None:
        """Refuse what cannot fold per block, then instrument the
        programs (once)."""
        if getattr(self, "_twolevel_ready", False):
            return
        if self.batch_axes and self.mesh.size > 1:
            raise ValueError(
                "MultihostRunner drives a client-axis local group; this "
                "engine's mesh has a 'batch' axis")
        if self.stream_block is not None:
            raise ValueError(
                "MultihostRunner does not drive block-streamed rounds "
                "yet: stream WITHIN a host via smaller blocks, or use "
                "streaming mode (per-block cohorts already bound device "
                "memory by O(block))")
        if getattr(self, "defense", "norm_clip") != "norm_clip":
            raise ValueError(
                f"two-level aggregation is linear: order-statistic "
                f"defense {self.defense!r} cannot fold per-host "
                f"partials (it needs the full [K, P] cohort matrix)")
        fam = f"{self._family_stem}_twolevel"
        self._twolevel_partial = obs_programs.instrument(
            fam, self._twolevel_partial_impl)
        self._twolevel_partial_resident = obs_programs.instrument(
            fam, self._twolevel_partial_resident_impl)
        self._twolevel_commit = obs_programs.instrument(
            "twolevel_commit", self._twolevel_commit_impl)
        self._twolevel_ready = True

    def _twolevel_partial_impl(self, variables: dict, cohort: dict,
                               weights: torch.Tensor, round_idx: int,
                               lane0: int) -> np.ndarray:
        """One block's partial from an uploaded block cohort: its lanes are
        lanes lane0.. of the round, so the clients' generators do not
        depend on which rank trains them.  Over a local group of ranks
        `cohort` is this rank's equal share of the block's (padded)
        lanes, and the ranks' sums are folded left in mesh order on the
        host (JAX psums them over its local mesh)."""
        g = self._local_flat(variables)
        carry = sums_to_host(self.trainer, self._accumulate(
            g, self._zero_sums(g), cohort, weights, round_idx,
            lane0=lane0 + self._lane0(weights)))
        if self.n_shards > 1:
            carry = self.exchange.fold(carry, self.client_axes)
        return carry

    def _twolevel_partial_resident_impl(self, variables: dict, stack: dict,
                                        stack_w: torch.Tensor, ids,
                                        round_idx: int,
                                        lane0: int) -> np.ndarray:
        """Resident variant: this rank's id-range stack lives on the
        device and the block cohort is an index-select by LOCAL id; the
        gathered values are the host gather's, bitwise.  A local group
        of ranks shares its resident rows through the runner instead
        (MultihostRunner._resident_share), so JAX's wmask has no
        counterpart here."""
        idx = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                              device=stack_w.device)
        cohort = {k: v.index_select(0, idx) for k, v in stack.items()}
        return self._twolevel_partial_impl(
            variables, cohort, stack_w.index_select(0, idx), round_idx, lane0)

    def _twolevel_commit_impl(self, variables: dict, server_state,
                              flat_sums: np.ndarray):
        """Replicated commit from the folded flat carry: rebuild the sums
        on the device (the pad of the first sum is zero), divide, apply
        the server update; every rank runs it identically."""
        n_scalars = len(self._zero_sums(torch.zeros(0))) - 1
        sums = sums_from_host(self.trainer, flat_sums, n_scalars,
                              self.device)
        avg, loss = self._finalize_from_sums(variables, sums)
        new_variables, server_state = self.server_update(avg, variables,
                                                         server_state)
        return new_variables, server_state, {"train_loss": loss}

    # -- the block-streamed round (stream_block) ------------------------------
    def _note_resident(self, nbytes: int) -> None:
        """Book a block's device bytes in (positive) or out (negative)."""
        with self._live_lock:
            self.resident_block_bytes += nbytes
            self.peak_resident_block_bytes = max(
                self.peak_resident_block_bytes, self.resident_block_bytes)

    def _upload_block(self, ids_blk: np.ndarray, w_blk: np.ndarray):
        """Gather and upload one client block (the double buffer's unit);
        runs on the prefetch thread when the pipeline is on."""
        with obs.span("h2d.upload_block", clients=len(ids_blk)), \
                self.transfer_stats.uploading():
            block = self._host_gather_upload(ids_blk)
            weights = self._upload_weights(w_blk)
        self._note_resident(sum(v.numel() * v.element_size()
                                for v in block.values()))
        return block, weights

    def _retire_block(self, block: dict) -> None:
        self._note_resident(-sum(v.numel() * v.element_size()
                                 for v in block.values()))

    def _pad_to_block(self, ids: np.ndarray, wmask: np.ndarray):
        """Pad the cohort to a stream_block multiple with zero-weight lanes
        repeating the first client (real data, so a pad lane trains to a
        finite row and adds +-0), and return the block spans."""
        B = self.stream_block
        pad = (-len(ids)) % B
        if pad:
            ids = np.concatenate([ids, np.repeat(ids[:1], pad)])
            wmask = np.concatenate([wmask, np.zeros(pad, np.float32)])
        return ids, wmask, [(s, s + B) for s in range(0, len(ids), B)]

    def _block_fetcher(self, ids: np.ndarray, w_all: np.ndarray, spans):
        """Block iterator of the streamed rounds: the background double
        buffer, or the synchronous inline path under prefetch=False; both
        deliver blocks in span order through get()."""
        def produce(span):
            s, e = span
            return self._upload_block(ids[s:e], w_all[s:e])

        with self._live_lock:       # an aborted stream's blocks are gone
            self.resident_block_bytes = 0
        cls = Prefetcher if self.prefetch else InlineFetcher
        return cls(produce, spans, stats=self.transfer_stats,
                   device=self.device)

    def _rank_spans(self, spans: list) -> list:
        """This rank's share of every block span: the i-th of the client
        shards' equal parts (the whole span on one rank)."""
        n, i = self.n_shards, self.shard.index
        return [(s + i * (e - s) // n, s + (i + 1) * (e - s) // n)
                for s, e in spans]

    def _round_blockstream(self, variables: dict, server_state,
                           round_idx: int = 0):
        """Block-streamed round: `stream_block`-client blocks cross to the
        device while the chunk loop folds them into one accumulator; one
        finalize divides and applies the server update.  Lane i of the
        cohort trains with the same generator as in the streaming round,
        and with the block a multiple of the chunk the same lanes fold in
        the same order, so on one rank the round is the streaming round's
        bitwise (pad lanes add +-0).  Over a mesh each rank streams its
        share of every block (`_rank_spans`) and the sums fold across
        ranks once, after the last block.  A retired block's references
        are dropped before the next get(): at most two blocks are
        resident."""
        ids = self.sampler.sample(round_idx)
        ids, wmask, spans = self._pad_to_block(
            ids, np.ones(len(ids), np.float32))
        spans = self._rank_spans(spans)
        w_all = np.take(np.asarray(self.data.client_num_samples, np.float32),
                        ids) * wmask
        self.transfer_stats.round_start()
        try:
            with obs.span("round.blockstream", round=int(round_idx),
                          clients=len(ids), blocks=len(spans)):
                g = self._local_flat(variables)
                sums = self._zero_sums(g)
                with self._block_fetcher(ids, w_all, spans) as fetch:
                    for i, (s, _e) in enumerate(spans):
                        block, w = fetch.get()
                        with obs.span("round.block_step", block=i):
                            sums = self._accumulate(g, sums, block, w,
                                                    round_idx, lane0=s)
                        self._retire_block(block)
                        del block, w
                sums = self.exchange.fold_sums(self.trainer, sums,
                                               self.client_axes, self.device)
                with obs.span("round.block_finalize"):
                    avg, loss = self._finalize_from_sums(variables, sums)
                    new_variables, server_state = self.server_update(
                        avg, variables, server_state)
                return new_variables, server_state, {"train_loss": loss}
        finally:
            self.transfer_stats.round_end()


class MeshFedProxEngine(MeshFedAvgEngine):
    """FedProx on the chunked engine: the proximal term lives in the
    trainer's loss; the aggregation is FedAvg's."""

    _family_stem = "fedprox"

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

    _family_stem = "fedopt"

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
    (engine.py:1158-1160).  Its sums are (d, sum w, sum w*tau, sum
    w*loss)."""

    _family_stem = "fednova"

    def _tau(self, shards: dict) -> torch.Tensor:
        """fednova_tau over the bound batch axes (a step counts when the
        unsplit batch has data)."""
        return fednova_tau(shards, self.cfg.epochs, self.batch_axes)

    def _fold_fn(self, g: torch.Tensor) -> Callable:
        r = self.trainer.train_len

        def nova_fold(num, lanes, w, chunk_shards):
            tau = self._tau(chunk_shards)
            clip_fold(num[:r], lanes[:, :r], g[:r],
                      (-w / torch.clamp(tau, min=1.0)).contiguous(), 0.0)
            fold_collections(self.trainer, num, lanes, w)

        return nova_fold

    def _zero_sums(self, g: torch.Tensor) -> tuple:
        dsum, den, lsum = zero_sums(g)
        return dsum, den, torch.zeros_like(den), lsum

    def _accumulate(self, g: torch.Tensor, sums: tuple, cohort: dict,
                    weights: torch.Tensor, round_idx: int, lane0: int = 0):
        dsum, den, tsum, lsum = sums
        dsum, den, lsum = self._chunked(g, cohort, weights, round_idx,
                                        fold_fn=self._fold_fn(g),
                                        carry=(dsum, den, lsum), lane0=lane0)
        with mesh_axes.bound(self.exchange):
            tau = self._tau(cohort)
        tsum = tsum + (weights.float() * tau).sum()
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
    """Byzantine-robust FedAvg on the chunked engine (engine.py:1197-1580).

    defense="norm_clip" (the reference's clip + weak DP) clips each client
    inside the chunk fold: sqnorm(lanes, g) -> s = clip_scale -> the
    clipped fold's accumulate form num += sum(w) * g + sum_k w_k s_k
    (v_k - g), which is the JAX engine's client_transform followed by its
    fold, with g the round's model in the local dtype.  Zero-weight pad
    lanes add nothing.  With cfg.stddev > 0 the server adds weak-DP noise
    from a generator the engine owns, seeded from cfg.seed.  Being linear,
    it block-streams like FedAvg.

    defense in {"krum", "multi_krum", "median", "trimmed_mean"} needs order
    statistics over the whole cohort's parameter vectors, which a weighted
    sum cannot express: the chunk loop keeps every client's trained row as
    the [K, P] f32 matrix and the defense runs there (over a mesh, each
    rank's rows gathered in rank order onto every rank, so the matrix and
    the defense are the one-card engine's; the cohort must divide evenly
    over the mesh).  With `stream_block`
    the round runs in two phases instead (the matrix never on the card):
    phase 1 streams client blocks through training and lands each block's
    parameter rows in a pinned host [K, P] f32 matrix; phase 2 streams it
    back parameter-major, [K, Pb] slices of `param_block_bytes`: median
    and trimmed mean sort each column (column-local, so bitwise the
    resident defense), krum accumulates the Gram matrix G = sum_b X_b X_b^T
    (TF32 off) and scores from it.  The cohort must be a block multiple:
    order statistics cannot ignore a padded lane.  Counts under the JAX
    families "robust_orderstat" and, block-streamed, "robust_blockstream"
    (norm_clip shares them)."""

    def __init__(self, trainer: ClientTrainer, data: FederatedData,
                 cfg: FedConfig, defense: str = "norm_clip",
                 n_byzantine: int = 0, multi_krum_m: Optional[int] = None,
                 param_block_bytes: int = 128 << 20, **kw):
        check_defense(defense)
        self.defense = defense
        self.n_byzantine = n_byzantine
        self.multi_krum_m = robust_ops.default_multi_krum_m(
            min(cfg.client_num_per_round, data.client_num), n_byzantine,
            multi_krum_m)
        self.param_block_bytes = int(param_block_bytes)
        stream_block = kw.get("stream_block")
        if defense != "norm_clip" and stream_block is not None:
            K = min(cfg.client_num_per_round, data.client_num)
            if K % stream_block:
                raise ValueError(
                    f"defense {defense!r} with stream_block needs the "
                    f"cohort ({K}) to be a block multiple ({stream_block}): "
                    "order statistics cannot ignore padded lanes")
        self.orderstat_host_bytes = 0   # the last two-phase round's matrix
        super().__init__(trainer, data, cfg, **kw)
        if defense != "norm_clip" and self.batch_axes:
            # a batch group's ranks hold the same client rows: the gathered
            # matrix would repeat them
            raise ValueError(f"defense {defense!r} does not support a "
                             f"'batch' mesh axis (norm_clip does)")
        if defense != "norm_clip" and stream_block is not None \
                and self.mesh.size > 1:
            raise ValueError(
                f"defense {defense!r} with stream_block over a mesh of "
                f"{self.mesh.size} ranks: the two-phase order statistics "
                "stream the whole [K, P] matrix through one host; run the "
                "resident order statistics over the mesh (no "
                "stream_block), or stream on one rank")
        K = min(cfg.client_num_per_round, data.client_num)
        if defense != "norm_clip" and K % self.n_shards:
            raise ValueError(
                f"defense {defense!r} needs the cohort ({K}) to divide "
                f"evenly over the mesh ({self.n_shards} shards): order "
                "statistics cannot ignore padded lanes")
        self.noise_generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

    def _program_family_name(self, stream_block) -> str:
        return ("robust_blockstream" if stream_block is not None
                else "robust_orderstat")

    def _blockstream_round_fn(self):
        return self._round_blockstream_orderstat

    def server_update(self, avg_variables: dict, global_variables: dict,
                      server_state):
        if self.defense == "norm_clip" and self.cfg.stddev > 0:
            avg_variables = robust_ops.add_weak_dp_noise(
                avg_variables, self.noise_generator, self.cfg.stddev)
        return avg_variables, server_state

    def _fold_fn(self, g: torch.Tensor) -> Callable:
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

        return clipped_fold

    def _collections_fold(self) -> Optional[Callable]:
        """The order-statistic rounds fold only the collections."""
        trainer = self.trainer
        if not trainer.n_stats:
            return None
        return lambda num, lanes, w, _: fold_collections(trainer, num,
                                                         lanes, w)

    def _orderstat_finalize(self, variables: dict, new_flat: torch.Tensor,
                            sums: tuple):
        num, den, lsum = sums
        r = self.trainer.train_len
        new = self.trainer.unflatten(torch.cat([new_flat, num[r:] / den]))
        return ({k: v.to(variables[k].dtype) for k, v in new.items()},
                lsum / den)

    def _shard_body(self, variables: dict, cohort: dict, weights: torch.Tensor,
                    round_idx: int = 0):
        if self.defense == "norm_clip":
            return super()._shard_body(variables, cohort, weights, round_idx)
        r = self.trainer.train_len
        num, den, lsum, flats = self._chunked(
            self._local_flat(variables), cohort, weights, round_idx,
            fold_fn=self._collections_fold(), emit_flat_params=True,
            lane0=self._lane0(weights))
        # over a mesh: the replicated [K, P] f32 matrix, rows in rank order
        flats = self.exchange.gather_rows(flats[:, :r], self.client_axes)
        num, den, lsum = self.exchange.fold_sums(
            self.trainer, (num, den, lsum), self.client_axes, self.device)
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
        return self._orderstat_finalize(variables, new_flat, (num, den, lsum))

    # -- the two-phase block-streamed order statistics ------------------------
    def _krum_scores_from_gram(self, G: np.ndarray) -> np.ndarray:
        """krum_scores_flat from the Gram matrix (host numpy: G is [K, K])."""
        sq = np.diag(G)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * G, 0.0)
        n = G.shape[0]
        k = max(n - self.n_byzantine - 2, 1)
        np.fill_diagonal(d2, np.inf)
        return np.sort(d2, axis=1)[:, :k].sum(axis=1)

    def _round_blockstream_orderstat(self, variables: dict, server_state,
                                     round_idx: int = 0):
        """Two-phase block-streamed robust round (class docstring): median
        and trimmed mean bitwise the resident defense; krum selects as the
        resident round does, up to the Gram's summation order in ties."""
        if self.defense == "norm_clip":      # linear: the base path streams
            return self._round_blockstream(variables, server_state,
                                           round_idx)
        ids = self.sampler.sample(round_idx)
        if len(ids) % self.stream_block:
            raise ValueError("order statistics cannot ignore padded lanes: "
                             f"cohort {len(ids)}, block {self.stream_block}")
        w_all = np.take(np.asarray(self.data.client_num_samples, np.float32),
                        ids)
        self.transfer_stats.round_start()
        try:
            with obs.span("round.blockstream_orderstat",
                          round=int(round_idx), clients=len(ids),
                          defense=self.defense):
                new_flat, sums = self._blockstream_orderstat_body(
                    variables, ids, w_all, round_idx)
                new, loss = self._orderstat_finalize(variables, new_flat,
                                                     sums)
                new, server_state = self.server_update(new, variables,
                                                       server_state)
                return new, server_state, {"train_loss": loss}
        finally:
            self.transfer_stats.round_end()

    def _blockstream_orderstat_body(self, variables: dict, ids: np.ndarray,
                                    w_all: np.ndarray, round_idx: int):
        B, K = self.stream_block, len(ids)
        r = self.trainer.train_len
        g = self._local_flat(variables)
        sums = zero_sums(g)
        # phase 1: client-major blocks; each block's parameter rows land in
        # the pinned host matrix, and the device copy is dropped at once
        X = torch.empty((K, r), dtype=torch.float32,
                        pin_memory=self.device.type == "cuda")
        self.orderstat_host_bytes = X.numel() * X.element_size()
        spans = [(s, s + B) for s in range(0, K, B)]
        with self._block_fetcher(ids, w_all, spans) as fetch:
            for s, e in spans:
                block, w = fetch.get()
                *sums, flats = self._chunked(
                    g, block, w, round_idx, fold_fn=self._collections_fold(),
                    emit_flat_params=True, carry=sums, lane0=s)
                X[s:e].copy_(flats[:, :r])
                self._retire_block(block)
                del block, w, flats
        # phase 2: parameter-major [K, Pb] slices back through the device
        pb = max(1, self.param_block_bytes // (K * 4))
        n_slices = -(-r // pb)

        def slice_up(i):
            # inline on the round loop: transfer and consumer wait at once
            with self.transfer_stats.uploading(), \
                    self.transfer_stats.waiting():
                xb = X[:, i * pb:(i + 1) * pb].contiguous()
                self.transfer_stats.add_h2d_bytes(
                    xb.numel() * xb.element_size())
                return upload(xb, self.device)

        if self.defense in ("krum", "multi_krum"):
            G = torch.zeros((K, K), dtype=torch.float32, device=self.device)
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                for i in range(n_slices):
                    xb = slice_up(i)
                    G += xb @ xb.T
                    del xb
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            scores = self._krum_scores_from_gram(G.cpu().numpy())
            self.last_krum_scores = scores
            if self.defense == "krum":
                new_flat = X[int(np.argmin(scores))]
            else:
                idx = np.argsort(scores, kind="stable")[:self.multi_krum_m]
                new_flat = X[torch.as_tensor(idx)].to(self.device).mean(dim=0)
        else:
            out = torch.empty(r, dtype=torch.float32, device=self.device)
            for i in range(n_slices):
                xb = slice_up(i)
                out[i * pb:(i + 1) * pb] = (
                    robust_ops.median_axis0(xb) if self.defense == "median"
                    else robust_ops.trimmed_mean_axis0(
                        xb, max(self.n_byzantine, 1)))
                del xb
            new_flat = out
        return new_flat.to(self.device), tuple(sums)
