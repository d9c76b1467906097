"""Seeded client-lifecycle simulator and the async messaging FSM pair
(port of fedml_tpu/async_/lifecycle.py).

Cross-device federations are defined by client churn: heavy-tailed device
latencies, dropouts mid-round, rejoins minutes later (arXiv:2007.13518
§2).  `ClientLifecycle` is the ONE seeded source of that behaviour, shared
by both async execution paths:

* the virtual-time scheduler (async_/scheduler.py) draws latency, crash
  and rejoin per dispatch and advances a simulated clock, deterministic
  per seed;
* the REAL-thread FSM pair below (AsyncServerManager /
  AsyncClientManager) applies the same draws as real sleeps and dropped
  replies over any comm backend (INPROC for tests, TCP/GRPC across
  machines).

Latency families (per dispatch, scaled by a per-client speed factor
drawn once at construction):

    lognormal   scale · exp(sigma·N(0,1))
    pareto      scale · (1 + Pareto(alpha))
    none        0                                  (the degenerate pin)

On the card the server's buffer lives on its device: each uplink is
decoded on the host (into a scratch row, or zero-copy and flattened) and
folded by the arrival fold (kernel B.3's accumulate form), screened
first by the admission pipeline (kernels B.4 and B.5) when a defense is
configured; secure uplinks go through the int64 field fold.  Each
client trains on its own copy of the model: ``functional_call`` swaps a
module's tensors for the call, so clients in threads must not share one.
``checkpoint_dir`` saves the server's round state (``_ckpt_state``)
through utils/checkpoint.py every ``checkpoint_every`` commits, and
``resume=True`` restores the latest save at construction: the
crash-resume path.
"""
from __future__ import annotations

import copy
import dataclasses
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.async_.adversary import (AdversarySim, AttackConfig,
                                              apply_data_attack)
from fedml_tpu_torch.async_.defense import DefenseConfig, UpdateAdmission
from fedml_tpu_torch.async_.staleness import (AsyncBuffer, RowLayout,
                                              flat_dim, flatten_vars_row,
                                              make_bucket_commit_fn,
                                              make_commit_fn,
                                              make_stream_commit_fn)
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.obs import propagate
from fedml_tpu_torch.parallel.engine import cast_local
from fedml_tpu_torch.scale.registry import BANNED as _REG_BANNED
from fedml_tpu_torch.scale.registry import ClientRegistry
from fedml_tpu_torch.secure.secagg import (SecAggBelowThreshold, SecAggConfig,
                                           SecureAggregator)
from fedml_tpu_torch.utils.checkpoint import FedCheckpointManager
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

LATENCY_MODES = ("none", "lognormal", "pareto")


@dataclasses.dataclass
class LifecycleConfig:
    """Knobs of the seeded client-lifecycle model."""
    latency: str = "none"            # none | lognormal | pareto
    latency_scale: float = 1.0       # seconds (virtual or real)
    latency_sigma: float = 0.5       # lognormal spread
    pareto_alpha: float = 2.0        # pareto tail index (>1 for finite mean)
    heterogeneity: float = 0.0       # per-client speed-factor lognormal sigma
    dropout_prob: float = 0.0        # P(crash mid-round) per dispatch
    rejoin_prob: float = 1.0         # P(a crashed client ever rejoins)
    rejoin_delay_s: float = 5.0      # mean rejoin delay (exponential)
    seed: int = 0

    def __post_init__(self):
        if self.latency not in LATENCY_MODES:
            raise ValueError(f"unknown latency mode {self.latency!r} "
                             f"(choose one of {LATENCY_MODES})")
        if not 0.0 <= self.dropout_prob <= 1.0:
            raise ValueError(f"dropout_prob must be in [0, 1], got "
                             f"{self.dropout_prob}")


class ClientLifecycle:
    """Seeded per-client draw source.  All randomness flows through ONE
    np.random.Generator in call order, so a scheduler that processes
    events deterministically gets a deterministic fault schedule (bitwise
    the JAX package's)."""

    def __init__(self, cfg: LifecycleConfig, n_clients: int):
        self.cfg = cfg
        self.n_clients = n_clients
        self._rng = np.random.default_rng(cfg.seed)
        # the messaging FSM draws from concurrent client threads: the lock
        # keeps the shared Generator coherent there (determinism is only
        # promised for the single-threaded scheduler)
        self._lock = threading.Lock()
        # persistent per-client speed factors: a straggler stays one
        if cfg.heterogeneity > 0.0:
            self.speed = np.exp(cfg.heterogeneity
                                * self._rng.standard_normal(n_clients))
        else:
            self.speed = np.ones(n_clients)

    def draw_latency(self, client_id: int) -> float:
        c = self.cfg
        if c.latency == "none":
            return 0.0
        with self._lock:
            if c.latency == "lognormal":
                base = c.latency_scale * float(
                    np.exp(c.latency_sigma * self._rng.standard_normal()))
            else:                                # pareto
                base = c.latency_scale * float(1.0 + self._rng.pareto(
                    c.pareto_alpha))
        return base * float(self.speed[client_id])

    def draw_crash(self, client_id: int) -> bool:
        """Crash-mid-round fault injection: the dispatch's result never
        reaches the server."""
        if self.cfg.dropout_prob <= 0.0:
            return False
        with self._lock:
            return bool(self._rng.random() < self.cfg.dropout_prob)

    def draw_rejoin_delay(self, client_id: int) -> Optional[float]:
        """Seconds until a crashed client rejoins the dispatchable pool;
        None = the client is gone for good."""
        with self._lock:
            if self._rng.random() >= self.cfg.rejoin_prob:
                return None
            return float(self._rng.exponential(self.cfg.rejoin_delay_s))


# ---------------------------------------------------------------------------
# async messaging FSM (real threads over the comm backends)
# ---------------------------------------------------------------------------

class AsyncMessage:
    """Message-type constants of the async protocol (disjoint from
    fedavg_messaging.MyMessage's 1-4)."""
    MSG_TYPE_S2C_ASYNC_TRAIN = 11
    MSG_TYPE_C2S_ASYNC_RESULT = 12
    MSG_TYPE_S2C_ASYNC_STOP = 13

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_VERSION = "model_version"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    # marker param of a masked secagg uplink ({"round": v}): a plain
    # server quarantines masked words by name, a secure server plain rows
    MSG_ARG_KEY_SECAGG = "secagg"


class AsyncServerManager(ServerManager):
    """Buffered staleness-aware async server over any comm backend.

    No round barrier: every inbound result lands in the AsyncBuffer with
    staleness = current version − the version the client echoes; a commit
    fires when the buffer reaches `buffer_k` OR the deadline timer
    (re-armed after every commit) expires with a part-full buffer.
    Contributing clients are redispatched at once; on a deadline commit,
    clients whose dispatch predates the previous version are presumed
    crashed and redispatched too (``async_redispatch_total``).

    The model, the buffer (its accumulator or row matrix) and the commit
    run on `device` (the card unless the caller names another).  Knobs:

    * `streaming` (default True): aggregation-on-arrival through the
      arrival fold, and the O(P) streaming commit; False keeps the drain
      path (the [K, P] matrix and the finalize commit).
    * `ingest_pool` (default 0): a bounded decode pool fed RAW frames by
      the backend's frame sink, so wire decode runs off the transport's
      recv threads.  0 decodes inline (the FSM route).
    * `decode_into` (pool only): decode straight into preallocated host
      scratch rows at the RowLayout offsets; False decodes zero-copy and
      re-flattens.
    * `redispatch=False` never sends downlinks (clients push at their own
      rate).
    * `reliable=True` envelopes the transport (comm/reliability.py): the
      (sender, seq) ledger suppresses a retried or duplicated uplink
      before decode.  `min_quorum` makes deadline commits partition-
      aware; commits below capacity count in
      ``async_degraded_commits_total``.
    * `defense` installs the admission pipeline and the bucketed robust
      commit; `secure` (a SecAggConfig or a shared SecureAggregator) the
      masked field path, a cohort barrier: streaming, constant
      staleness, buffer_k = the cohort, no defense, no sparse uplinks.
    * `checkpoint_dir` saves the round state (variables, buffer, counters,
      reliability ledger, registry, the admission's reference) after
      every `checkpoint_every`-th commit and the last; `resume=True`
      restores the latest save at construction.  Kill the server
      mid-round, rebuild it with `resume=True` on the same port, and
      `send_start()` re-handshakes every client.  Secure round state is
      not saved: masks are round-keyed."""

    def __init__(self, init_variables: dict, total_commits: int,
                 buffer_k: int, rank: int = 0, size: int = 1,
                 backend: str = "INPROC", staleness_mode: str = "constant",
                 staleness_a: float = 0.5, staleness_b: float = 4.0,
                 mix: float = 1.0, deadline_s: Optional[float] = None,
                 streaming: bool = True, ingest_pool: int = 0,
                 decode_into: bool = True, sparse_uplink: bool = False,
                 redispatch: bool = True,
                 reliable: bool = False, min_quorum: int = 1,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1, resume: bool = False,
                 defense: Optional[DefenseConfig] = None,
                 secure=None, device=None, **kw):
        if secure is not None:
            # a secure round is a cohort barrier: pairwise masks cancel
            # only within ONE round's full pair set
            if not streaming:
                raise ValueError(
                    "secure aggregation rides the field fold (secagg needs "
                    "streaming=True) — the drain path holds plaintext "
                    "rows, the exact thing masking removes")
            if defense is not None:
                raise ValueError(
                    "the admission screen reads PLAINTEXT rows and is "
                    "blinded by pairwise masks — secure aggregation "
                    "composes with defense=None only; its DP rides the "
                    "CLIENT side (SecAggConfig.dp_clip/dp_noise)")
            if sparse_uplink:
                raise ValueError(
                    "sparse_topk drops coordinates per client, so pairwise "
                    "masks could never cancel — secagg and sparse_uplink "
                    "are mutually exclusive")
            if staleness_mode != "constant":
                raise ValueError(
                    f"secagg forces staleness_mode='constant': a masked "
                    f"uplink is only foldable at the round it was "
                    f"dispatched for (got {staleness_mode!r})")
            if buffer_k != size - 1:
                raise ValueError(
                    f"secagg commits on the FULL cohort (or its deadline "
                    f"survivor set): buffer_k must equal the cohort size "
                    f"{size - 1}, got {buffer_k}")
        if defense is not None and not streaming:
            raise ValueError(
                "the admission pipeline rides the streaming fold (defense "
                "needs streaming=True) — the drain path holds the full "
                "[K, P] matrix and has the sync-side robust aggregators "
                "instead")
        if sparse_uplink and (not streaming or defense is not None):
            raise ValueError(
                "sparse_uplink rides the streaming sparse fold and the "
                "admission screen needs dense rows — sparse_topk frames "
                "compose with streaming=True and defense=None only")
        self.device = resolve_device(device)
        super().__init__(rank, size, backend, **kw)
        if reliable:
            self.com_manager.enable_reliability()
        self.sparse_uplink = bool(sparse_uplink)
        self.defense = defense
        self.variables = {k: torch.as_tensor(v).to(self.device)
                          for k, v in init_variables.items()}
        self._host: Optional[dict] = None
        self._layout = RowLayout(self.variables,
                                 AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS)
        # the secure seam: a shared SecureAggregator (INPROC: the clients
        # hold the same object) or a SecAggConfig this server expands.
        # Secure round state is not checkpointed: masks are round-keyed
        self._secure: Optional[SecureAggregator] = None
        if isinstance(secure, SecAggConfig):
            self._secure = SecureAggregator(secure, range(1, size),
                                            self._layout.p, self.device)
        elif secure is not None:
            self._secure = secure
        self.secure_below_threshold = 0       # named round failures
        self.total_commits = total_commits
        self.buffer_k = buffer_k
        self.mix = float(mix)
        self.deadline_s = deadline_s
        self.streaming = streaming
        self.decode_into = decode_into
        self.redispatch = redispatch
        self.min_quorum = max(1, int(min_quorum))
        self.ingest_pool = int(ingest_pool)
        self.version = 0
        self.partial_commits = 0
        self.degraded_commits = 0            # deadline commits below K
        self.updates_committed = 0
        self.staleness_seen: list[float] = []
        self.commit_walls: list[float] = []      # perf_counter per commit
        self.commit_sizes: list[int] = []        # n_real per commit
        p = flat_dim(self.variables)
        self.buffer = AsyncBuffer(
            buffer_k, p, streaming=streaming,
            staleness_mode=staleness_mode, staleness_a=staleness_a,
            staleness_b=staleness_b,
            buckets=(defense.buckets if defense is not None else 1),
            bucket_seed=(defense.seed if defense is not None else 0),
            device=self.device)
        # the admission gate sits at _ingest_row (the ONE insert path)
        self._admission: Optional[UpdateAdmission] = None
        self._dp_rng: Optional[torch.Generator] = None
        self._g_dev = None
        if defense is not None:
            self._admission = UpdateAdmission(defense, p, self.device)
            self._admission.bind_fold(staleness_mode, staleness_a,
                                      staleness_b)
            self._g_dev = flatten_vars_row(self.variables)
            self._admission.note_global(0, self._g_dev)
            if defense.dp_noise > 0.0:
                self._dp_rng = torch.Generator(
                    device=self.device).manual_seed(defense.seed + 17)
        if streaming and defense is not None:
            self._commit = make_bucket_commit_fn(
                self.variables, combine=defense.combine,
                trim_k=defense.trim_k, dp_noise=defense.dp_noise,
                dp_clip=defense.dp_clip or 1.0)
        elif streaming:
            self._commit = make_stream_commit_fn(self.variables)
        else:
            self._commit = make_commit_fn(self.variables, mode=staleness_mode,
                                          a=staleness_a, b=staleness_b)
        self._lock = threading.Lock()
        self._watchdog: Optional[threading.Timer] = None
        # per-rank dispatch/participation state: the `outstanding` field
        # carries the in-flight version (-1 idle)
        self.registry = ClientRegistry(size)
        self.done = threading.Event()
        self._m_occupancy = obs.gauge("async_buffer_occupancy")
        self._m_staleness = obs.histogram(
            "async_staleness", buckets=obs.metrics.STALENESS_BUCKETS)
        self._m_commits = obs.counter("async_commits_total")
        self._m_updates = obs.counter("async_updates_committed_total")
        self._m_deadline = obs.counter("async_deadline_commits_total")
        self._m_degraded = obs.counter("async_degraded_commits_total")
        self._m_redispatch = obs.counter("async_redispatch_total")
        self._m_lock_wait = obs.counter("async_lock_wait_seconds")
        self._m_pool_depth = obs.gauge("async_ingest_pool_depth")
        self._m_decode = obs.histogram(
            "comm_decode_seconds",
            buckets=obs.metrics.DECODE_SECONDS_BUCKETS,
            backend=self.com_manager.backend_name)
        # admission latency: the transport's hand-over of a frame to the
        # row landing in the buffer (pool queueing, decode, screen, lock)
        self._m_admission = obs.histogram(
            "comm_admission_seconds",
            buckets=obs.metrics.DECODE_SECONDS_BUCKETS)
        # crash-resume: a checkpoint of the whole round state after every
        # checkpoint_every-th commit; the restore happens before the
        # ingest pool exists, so no frame can race the rebuild
        self._ckpt = None
        self.checkpoint_every = max(1, int(checkpoint_every))
        if checkpoint_dir:
            self._ckpt = FedCheckpointManager(checkpoint_dir, max_to_keep=3)
            if resume and self._ckpt.latest_round() is not None:
                self._restore_checkpoint()
        self._pool = None
        if self.ingest_pool > 0 and not self.com_manager.supports_frame_sink:
            # MQTT speaks broker JSON and a no-encode inproc router hands
            # Message objects across: no raw frame ever reaches a sink
            log.warning(
                "ingest_pool=%d has no effect on the %s backend (frames "
                "never reach the raw-frame sink) — decoding inline "
                "instead", self.ingest_pool, self.com_manager.backend_name)
            self.ingest_pool = 0
        if self.ingest_pool > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.ingest_pool,
                thread_name_prefix="async-ingest")
            # host scratch rows sized to the in-flight bound (2x pool, the
            # semaphore's): the free-list never starves and never grows.
            # A frame fills the first RowLayout.p elements; the pad tail
            # stays zero
            self._scratch: "queue.Queue[torch.Tensor]" = queue.Queue()
            for _ in range(2 * self.ingest_pool):
                self._scratch.put(torch.zeros(p, dtype=torch.float32))
            self._ingest_sem = threading.BoundedSemaphore(
                2 * self.ingest_pool)
            self.com_manager.set_frame_sink(self._ingest_frame)
            # non-blocking admission probe for reactor transports: while
            # the pool is at its bound the reactor suspends the peer's
            # reads instead of blocking a shared loop thread
            pool_cap = float(2 * self.ingest_pool)
            self.com_manager.set_ingest_pressure(
                lambda: self._m_pool_depth.value >= pool_cap)

    # -- the global model ----------------------------------------------------
    def host_variables(self) -> dict:
        """The global model copied to the host once per version: every
        downlink of a version encodes from these CPU tensors."""
        if self._host is None:
            self._host = {k: v.cpu() for k, v in self.variables.items()}
        return self._host

    def _flat_row(self, tree: dict) -> torch.Tensor:
        """An uplink's variables -> the buffer's row layout (host), bitwise
        flatten_vars_row's, in one numpy concatenation: every torch op
        releases the interpreter lock, and under a flood of in-process
        senders each re-acquire waits out their switch intervals, so a
        handler of a dozen per-leaf ops starves (the INPROC legacy
        torture stalled so)."""
        parts = []
        for k in self.variables:
            v = tree[k]
            if isinstance(v, torch.Tensor) and v.dtype != torch.float32:
                v = v.float()
            parts.append(np.asarray(v, np.float32).reshape(-1))
        row = np.zeros(self.buffer.p, np.float32)
        n = sum(a.size for a in parts)
        np.concatenate(parts, out=row[:n])
        return torch.from_numpy(row)

    # -- crash-resume state --------------------------------------------------
    def _ckpt_state(self) -> dict:
        """The server's round state as host arrays: the buffer's own
        snapshot (accumulator or rows), the round counters, the
        reliability endpoint's per-peer seq/ledger state, the registry
        shards and (defended) the admission's running reference."""
        rel = self.com_manager._rel_ep
        rel_state = (rel.export_seq_state(self.size) if rel is not None
                     else {"seq": np.zeros((self.size,), np.int64),
                           "seen": np.full((self.size,), -1, np.int64)})
        out = {"buffer": self.buffer.state(),
               "updates_committed": np.asarray(self.updates_committed,
                                               np.int64),
               "partial_commits": np.asarray(self.partial_commits,
                                             np.int64),
               "degraded_commits": np.asarray(self.degraded_commits,
                                              np.int64),
               "reliable": rel_state,
               "registry": self.registry.state()}
        if self._admission is not None:
            out["defense"] = self._admission.state()
        return out

    def _restore_checkpoint(self) -> None:
        """Load the latest checkpoint into this (not yet serving) server:
        the variables, buffer, counters, reliability ledger and registry
        (its in-flight markers reset: send_start() re-dispatches everyone),
        and a defended server's running reference, so the screen resumes
        armed rather than in a fresh warm-up window."""
        step, variables, _s, extra = self._ckpt.restore(
            self.variables, (), extra_template=self._ckpt_state())
        self.version = int(step)
        self.variables = {k: variables[k] for k in self.variables}
        self._host = None
        self.buffer.load_state(extra["buffer"])
        self.updates_committed = int(extra["updates_committed"])
        self.partial_commits = int(extra["partial_commits"])
        self.degraded_commits = int(extra["degraded_commits"])
        rel = self.com_manager._rel_ep
        if rel is not None and "reliable" in extra:
            rel.import_seq_state(extra["reliable"])
        if "registry" in extra:
            self.registry.load_state(extra["registry"])
            self.registry.reset_transient()
        if self._admission is not None:
            if "defense" in extra:
                self._admission.load_state(extra["defense"])
            self._g_dev = flatten_vars_row(self.variables)
            self._admission.note_global(self.version, self._g_dev)
        log.info("async server resumed from checkpoint: version %d, %d "
                 "updates committed, buffer %d/%d", self.version,
                 self.updates_committed, self.buffer.count, self.buffer_k)

    def _save_checkpoint_locked(self) -> None:
        with obs.span("async.checkpoint", version=self.version):
            self._ckpt.save(self.version, self.variables, (),
                            extra_state=self._ckpt_state())

    def crash(self) -> None:
        """Chaos/test hook: die abruptly — no STOP broadcast, no final
        commit; the deadline watchdog is cancelled and the transport torn
        down mid-round."""
        with self._lock:
            if self._watchdog is not None:
                self._watchdog.cancel()
                self._watchdog = None
            self.done.set()             # sink + _ingest_row drop frames
        log.warning("async server CRASH at version %d (buffer %d/%d)",
                    self.version, self.buffer.count, self.buffer_k)
        self.finish()

    # -- dispatch ------------------------------------------------------------
    def send_start(self) -> None:
        for rank in range(1, self.size):
            self._dispatch(rank)
        with self._lock:
            if self.deadline_s is not None:
                self._arm_watchdog(self.version)

    def _dispatch(self, rank: int) -> None:
        msg = Message(AsyncMessage.MSG_TYPE_S2C_ASYNC_TRAIN, self.rank, rank)
        msg.add_params(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS,
                       self.host_variables())
        msg.add_params(AsyncMessage.MSG_ARG_KEY_CLIENT_INDEX, rank - 1)
        msg.add_params(AsyncMessage.MSG_ARG_KEY_VERSION, self.version)
        if self._secure is not None:
            # escrow the client's key shares AT DISPATCH: if it dies
            # mid-round the survivors already hold what the barrier needs
            self._secure.escrow(rank)
        if self.registry.contains(rank):
            self.registry.note_dispatch_one(rank, self.version)
        self.send_message(msg)

    # -- FSM -----------------------------------------------------------------
    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            AsyncMessage.MSG_TYPE_C2S_ASYNC_RESULT, self._handle_result)

    def _quarantine_skew(self, sender: int, masked: bool) -> None:
        self.com_manager._m_quarantined.inc()
        if masked:
            log.warning("plain server: MASKED secagg uplink from rank %d "
                        "quarantined (server missing secure aggregation? "
                        "config skew)", sender)
        else:
            log.warning("secure server: PLAIN uplink from rank %d "
                        "quarantined (client not running secure "
                        "aggregation? config skew)", sender)

    def _handle_result(self, msg: Message) -> None:
        """FSM route (ingest_pool=0): the backend decoded the frame inline;
        flatten and fold/insert.  The secagg marker keeps masked and plain
        rows from folding into each other's world."""
        t0 = time.perf_counter()
        marker = msg.get(AsyncMessage.MSG_ARG_KEY_SECAGG)
        if self._secure is not None:
            if marker is None:
                self._quarantine_skew(msg.get_sender_id(), masked=False)
                return
            words = np.ascontiguousarray(
                msg.get(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS), np.uint32)
            self._ingest_secure(
                msg.get_sender_id(), words,
                int(msg.get(AsyncMessage.MSG_ARG_KEY_VERSION)))
            self._m_admission.observe(time.perf_counter() - t0)
            return
        if marker is not None:
            self._quarantine_skew(msg.get_sender_id(), masked=True)
            return
        row = self._flat_row(msg.get(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS))
        self._ingest_row(
            msg.get_sender_id(), row,
            float(msg.get(AsyncMessage.MSG_ARG_KEY_NUM_SAMPLES)),
            int(msg.get(AsyncMessage.MSG_ARG_KEY_VERSION)))
        self._m_admission.observe(time.perf_counter() - t0)

    # -- parallel ingest (frame sink + decode pool) --------------------------
    def _ingest_frame(self, payload) -> Optional[Message]:
        """Frame sink, on the backend's recv threads, with RAW frames.
        Bounded hand-off to the decode pool: with 2x pool tasks in flight
        the acquire blocks this recv thread and the transport's flow
        control backpressures the sender."""
        if self.done.is_set() or self._closed:
            return None                       # shutdown: drop late frames
        self._ingest_sem.acquire()
        self._m_pool_depth.inc()
        try:
            self._pool.submit(self._ingest_task, payload,
                              time.perf_counter())
        except RuntimeError:                  # pool torn down mid-flight
            self._ingest_sem.release()
            self._m_pool_depth.dec()
        return None

    def _decode_or_route(self, payload) -> Optional[Message]:
        """Decode a frame the fast paths refused: a result frame comes
        back; control traffic goes to the FSM and an undecodable frame is
        quarantined (both return None)."""
        try:
            full = MessageCodec.decode(payload, copy="never")
        except Exception as e:
            self.com_manager._m_quarantined.inc()
            log.warning("ingest pool: undecodable frame (%d bytes) "
                        "quarantined: %s", len(payload), e)
            return None
        if full.get_type() != AsyncMessage.MSG_TYPE_C2S_ASYNC_RESULT:
            self.com_manager._note_frame(full)
            self.com_manager._on_message(full)
            return None
        return full

    def _ingest_task(self, payload, t_arrive: Optional[float] = None) -> None:
        """Decode-pool worker: decode one frame into a scratch row, then
        fold it into the buffer."""
        row = self._scratch.get()
        try:
            t0 = time.perf_counter()
            if self._secure is not None:
                # masked uplinks decode through the secagg twin (raw u32
                # words); a plain uplink is quarantined by name
                with obs.span("ingest.decode", nbytes=len(payload),
                              into=False):
                    try:
                        msg, words, _enc = MessageCodec.decode_secagg(
                            payload, AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS,
                            self._secure.words)
                    except ValueError:
                        full = self._decode_or_route(payload)
                        if full is not None:
                            self._quarantine_skew(full.get_sender_id(),
                                                  masked=False)
                        return
                self._m_decode.observe(time.perf_counter() - t0)
                self.com_manager._note_frame(msg)
                self._ingest_secure(
                    msg.get_sender_id(), words.numpy(),
                    int(msg.get(AsyncMessage.MSG_ARG_KEY_VERSION)))
                if t_arrive is not None:
                    self._m_admission.observe(time.perf_counter() - t_arrive)
                return
            msg = pairs = None
            with obs.span("ingest.decode", nbytes=len(payload),
                          into=self.decode_into):
                if self.sparse_uplink:
                    # the (index, value) pairs without densifying; a dense
                    # frame falls through to decode_into
                    try:
                        msg, sidx, svals = MessageCodec.decode_sparse(
                            payload, self._layout)
                        pairs = (sidx, svals)
                    except ValueError:
                        msg = None
                if msg is None and self.decode_into:
                    try:
                        msg = MessageCodec.decode_into(
                            payload, row[:self._layout.p], self._layout)
                    except ValueError:
                        msg = None            # not a result frame / skew
                if msg is None:
                    full = self._decode_or_route(payload)
                    if full is None:
                        return
                    if full.get(AsyncMessage.MSG_ARG_KEY_SECAGG) is not None:
                        self._quarantine_skew(full.get_sender_id(),
                                              masked=True)
                        return
                    row.copy_(self._flat_row(
                        full.get(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS)))
                    msg = full
            self._m_decode.observe(time.perf_counter() - t0)
            # the sink path bypasses _deliver_frame's inline note: strip
            # and account the trace block and the piggybacked metrics here
            self.com_manager._note_frame(msg)
            self._ingest_row(
                msg.get_sender_id(), row,
                float(msg.get(AsyncMessage.MSG_ARG_KEY_NUM_SAMPLES)),
                int(msg.get(AsyncMessage.MSG_ARG_KEY_VERSION)),
                sparse=pairs)
            if t_arrive is not None:
                self._m_admission.observe(time.perf_counter() - t_arrive)
        except Exception:                     # never kill a pool worker
            log.exception("ingest task failed (%d bytes)", len(payload))
        finally:
            self._scratch.put(row)
            self._ingest_sem.release()
            self._m_pool_depth.dec()
            # wake a reactor loop holding pressure-paused peers
            self.com_manager._notify_ingest_ready()

    def _ingest_row(self, sender: int, row, weight: float,
                    dispatched: int, *, sparse=None) -> None:
        """The ONE insert path (the FSM route and the decode pool both land
        here): staleness accounting, buffer fold/insert, commit trigger.
        Lock acquisition is timed into async_lock_wait_seconds.  `row` is
        read before this returns (the pool recycles it); `sparse` carries
        a sparse_topk frame's (global index, value) pairs, and then `row`
        is untouched scratch."""
        t0 = time.perf_counter()
        self._lock.acquire()
        self._m_lock_wait.inc(time.perf_counter() - t0)
        last = False
        try:
            if self.done.is_set():
                return                      # late straggler after shutdown
            staleness = float(self.version - dispatched)
            known = self.registry.contains(sender)
            if self._admission is not None:
                # the admission gate: a quarantined row never reaches the
                # accumulator, and its sender is redispatched like any
                # contributor (it cannot starve the round by being
                # rejected), unless the registry banned it
                with obs.span("ingest.fold", sender=sender):
                    ok, _why, full = self.buffer.add_screened(
                        row, weight, staleness, self._admission,
                        sender=sender, version=dispatched)
                if not ok:
                    banned = False
                    if known:
                        self.registry.note_return(sender)
                        banned = self.registry.note_quarantine(sender)
                    if self.redispatch and not banned:
                        self._redispatch_locked([sender])
                    return
            else:
                with obs.span("ingest.fold", sender=sender):
                    if sparse is not None:
                        full = self.buffer.add_sparse(
                            sparse[0], sparse[1], weight, staleness)
                    else:
                        full = self.buffer.add(row, weight, staleness)
            # only ADMITTED results count toward the staleness statistics
            self.staleness_seen.append(staleness)
            self._m_staleness.observe(staleness)
            self._m_occupancy.set(self.buffer.count)
            if known:
                self.registry.note_return(sender)
                self.registry.note_contribution(sender, staleness,
                                                self.version)
            if not full:
                # async has no barrier: hand the contributor work now
                if self.redispatch:
                    self._redispatch_locked([sender])
                return
            last = self._commit_locked(deadline_fired=False)
        finally:
            self._lock.release()
        if last:
            self.stop_all()

    def _ingest_secure(self, sender: int, words: np.ndarray,
                       dispatched: int) -> None:
        """Secure twin of _ingest_row: the round-version check, the field
        fold, and the cohort-full commit trigger.  The version is the
        secure round index AND the mask PRG counter, so an uplink masked
        for another round is quarantined by name and redispatched."""
        t0 = time.perf_counter()
        self._lock.acquire()
        self._m_lock_wait.inc(time.perf_counter() - t0)
        last = False
        try:
            if self.done.is_set():
                return                      # late straggler after shutdown
            known = self.registry.contains(sender)
            if dispatched != self.version:
                self.com_manager._m_quarantined.inc()
                log.warning(
                    "secure round %d: stale masked uplink from rank %d "
                    "(masked for round %d) quarantined — masks are "
                    "round-keyed and cannot cancel across rounds",
                    self.version, sender, dispatched)
                if known:
                    self.registry.note_return(sender)
                if self.redispatch:
                    self._redispatch_locked([sender])
                return
            with obs.span("ingest.fold", sender=sender, secure=True):
                n = self._secure.fold(sender, words)
            self.staleness_seen.append(0.0)
            self._m_staleness.observe(0.0)
            self._m_occupancy.set(n)
            if known:
                self.registry.note_return(sender)
                self.registry.note_contribution(sender, 0.0, self.version)
            if n < self.buffer_k:
                # cohort barrier: contributors WAIT for the round to close
                return
            last = self._commit_locked(deadline_fired=False)
        finally:
            self._lock.release()
        if last:
            self.stop_all()

    def _arm_watchdog(self, armed_version: int) -> None:
        """Deadline heartbeat, armed at start and after every commit (and
        after an empty-buffer retry sweep), so progress never depends on a
        result arriving first."""
        self._watchdog = threading.Timer(
            self.deadline_s, self._on_deadline, args=(armed_version,))
        self._watchdog.daemon = True
        self._watchdog.start()

    def _on_deadline(self, armed_version: int) -> None:
        with self._lock:
            self._watchdog = None
            if self.done.is_set() or self.version != armed_version:
                return                      # committed normally meanwhile
            arrived = (self._secure.count if self._secure is not None
                       else self.buffer.count)
            if arrived < self.min_quorum:
                # below quorum a whole deadline long: presume the
                # outstanding dispatches lost, retry them all, keep the
                # heartbeat alive
                if self.redispatch:
                    self._redispatch_locked(
                        [int(r) for r in self.registry.outstanding_ids()])
                self._arm_watchdog(self.version)
                return
            last = self._commit_locked(deadline_fired=True)
        if last:
            self.stop_all()

    def _commit_locked(self, deadline_fired: bool) -> bool:
        """Commit and redispatch; caller holds _lock.  Returns True when
        this was the last commit."""
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None
        mix = np.float32(self.mix)
        with obs.span("async.commit", version=self.version,
                      streaming=self.streaming,
                      n_results=(self._secure.count
                                 if self._secure is not None
                                 else self.buffer.count),
                      deadline=deadline_fired):
            if self._secure is not None:
                # the unmask barrier: survivors = who answered THIS round;
                # absent members' masks come back from escrowed shares, and
                # a below-threshold set fails the round BY NAME (arrived
                # rows kept, the missing ranks redispatched)
                try:
                    acc_np, wsum, included = self._secure.commit(
                        self.version, self._secure.arrived)
                except SecAggBelowThreshold as e:
                    self.secure_below_threshold += 1
                    log.warning("secure round %d did not commit: %s",
                                self.version, e)
                    if self.redispatch:
                        self._redispatch_locked(
                            [int(r) for r
                             in self.registry.outstanding_ids()])
                    if self.deadline_s is not None:
                        self._arm_watchdog(self.version)
                    return False
                n_real = len(included)
                self._m_occupancy.set(0)
                acc = torch.zeros(self.buffer.p, dtype=torch.float32,
                                  device=self.device)
                acc[:acc_np.shape[0]] = torch.from_numpy(acc_np)
                new_vars, _stats = self._commit(self.variables, acc,
                                                np.float32(wsum), mix)
            elif self.streaming and self.defense is not None:
                accs, wsums, _w, _s, n_real, _raw = \
                    self.buffer.take_stream_buckets()
                self._m_occupancy.set(0)
                if self._dp_rng is not None:
                    new_vars, _stats = self._commit(
                        self.variables, accs, wsums, mix, n_real,
                        self._dp_rng)
                else:
                    new_vars, _stats = self._commit(self.variables, accs,
                                                    wsums, mix)
            elif self.streaming:
                acc, wsum, _w, _s, n_real, _raw = self.buffer.take_stream()
                self._m_occupancy.set(0)
                new_vars, _stats = self._commit(self.variables, acc, wsum,
                                                mix)
            else:
                rows, w, s, n_real = self.buffer.drain()
                self._m_occupancy.set(0)
                new_vars, _stats = self._commit(self.variables, rows, w, s,
                                                mix)
            self.variables = new_vars
            self._host = None
            if self._g_dev is not None:
                # the admission reference global moves with every commit
                self._g_dev = flatten_vars_row(self.variables)
        self.version += 1
        if self._admission is not None:
            self._admission.note_global(self.version, self._g_dev)
        self.updates_committed += n_real
        self.commit_walls.append(time.perf_counter())
        self.commit_sizes.append(n_real)
        self._m_commits.inc()
        self._m_updates.inc(n_real)
        if deadline_fired:
            self.partial_commits += 1
            self._m_deadline.inc()
            if n_real < self.buffer_k:
                # quorum-degraded: committed with fewer than a full buffer
                self.degraded_commits += 1
                self._m_degraded.inc()
        if self._ckpt is not None and (
                self.version % self.checkpoint_every == 0
                or self.version >= self.total_commits):
            self._save_checkpoint_locked()
        if self.version >= self.total_commits:
            self.done.set()
            return True
        # redispatch everyone idle; on a deadline commit also retry ranks
        # whose dispatch predates the PREVIOUS version (two commits
        # without a reply reads as a crash)
        if self.redispatch:
            ranks = np.arange(1, self.size, dtype=np.int64)
            out = self.registry.outstanding_of(ranks)
            retry = [int(r) for r, v in zip(ranks, out)
                     if v < 0 or (deadline_fired
                                  and v < self.version - 1)]
            self._redispatch_locked(retry)
        if self.deadline_s is not None:
            self._arm_watchdog(self.version)
        return False

    def _redispatch_locked(self, ranks) -> None:
        for r in ranks:
            if (self.registry.contains(r) and int(
                    self.registry.status_of([r])[0]) == _REG_BANNED):
                continue        # banned = never dispatched again
            self._m_redispatch.inc()
            self._dispatch(r)

    def stop_all(self) -> None:
        """Broadcast STOP and close this manager (never under _lock:
        finish() joins the receive thread, which may be waiting on it).
        A no-downlink (redispatch=False) server skips the broadcast."""
        if self.redispatch:
            for rank in range(1, self.size):
                try:
                    self.send_message(Message(
                        AsyncMessage.MSG_TYPE_S2C_ASYNC_STOP, self.rank,
                        rank))
                except Exception:              # a dead client's transport
                    log.warning("stop broadcast to rank %d failed", rank,
                                exc_info=True)
        self.finish()

    def finish(self) -> None:
        """Tear down the decode pool before the base shutdown, waiting for
        the in-flight tasks (bounded by the semaphore) — except when this
        runs ON a pool worker (the final commit's _ingest_row -> stop_all
        chain), where waiting would self-join; an external finish()
        (idempotent) then does the quiescing join."""
        if self._pool is not None:
            on_worker = threading.current_thread().name.startswith(
                "async-ingest")
            self._pool.shutdown(wait=not on_worker)
        super().finish()


class AsyncClientManager(ClientManager):
    """One lifecycle-simulated device: on a train dispatch, draw this
    dispatch's fate from the seeded lifecycle (a crash swallows the
    result), sleep the drawn latency (REAL seconds: keep latency_scale
    small in tests), train on `device` from the received model (in
    `local_dtype` when given) and upload it with the dispatch version
    echoed for staleness accounting.  The client trains on its own copy
    of the model, with its own generator (seeded 2000 + rank) for dropout
    and augmentation."""

    def __init__(self, trainer, data, epochs: int, rank: int, size: int,
                 backend: str = "INPROC",
                 lifecycle: Optional[ClientLifecycle] = None,
                 reliable: bool = False,
                 adversary: Optional[AdversarySim] = None,
                 secure: Optional[SecureAggregator] = None, device=None,
                 local_dtype: Optional[torch.dtype] = None, **kw):
        self.device = resolve_device(device)
        super().__init__(rank, size, backend, **kw)
        self.adversary = adversary
        # this client's view of the secure data plane: client_row only
        # reads the (seed-derived) keyring, so INPROC ranks share the
        # server's instance
        self._secure = secure
        self.secagg_rejected = 0       # uplinks the quantizer refused
        if reliable:
            self.com_manager.enable_reliability()
        self.trainer = copy.copy(trainer)
        self.trainer.model = copy.deepcopy(trainer.model)
        self.data = data
        self.epochs = epochs
        self.local_dtype = local_dtype
        self.lifecycle = lifecycle
        self.crashes = 0
        self.done = threading.Event()
        self._generator = torch.Generator(
            device=self.device).manual_seed(2000 + rank)
        # mergeable-telemetry baseline: each uplink ships the metrics
        # delta since the previous one (obs/propagate.py)
        self._m_ship_state: Optional[dict] = None

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            AsyncMessage.MSG_TYPE_S2C_ASYNC_TRAIN, self._handle_train)
        self.register_message_receive_handler(
            AsyncMessage.MSG_TYPE_S2C_ASYNC_STOP, self._handle_stop)

    def _train(self, variables: dict, client_idx: int):
        """Local training from the received model: (upload {name: tensor}
        in the received dict's order, sample count)."""
        shard = {k: torch.as_tensor(v[client_idx]).to(self.device)
                 for k, v in self.data.client_shards.items()}
        flat = self.trainer.flatten(cast_local(
            {k: torch.as_tensor(v).to(self.device)
             for k, v in variables.items()}, self.local_dtype))
        row, _loss, n = self.trainer.local_train(
            flat, shard, self.epochs,
            global_params=flat if self.trainer.prox_mu > 0 else None,
            generator=self._generator)
        trained = self.trainer.unflatten(row)
        return {k: trained[k] for k in variables}, float(n)

    def _handle_train(self, msg: Message) -> None:
        if self.done.is_set() or self._closed:
            return      # dispatch raced shutdown: the server is gone
        client_idx = int(msg.get(AsyncMessage.MSG_ARG_KEY_CLIENT_INDEX))
        if self.lifecycle is not None:
            if self.lifecycle.draw_crash(client_idx):
                # crash mid-round: nothing is sent — the server's
                # deadline/redispatch path is the rejoin
                self.crashes += 1
                obs.counter("async_dropouts_total").inc()
                return
            lat = self.lifecycle.draw_latency(client_idx)
            if self.adversary is not None:
                lat += self.adversary.stale_extra_latency(client_idx)
            if lat > 0.0:
                time.sleep(lat)
        variables = msg.get(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS)
        ver = int(msg.get(AsyncMessage.MSG_ARG_KEY_VERSION))
        with obs.span("async.local_train", rank=self.rank,
                      client=client_idx):
            upload, n = self._train(variables, client_idx)
        if self.adversary is not None:
            # byzantine clients corrupt what they UPLOAD (valid frames:
            # rejecting them is the admission pipeline's job)
            upload = self.adversary.corrupt_update(client_idx, upload,
                                                   variables, ver)
        out = Message(AsyncMessage.MSG_TYPE_C2S_ASYNC_RESULT, self.rank, 0)
        if self._secure is not None:
            # quantize + pairwise-mask the weighted flat row (DP first in
            # the private mode); the weight rides as the masked last word,
            # so NUM_SAMPLES ships a constant 1.0.  A row the quantizer
            # refuses is DROPPED: the server's deadline path treats this
            # client as dead
            flat = flatten_vars_row(upload, device="cpu")
            try:
                masked = self._secure.client_row(
                    self.rank, ver,
                    flat[:self._secure.dim].double().numpy(), n)
            except ValueError as e:
                self.secagg_rejected += 1
                obs.counter("secagg_rejected_uplinks_total").inc()
                log.warning(
                    "secagg client %d: uplink for round %d refused at "
                    "quantization (norm-bound enforcement): %s",
                    self.rank, ver, e)
                return
            out.add_params(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS, masked)
            out.add_params(AsyncMessage.MSG_ARG_KEY_NUM_SAMPLES, 1.0)
            out.add_params(AsyncMessage.MSG_ARG_KEY_SECAGG, {"round": ver})
            out.set_wire_transport(
                AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS, "secagg",
                scale=self._secure.cfg.scale, p=self._secure.cfg.prime)
        else:
            out.add_params(AsyncMessage.MSG_ARG_KEY_MODEL_PARAMS, upload)
            out.add_params(AsyncMessage.MSG_ARG_KEY_NUM_SAMPLES, n)
        out.add_params(AsyncMessage.MSG_ARG_KEY_VERSION, ver)
        if self.done.is_set() or self._closed:
            return      # STOP landed during the latency sleep / train
        if obs.enabled():
            # piggyback this client's metrics delta on the uplink
            delta, self._m_ship_state = obs.registry().delta_snapshot(
                self._m_ship_state)
            out.add_params(propagate.METRICS_KEY, delta)
        self.send_message(out)

    def _handle_stop(self, msg: Message) -> None:
        self.done.set()
        self.finish()


def run_async_messaging(trainer, data, cfg, *, buffer_k: int,
                        total_commits: Optional[int] = None,
                        backend: str = "INPROC",
                        worker_num: Optional[int] = None,
                        lifecycle_cfg: Optional[LifecycleConfig] = None,
                        lifecycle: Optional[ClientLifecycle] = None,
                        staleness_mode: str = "constant",
                        staleness_a: float = 0.5, staleness_b: float = 4.0,
                        mix: float = 1.0, deadline_s: Optional[float] = None,
                        streaming: bool = True, ingest_pool: int = 0,
                        decode_into: bool = True, reliable: bool = False,
                        chaos=None, min_quorum: int = 1,
                        attack: Optional[AttackConfig] = None,
                        defense: Optional[DefenseConfig] = None,
                        secure: Optional[SecAggConfig] = None,
                        timeout_s: float = 600.0, device=None,
                        variables: Optional[dict] = None,
                        local_dtype: Optional[torch.dtype] = None,
                        **backend_kw):
    """Launch the async server and one lifecycle-simulated client per rank
    (threads; across machines build the managers one rank per process).
    Returns (variables, server) after `total_commits` commits.  A stall
    past `timeout_s` dumps the flight recorder before raising.

    device: where the server and the clients run (the card unless named).
    variables: the initial global model (default: ``trainer.init`` from
    cfg.seed).  local_dtype: the clients' local master dtype.
    `reliable` envelopes every manager's transport; `chaos` installs a
    comm.chaos.ChaosPolicy on the SERVER's backend; `attack` builds one
    seeded AdversarySim shared by every client (data attacks poison the
    shared dataset first); `defense` installs the admission pipeline;
    `secure` the masked field path, with one SecureAggregator shared by
    the server and its in-process clients."""
    from fedml_tpu_torch.comm.inproc import InProcRouter

    device = resolve_device(device)
    worker_num = worker_num or cfg.client_num_per_round
    size = worker_num + 1
    total_commits = (total_commits if total_commits is not None
                     else cfg.comm_round)
    router = backend_kw.pop("router", None)
    if backend.upper() == "INPROC" and router is None:
        router = InProcRouter()
    kw = dict(backend_kw)
    if router is not None:
        kw["router"] = router

    if lifecycle is None and lifecycle_cfg is not None:
        lifecycle = ClientLifecycle(lifecycle_cfg, worker_num)
    adversary = None
    if attack is not None and attack.mode != "none":
        adversary = AdversarySim(attack, worker_num)
        data = apply_data_attack(data, attack, adversary)
    if variables is None:
        variables = trainer.init(torch.Generator().manual_seed(cfg.seed),
                                 device)
    # the server's row layout is the trainer's flat order
    variables = {k: variables[k] for k in trainer.spec.names}
    secagg = None
    if secure is not None:
        secagg = SecureAggregator(secure, range(1, size),
                                  trainer.spec.n, device)
    server = AsyncServerManager(
        variables, total_commits, buffer_k, 0, size, backend,
        staleness_mode=staleness_mode, staleness_a=staleness_a,
        staleness_b=staleness_b, mix=mix, deadline_s=deadline_s,
        streaming=streaming, ingest_pool=ingest_pool,
        decode_into=decode_into, reliable=reliable,
        min_quorum=min_quorum, defense=defense, secure=secagg,
        device=device, **kw)
    if chaos is not None:
        server.com_manager.install_chaos(chaos)
    clients = []
    try:
        for r in range(1, size):
            clients.append(AsyncClientManager(
                trainer, data, cfg.epochs, r, size, backend,
                lifecycle=lifecycle, reliable=reliable, adversary=adversary,
                secure=secagg, device=device, local_dtype=local_dtype, **kw))
    except BaseException:
        for m in clients + [server]:
            m.finish()
        raise
    threads = [c.run_async() for c in clients] + [server.run_async()]
    server.send_start()
    if not server.done.wait(timeout=timeout_s):
        obs.dump_flight("async_scheduler_deadlock")
        for c in clients:
            c.finish()
        server.finish()
        raise TimeoutError(
            f"async federation stalled: {server.version}/{total_commits} "
            f"commits in {timeout_s}s (buffer {server.buffer.count}/"
            f"{buffer_k}; all in-flight clients may have crashed with no "
            f"deadline set)")
    for c in clients:
        c.finish()
    for t in threads:
        t.join(timeout=10)
    # the final commit may have run finish() ON a pool worker, where it
    # cannot self-join; this idempotent finish() is the quiescing join
    server.finish()
    return server.variables, server
