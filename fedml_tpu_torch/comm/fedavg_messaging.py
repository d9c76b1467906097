"""Message-driven FedAvg — the cross-silo deployment path (port of
fedml_tpu/comm/fedavg_messaging.py, its plain mode).

This is the reference's distributed 6-file pattern
(fedml_api/distributed/fedavg/: message_define.py, FedAvgServerManager.py,
FedAvgClientManager.py, FedAVGAggregator.py) collapsed into one module,
running over any comm backend (INPROC for simulation, GRPC/TCP across
machines).  Participants here are genuinely remote: each side holds its
model on its own device (the card unless the caller names another) and
only host bytes cross the wire.

FSM (msg types 1-4, message_define.py:5-10):

  server --S2C_INIT_CONFIG(model, client_idx)--> every client
  client: local_train --C2S_SEND_MODEL(model, n)--> server
  server: all received? weighted average; round+1 or finish
          --S2C_SYNC_MODEL(model, client_idx)--> every client

The server stacks the received models as rows of one [workers, P] matrix
on its device, in slot order, and folds them with the weighted-mean
kernel (``ops.aggregate.weighted_mean_flat``, the finalize form of the
fold that ``algorithms/fedavg.py`` reaches through ``weighted_mean``).
A client trains with ``ClientTrainer.local_train`` from the received
model, in `local_dtype` when given (bf16 local masters: its upload is
then bf16 leaves, as the JAX client's ml_dtypes bf16 arrays are), with
the generator ``client_generator(seed, round, rank - 1, device)``: a
messaging round trains each client exactly as the port's FedAvgEngine
round does.

The secure mode (``secure=``: masked uplinks, secagg) is slice 4 of the
port and raises here.
"""
from __future__ import annotations

import copy
import logging
import threading
from typing import Any, Callable, Optional

import torch

from fedml_tpu_torch import obs
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.core.sampling import ClientSampler
from fedml_tpu_torch.core.trainer import client_generator
from fedml_tpu_torch.ops.aggregate import (spec_of, unflatten_to_tree,
                                           weighted_mean_flat)
from fedml_tpu_torch.parallel.engine import cast_local
from fedml_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)
Pytree = Any

_SECURE_LATER = ("secure aggregation over the message layer (secure=, "
                 "secure/secagg.py) is slice 4 of the port")


class MyMessage:
    """Message-type constants (message_define.py:5-33)."""
    MSG_TYPE_S2C_INIT_CONFIG = 1
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = 2
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = 3
    MSG_TYPE_C2S_SEND_STATS_TO_SERVER = 4

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_LOCAL_LOSS = "local_loss"
    MSG_ARG_KEY_ROUND = "round_idx"
    # masked-uplink marker: a plain server rejects masked uploads by name
    MSG_ARG_KEY_SECAGG = "secagg"


class FedAvgAggregator:
    """Server-side round state (FedAVGAggregator.py:24-108): receive slots,
    all-received barrier, sample-weighted average, deterministic per-round
    client sampling (np.random.seed(round_idx), :90-98).

    `init_variables` is a flat {name: tensor or array} dict; the global
    model lives on `device` (the card unless the caller names another),
    in the init's dtypes.  Each upload is written into its slot's row of
    one [worker_num, P] matrix on the device, in the upload's dtype; the
    aggregate is one launch of the weighted-mean kernel over the rows
    that arrived."""

    def __init__(self, init_variables: Pytree, worker_num: int,
                 client_num_in_total: int, client_num_per_round: int,
                 secure=None, device=None):
        if secure is not None:
            raise NotImplementedError(_SECURE_LATER)
        self.device = resolve_device(device)
        self.variables = {k: torch.as_tensor(v).to(self.device)
                          for k, v in init_variables.items()}
        self.spec = spec_of(self.variables)
        self.worker_num = worker_num
        self.sampler = ClientSampler(client_num_in_total, client_num_per_round)
        self.sample_num_dict: dict[int, float] = {}
        self.flag_client_model_uploaded = [False] * worker_num
        self._rows: Optional[torch.Tensor] = None
        self._host: Optional[dict] = None
        self._lock = threading.Lock()

    def _slot_rows(self, dtype: torch.dtype) -> torch.Tensor:
        """The [worker_num, P_padded] upload matrix in `dtype` (zeroed, so
        the pad tail stays zero), allocated at the first upload."""
        if self._rows is None or self._rows.dtype != dtype:
            self._rows = torch.zeros(self.worker_num, self.spec.padded,
                                     dtype=dtype, device=self.device)
        return self._rows

    def add_local_trained_result(self, index: int, variables: Pytree,
                                 sample_num: float) -> bool:
        with self._lock:
            leaves = {k: torch.as_tensor(v) for k, v in variables.items()}
            rows = self._slot_rows(leaves[self.spec.names[0]].dtype)
            off = 0
            for name, size in zip(self.spec.names, self.spec.sizes):
                rows[index, off:off + size].copy_(leaves[name].reshape(-1))
                off += size
            self.sample_num_dict[index] = sample_num
            self.flag_client_model_uploaded[index] = True
            return all(self.flag_client_model_uploaded)

    def aggregate(self, round_idx: int = 0) -> Pytree:
        """Aggregate over every slot that uploaded this round.  With the
        all-received barrier that is all of them; under a straggler
        timeout it is the received subset (sample-weighted, so absent
        clients simply drop out of the mean)."""
        with self._lock:
            got = [i for i in range(self.worker_num)
                   if self.flag_client_model_uploaded[i]]
            rows = self._rows if len(got) == self.worker_num else \
                self._rows[torch.as_tensor(got, device=self.device)]
            w = torch.tensor([self.sample_num_dict[i] for i in got],
                             dtype=torch.float32, device=self.device)
            self.variables = unflatten_to_tree(weighted_mean_flat(rows, w),
                                               self.spec)
            self._host = None
            self.flag_client_model_uploaded = [False] * self.worker_num
            self.sample_num_dict.clear()
            return self.variables

    def host_variables(self) -> dict:
        """The global model copied to the host once per version: every
        downlink of a round encodes from these CPU tensors."""
        with self._lock:
            if self._host is None:
                self._host = {k: v.cpu() for k, v in self.variables.items()}
            return self._host

    def received_count(self) -> int:
        with self._lock:
            return sum(self.flag_client_model_uploaded)

    def client_sampling(self, round_idx: int):
        return self.sampler.sample(round_idx)


class FedAvgServerManager(ServerManager):
    """FedAvgServerManager.py:14-95 over the comm layer."""

    def __init__(self, aggregator: FedAvgAggregator, comm_round: int,
                 rank: int = 0, size: int = 1, backend: str = "INPROC",
                 on_round_done: Optional[Callable[[int, Pytree], None]] = None,
                 straggler_timeout: Optional[float] = None,
                 model_transport: Optional[str] = None,
                 wire_compress: bool = False, **kw):
        """straggler_timeout: seconds to wait for the full cohort after a
        round's first upload; then aggregate the received subset and move
        on.  None = the reference's hang-forever barrier
        (check_whether_all_receive, FedAVGAggregator.py:50-57).

        model_transport: opt-in lossy wire dtype ("bf16"/"int8", wire
        codec v2) for the DOWNLINK model_params payload only — the
        client→server uploads feed the weighted average and stay exact
        regardless; the synced model is a broadcast the next local round
        re-trains anyway.  None (default) keeps every payload exact.
        wire_compress: zlib the frame head (codec v2)."""
        super().__init__(rank, size, backend, **kw)
        self.aggregator = aggregator
        self.model_transport = model_transport
        self.wire_compress = wire_compress
        self.round_num = comm_round
        self.round_idx = 0
        self.on_round_done = on_round_done
        self.straggler_timeout = straggler_timeout
        self._round_lock = threading.Lock()
        self._watchdog: Optional[threading.Timer] = None
        self.partial_rounds = 0           # observability: timed-out rounds
        # ranks whose uplinks are config-skew quarantined: skew is a config
        # property, not a transient, so a quarantined rank is treated as
        # dead for the all-received barrier — without this, one
        # misconfigured client deadlocks the federation
        self._quarantined: set[int] = set()
        self.done = threading.Event()

    def send_init_msg(self) -> None:
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        for rank in range(1, self.size):
            self._send_model(rank, MyMessage.MSG_TYPE_S2C_INIT_CONFIG,
                             int(client_indexes[rank - 1]))

    def _send_model(self, receiver: int, msg_type: int, client_idx: int):
        msg = Message(msg_type, self.rank, receiver)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                       self.aggregator.host_variables())
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, client_idx)
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx)
        if self.model_transport:
            msg.set_wire_transport(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                                   self.model_transport)
        msg.wire_compress = self.wire_compress
        self.send_message(msg)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self._handle_model_from_client)

    def _handle_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        upload_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND)
        if msg.get(MyMessage.MSG_ARG_KEY_SECAGG) is not None:
            # masked words to a plain server — quarantine BY NAME, never
            # fold.  The sender's slot can never fill (skew is config, not
            # luck), so mark it dead for the barrier and close the round
            # if everyone else already uploaded
            log.warning(
                "plain server: MASKED uplink from rank %d quarantined "
                "(--secure_agg config skew between server and client)",
                sender)
            with self._round_lock:
                self._quarantined.add(sender)
                if not self._quorum_met():
                    return
                last = self._finish_round()
            if last:
                self.finish()
            return
        with self._round_lock:
            if (upload_round is not None
                    and int(upload_round) != self.round_idx):
                return    # straggler from a round already closed by timeout
            all_received = self.aggregator.add_local_trained_result(
                sender - 1, msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS),
                msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES))
            done = all_received or self._quorum_met()
            if self.straggler_timeout is not None and self._watchdog is None \
                    and not done:
                self._arm_watchdog(self.round_idx)
            if not done:
                return
            last = self._finish_round()
        if last:       # finish() outside _round_lock: it joins the receive
            self.finish()   # thread, which may be waiting on that lock

    def _quorum_met(self) -> bool:
        """All non-quarantined slots received (caller holds _round_lock).
        A config-skew-quarantined rank never fills its slot, so the
        all-received barrier discounts it; at least one genuine upload
        is still required."""
        got = self.aggregator.received_count()
        return (got > 0
                and got + len(self._quarantined) >= self.aggregator.worker_num)

    def _arm_watchdog(self, armed_round: int) -> None:
        self._watchdog = threading.Timer(
            self.straggler_timeout, self._on_straggler_timeout,
            args=(armed_round,))
        self._watchdog.daemon = True
        self._watchdog.start()

    def _on_straggler_timeout(self, armed_round: int) -> None:
        with self._round_lock:
            self._watchdog = None
            if self.round_idx != armed_round:
                return                      # round completed normally
            # the watchdog is armed only after a first upload, so at least
            # one slot is filled whenever we get here
            self.partial_rounds += 1
            last = self._finish_round()
        if last:
            self.finish()

    def _finish_round(self) -> bool:
        """Aggregate + advance; caller holds _round_lock.  Returns True
        when this was the last round — the caller must then call finish()
        AFTER releasing the lock (finish joins the receive thread, which
        may itself be blocked on _round_lock)."""
        if self._watchdog is not None:
            self._watchdog.cancel()
            self._watchdog = None
        # commit-family delimiter: a timeline windows the deployment's
        # rounds aggregate-to-aggregate
        with obs.span("fsm.aggregate", round=self.round_idx,
                      node="server"):
            self.aggregator.aggregate(self.round_idx)
        if self.on_round_done is not None:
            self.on_round_done(self.round_idx, self.aggregator.variables)
        self.round_idx += 1
        if self.round_idx >= self.round_num:
            self.done.set()
            return True
        client_indexes = self.aggregator.client_sampling(self.round_idx)
        for rank in range(1, self.size):
            self._send_model(rank,
                             MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                             int(client_indexes[rank - 1]))
        return False


class FedAvgClientManager(ClientManager):
    """FedAvgClientManager.py:14-75: on init/sync → update model+dataset,
    train locally (ClientTrainer.local_train on `device`), upload."""

    def __init__(self, trainer, data, epochs: int, rank: int, size: int,
                 backend: str = "INPROC", total_rounds: Optional[int] = None,
                 wire_compress: bool = False, secure=None, device=None,
                 local_dtype: Optional[torch.dtype] = None, seed: int = 0,
                 **kw):
        """total_rounds: in multi-PROCESS deployments the client must stop
        itself — it counts model syncs (the server sends exactly one per
        round, reference FedAvgClientManager.py:60-66) and finishes after
        uploading the last one.  None (in-process simulation) leaves
        shutdown to the launcher.

        device: where this client trains (the card unless named).
        local_dtype: the dtype of the local master weights (None: the
        received model's; bf16 for the main path's bf16 masters).  seed:
        the run's seed, for the client's dropout/augmentation generator.

        The client's model upload is aggregation-critical (it feeds the
        server's weighted average) and deliberately has NO transport
        knob — it always rides exact; wire_compress only zlibs the frame
        head (lossless)."""
        if secure is not None:
            raise NotImplementedError(_SECURE_LATER)
        self.device = resolve_device(device)
        super().__init__(rank, size, backend, **kw)
        self.wire_compress = wire_compress
        # a private copy of the model template: the trainer runs the model
        # through functional_call, which swaps the module's tensors for
        # the call, and clients of one process train in threads
        self.trainer = copy.copy(trainer)
        self.trainer.model = copy.deepcopy(trainer.model)
        self.data = data
        self.epochs = epochs
        self.local_dtype = local_dtype
        self.seed = seed
        self.total_rounds = total_rounds
        self.rounds_seen = 0
        self.done = threading.Event()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self._handle_sync)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self._handle_sync)

    def _handle_sync(self, msg: Message) -> None:
        variables = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        client_idx = int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX))
        round_idx = msg.get(MyMessage.MSG_ARG_KEY_ROUND)
        # the round's client-side train wall, upload to the card included
        with obs.span("fsm.local_train", rank=self.rank,
                      client=client_idx, round=round_idx):
            shard = {k: torch.as_tensor(v[client_idx]).to(self.device)
                     for k, v in self.data.client_shards.items()}
            flat = self.trainer.flatten(cast_local(
                {k: torch.as_tensor(v).to(self.device)
                 for k, v in variables.items()}, self.local_dtype))
            generator = client_generator(self.seed, int(round_idx or 0),
                                         self.rank - 1, self.device)
            row, loss, n = self.trainer.local_train(
                flat, shard, self.epochs,
                global_params=flat if self.trainer.prox_mu > 0 else None,
                generator=generator)
            n = float(n)                  # waits for the client's steps
        out = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
                      self.rank, 0)
        out.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                       self.trainer.unflatten(row))
        out.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, n)
        out.add_params(MyMessage.MSG_ARG_KEY_LOCAL_LOSS, float(loss))
        if round_idx is not None:       # echo for stale-upload rejection
            out.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(round_idx))
        out.wire_compress = self.wire_compress
        self.send_message(out)
        self.rounds_seen += 1
        if (self.total_rounds is not None
                and self.rounds_seen >= self.total_rounds):
            self.done.set()
            self.finish()


def run_messaging_fedavg(trainer, data, cfg, backend: str = "INPROC",
                         worker_num: Optional[int] = None, device=None,
                         variables: Optional[dict] = None,
                         local_dtype: Optional[torch.dtype] = None,
                         timeout: float = 600.0, **backend_kw):
    """Launch the server and its workers as managers in this process, each
    with its receive thread (one rank per process across machines: build
    the managers there instead), for cfg.comm_round rounds.  Returns the
    final global variables on `device` (the card unless named).

    variables: the initial global model (default: ``trainer.init`` from
    cfg.seed, as FedAvgEngine.init_variables).  local_dtype: the clients'
    local master dtype.  backend_kw: straggler_timeout, model_transport,
    wire_compress, router (INPROC), on_round_done, and the backend's own
    (ip_config, base_port, reactor, ...)."""
    from fedml_tpu_torch.comm.inproc import InProcRouter

    device = resolve_device(device)
    worker_num = worker_num or cfg.client_num_per_round
    size = worker_num + 1
    straggler_timeout = backend_kw.pop("straggler_timeout", None)
    model_transport = backend_kw.pop("model_transport", None)
    wire_compress = backend_kw.pop("wire_compress", False)
    on_round_done = backend_kw.pop("on_round_done", None)
    if backend_kw.pop("secure", None) is not None:
        raise NotImplementedError(_SECURE_LATER)
    router = backend_kw.pop("router", None)
    if backend.upper() == "INPROC" and router is None:
        router = InProcRouter()
    kw = dict(backend_kw)
    if router is not None:
        kw["router"] = router

    if variables is None:
        variables = trainer.init(torch.Generator().manual_seed(cfg.seed),
                                 device)
    agg = FedAvgAggregator(variables, worker_num, cfg.client_num_in_total,
                           worker_num, device=device)
    server = FedAvgServerManager(agg, cfg.comm_round, 0, size, backend,
                                 on_round_done=on_round_done,
                                 straggler_timeout=straggler_timeout,
                                 model_transport=model_transport,
                                 wire_compress=wire_compress, **kw)
    clients = []
    try:
        for r in range(1, size):
            clients.append(FedAvgClientManager(
                trainer, data, cfg.epochs, r, size, backend,
                wire_compress=wire_compress, device=device,
                local_dtype=local_dtype, seed=cfg.seed, **kw))
    except BaseException:
        for m in clients + [server]:
            m.finish()
        raise
    threads = [c.run_async() for c in clients] + [server.run_async()]
    server.send_init_msg()
    if not server.done.wait(timeout=timeout):
        for c in clients:
            c.finish()
        server.finish()   # close the server backend too (frees its port)
        raise TimeoutError(
            f"messaging FedAvg did not finish {cfg.comm_round} rounds in "
            f"{timeout}s (stalled at round {server.round_idx}; a client "
            "likely died mid-round)")
    for c in clients:
        c.finish()
    for t in threads:
        t.join(timeout=10)
    return agg.variables
