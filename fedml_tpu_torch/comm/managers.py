"""ClientManager / ServerManager — the message-FSM runtime (port of
fedml_tpu/comm/managers.py).

Parity: fedml_core/distributed/client/client_manager.py:14-79 and
server/server_manager.py:14-74 — select a backend by string, register as
observer, dispatch inbound messages through a handler dict keyed by message
type (register_message_receive_handler, client_manager.py:67-68).

Backend strings: "INPROC" (router passed via kwargs), "GRPC", "TCP"
(the native C++ transport when its library is already built, else the
Python one), "NATIVE_TCP", "MQTT" (a broker at `host`:`port`; paho when
installed, else the in-repo wire client; `client_factory` overrides).  The
reference's "MPI" process model has no counterpart by design — one-card
cohorts use the engines of fedml_tpu_torch/algorithms and parallel/.
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from fedml_tpu_torch import obs
from fedml_tpu_torch.comm.base import BaseCommManager, Observer
from fedml_tpu_torch.comm.message import Message

log = logging.getLogger(__name__)


class ManagerClosedError(RuntimeError):
    """send_message on a finished manager.  Raised so wrong shutdown
    ordering fails loudly; the ONE benign case — a handler that was
    already in flight when another thread called finish() — is caught
    at the FSM dispatch chokepoint (receive_message) and degraded to a
    logged drop, matching the pre-guard behavior for that race."""


def _build_backend(backend: str, rank: int, size: int, **kw) -> BaseCommManager:
    b = backend.upper()
    if b == "INPROC":
        from fedml_tpu_torch.comm.inproc import InProcBackend
        return InProcBackend(rank, kw["router"])
    if b == "GRPC":
        from fedml_tpu_torch.comm.grpc_backend import GrpcBackend
        return GrpcBackend(rank, kw["ip_config"],
                           base_port=kw.get("base_port", 50000),
                           send_timeout_s=kw.get("send_timeout_s"),
                           send_backoff=kw.get("send_backoff"))
    if b == "NATIVE_TCP":
        # explicit selection may compile the library on first use
        from fedml_tpu_torch.comm.native_tcp import NativeTcpBackend
        return NativeTcpBackend(rank, kw["ip_config"],
                                kw.get("base_port", 52000),
                                reactor=bool(kw.get("reactor", False)),
                                reactor_config=kw.get("reactor_config"))
    if b == "TCP":
        # auto-upgrade to the native transport only when the .so is already
        # built (never run a compile inside backend construction)
        from fedml_tpu_torch.native import library_built
        if library_built() and not kw.pop("force_python_tcp", False):
            from fedml_tpu_torch.comm.native_tcp import NativeTcpBackend
            return NativeTcpBackend(rank, kw["ip_config"],
                                    kw.get("base_port", 52000),
                                    reactor=bool(kw.get("reactor", False)),
                                    reactor_config=kw.get("reactor_config"))
        from fedml_tpu_torch.comm.tcp_backend import TcpBackend
        # reactor=None -> the transport default (reactor unless
        # FEDML_TCP_REACTOR=0); callers pin either path explicitly —
        # the ingest torture's legacy arms force threads, the
        # connection bench forces the reactor with a tuned config
        return TcpBackend(rank, kw["ip_config"],
                          base_port=kw.get("base_port", 52000),
                          reactor=kw.get("reactor"),
                          reactor_config=kw.get("reactor_config"))
    if b == "MQTT":
        from fedml_tpu_torch.comm.mqtt_backend import MqttBackend
        return MqttBackend(rank, size, host=kw.get("host", "127.0.0.1"),
                           port=kw.get("port", 1883),
                           client_factory=kw.get("client_factory"))
    raise ValueError(f"unknown comm backend {backend!r}")


class _Manager(Observer):
    node_type = "generic"

    def __init__(self, rank: int, size: int, backend: str = "INPROC", **kw):
        self.rank = rank
        self.size = size
        self.backend_name = backend
        self.com_manager = _build_backend(backend, rank, size, **kw)
        self.com_manager.add_observer(self)
        self.message_handler_dict: dict[object, Callable[[Message], None]] = {}
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- reference API -------------------------------------------------------
    def register_message_receive_handler(self, msg_type,
                                         handler: Callable[[Message], None]):
        self.message_handler_dict[msg_type] = handler

    def receive_message(self, msg_type, msg: Message) -> None:
        handler = self.message_handler_dict.get(msg_type)
        if handler is None:
            log.warning("%s rank %d: no handler for %r", self.node_type,
                        self.rank, msg_type)
            return
        # spans live at this chokepoint (not per backend) so every
        # transport's FSM dispatch/send shows on one timeline; the
        # byte/message counters live in the backends where frame sizes
        # are known (comm/base.py hooks)
        with obs.span("comm.handle", backend=self.backend_name,
                      node=self.node_type, rank=self.rank,
                      msg_type=str(msg_type)):
            try:
                handler(msg)
            except ManagerClosedError:
                if not self._closed:
                    raise      # a PEER's closed manager: real FSM bug
                # this manager finished while the handler was in
                # flight — its reply has nowhere to go; drop like the
                # pre-guard code did instead of killing the recv loop
                log.warning("%s rank %d: dropped handler send for %r "
                            "(manager finished mid-handler)",
                            self.node_type, self.rank, msg_type)

    def send_message(self, msg: Message) -> None:
        if self._closed:
            # loud, not silent: a send after finish() means the caller's
            # shutdown ordering is wrong (e.g. an async commit racing a
            # teardown) — dropping the frame here would surface later as
            # a peer hanging on a message that never left this process.
            # (receive_message downgrades the one benign case — a
            # handler already in flight when finish() landed.)
            raise ManagerClosedError(
                f"{self.node_type} rank {self.rank}: send_message after "
                f"finish() — the manager is closed")
        with obs.span("comm.send", backend=self.backend_name,
                      node=self.node_type, rank=self.rank,
                      msg_type=str(msg.get_type()),
                      receiver=msg.get_receiver_id()):
            self.com_manager.send_message(msg)

    def run(self) -> None:
        """Register handlers then block on the receive loop (the reference's
        run(), client_manager.py:42-45)."""
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()

    def run_async(self) -> threading.Thread:
        """Run the receive loop on a daemon thread (for in-process
        multi-rank simulations and tests)."""
        self.register_message_receive_handlers()
        self._thread = threading.Thread(
            target=self.com_manager.handle_receive_message, daemon=True)
        self._thread.start()
        return self._thread

    def register_message_receive_handlers(self) -> None:
        """Subclasses register their FSM here."""

    def finish(self) -> None:
        """Graceful stop — the reference calls MPI.COMM_WORLD.Abort()
        (client_manager.py:70-79); we stop the loop, close the backend,
        and JOIN the run_async() receive thread (with a bounded timeout:
        a backend whose recv loop is wedged must not hang teardown
        forever — the leak is logged instead).  Idempotent, and marks
        the manager closed so late send_message calls fail loudly
        instead of racing the closed transport."""
        if self._closed:
            return
        self._closed = True
        self.com_manager.stop_receive_message()
        close = getattr(self.com_manager, "close", None)
        if close is not None:
            close()
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=10)
            if self._thread.is_alive():
                log.warning(
                    "%s rank %d: receive thread still alive 10s after "
                    "finish() — backend recv loop did not stop",
                    self.node_type, self.rank)


class ClientManager(_Manager):
    node_type = "client"


class ServerManager(_Manager):
    node_type = "server"
