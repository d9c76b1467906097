"""gRPC comm backend — WAN / cross-silo transport (port of
fedml_tpu/comm/grpc_backend.py).

Parity: fedml_core/distributed/communication/gRPC/grpc_comm_manager.py:22-119
+ grpc_server.py:9-40.  Differences by design (SURVEY.md flags these):

  * one port scheme: every rank serves on base_port+rank and peers dial the
    same (the reference binds 50000+rank but dials 8888+receiver —
    grpc_comm_manager.py:41-61);
  * no busy-wait dispatch thread (grpc_comm_manager.py:87-98) — the servicer
    pushes straight into the manager's blocking inbox;
  * messages ride the binary MessageCodec frame through a *generic* RPC
    method (bytes in, bytes out), so no protobuf stub codegen is needed;
    1 GB max message kept (reference :36-40).

ip_config: {rank: ip} dict or a CSV path with `receiver_id,ip` rows
(ip_config_utils.py parity).

``grpc`` is imported when a GrpcBackend is built, not with this module:
the TCP transports import `load_ip_config` from here, and a machine that
runs them (the card's) may have no grpcio.  The service name stays
"fedml_tpu.Comm", so a port peer and a JAX-package peer can call each
other.
"""
from __future__ import annotations

import csv
import logging
import os
import time
from concurrent import futures
from typing import Optional, Union

from fedml_tpu_torch.comm import reliability
from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.comm.reliability import BackoffPolicy

log = logging.getLogger(__name__)

# per-send RPC deadline: the old hard-coded timeout=1800 with no retry
# — now a constructor knob with an env override for
# deployments that can't touch the construction site
ENV_SEND_TIMEOUT = "FEDML_GRPC_TIMEOUT_S"
DEFAULT_SEND_TIMEOUT_S = 1800.0

_SERVICE = "fedml_tpu.Comm"
_METHOD = f"/{_SERVICE}/SendMessage"
_MAX_MSG = 1000 * 1024 * 1024
_OPTS = [("grpc.max_send_message_length", _MAX_MSG),
         ("grpc.max_receive_message_length", _MAX_MSG),
         ("grpc.enable_http_proxy", 0)]


def open_stub(host: str, port: int):
    """(channel, unary stub, grpc.RpcError) for the server at host:port:
    the raw client the ingest torture's gRPC uplink spammers drive."""
    import grpc
    ch = grpc.insecure_channel(f"{host}:{port}", options=_OPTS)
    return ch, ch.unary_unary(_METHOD), grpc.RpcError


def load_ip_config(path_or_dict: Union[str, dict]) -> dict[int, str]:
    """CSV `receiver_id,ip` → {rank: ip} (gRPC/ip_config_utils.py parity)."""
    if isinstance(path_or_dict, dict):
        return {int(k): v for k, v in path_or_dict.items()}
    out = {}
    with open(path_or_dict) as f:
        for row in csv.reader(f):
            if not row or row[0].strip().lower() in ("receiver_id", ""):
                continue
            out[int(row[0])] = row[1].strip()
    return out


class GrpcBackend(BaseCommManager):
    backend_name = "grpc"

    def __init__(self, rank: int, ip_config: Union[str, dict],
                 base_port: int = 50000, max_workers: int = 8,
                 send_timeout_s: Optional[float] = None,
                 send_backoff: Optional[BackoffPolicy] = None):
        import grpc
        super().__init__()
        self._grpc = grpc
        self.rank = rank
        self.ip_config = load_ip_config(ip_config)
        self.base_port = base_port
        env_t = os.environ.get(ENV_SEND_TIMEOUT)
        self.send_timeout_s = float(
            send_timeout_s if send_timeout_s is not None
            else (env_t if env_t else DEFAULT_SEND_TIMEOUT_S))
        # transient-failure retry for plain (non-enveloped) sends —
        # drawn from the same BackoffPolicy the reliability layer and
        # the TCP/native connect loops use, not another ad-hoc sleep
        self.send_backoff = send_backoff if send_backoff is not None \
            else BackoffPolicy(base_s=0.5, mult=2.0, max_s=8.0,
                               jitter=0.25, max_attempts=4)
        self._channels: dict = {}
        self._stubs: dict = {}

        def handle(request: bytes, context) -> bytes:
            self._obs_received(len(request))
            # _deliver_frame: inline decode or the async ingest sink;
            # a blocked sink holds this servicer thread, so gRPC's
            # bounded executor is the backpressure.  The unary RESPONSE
            # is the reliability reply channel: when the frame carried
            # the FMLR envelope, the ack/nack rides back as the RPC
            # result instead of b"ok".
            out: list[bytes] = []
            try:
                self._deliver_frame(request, reply=out.append)
            except Exception:
                self._m_recv_deaths.inc()
                log.exception("grpc servicer died on an unexpected error")
            return out[0] if out else b"ok"

        handler = grpc.method_handlers_generic_handler(_SERVICE, {
            "SendMessage": grpc.unary_unary_rpc_method_handler(handle),
        })
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_OPTS)
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(
            f"0.0.0.0:{base_port + rank}")
        self._server.start()
        log.info("gRPC rank %d serving on :%d", rank, self.port)

    def _stub(self, receiver: int):
        if receiver not in self._stubs:
            ip = self.ip_config[receiver]
            ch = self._grpc.insecure_channel(
                f"{ip}:{self.base_port + receiver}", options=_OPTS)
            self._channels[receiver] = ch
            self._stubs[receiver] = ch.unary_unary(_METHOD)
        return self._stubs[receiver]

    def _raw_send(self, receiver: int, wire: bytes) -> None:
        """Raw transmit for the reliability layer; the unary response
        carries the peer's ack/nack, fed straight back into the
        endpoint (so a successful RPC usually clears the outstanding
        entry synchronously)."""
        resp = self._stub(receiver)(bytes(wire),
                                    timeout=self.send_timeout_s,
                                    wait_for_ready=True)
        if resp and bytes(resp[:4]) == reliability.MAGIC:
            self._reliability_endpoint().on_wire(resp)

    def send_message(self, msg: Message) -> None:
        # encode applies the v2 wire features (transport dtypes, zlib
        # head); gRPC's unary call needs the one contiguous frame
        if not self._stamp_frame(msg):
            return                  # chaos send gate dropped the frame
        payload = MessageCodec.encode(msg)
        rx = msg.get_receiver_id()
        if self._reliable_tx:
            wire = self._reliability_endpoint().send(rx, payload)
            self._obs_sent(len(wire))
            return
        # wait_for_ready rides out the multi-process startup race (peer's
        # server not bound yet) instead of failing UNAVAILABLE immediately;
        # transient RpcErrors retry on the shared backoff schedule
        # (was a hard-coded timeout=1800, no retry)
        attempt = 0
        while True:
            try:
                self._stub(rx)(payload, timeout=self.send_timeout_s,
                               wait_for_ready=True)
                break
            except self._grpc.RpcError:
                attempt += 1
                if attempt >= self.send_backoff.max_attempts:
                    raise
                self._obs_retry()
                time.sleep(self.send_backoff.delay(attempt))
        self._obs_sent(len(payload))

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()
        self._server.stop(grace=1)
