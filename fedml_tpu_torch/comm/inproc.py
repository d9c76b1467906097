"""In-process comm backend — N logical ranks in one process.

The reference fakes multi-node with localhost MPI processes
(run_fedavg_distributed_pytorch.sh:19-21, SURVEY.md §4.5); here the same
manager/FSM code runs over an in-memory router, so the full message-driven
algorithm stack (init → local train → upload → aggregate → sync) is unit
-testable with zero sockets.  Frames still go through MessageCodec
encode/decode so the wire path is exercised.
"""
from __future__ import annotations

import threading

from fedml_tpu_torch.comm.base import BaseCommManager
from fedml_tpu_torch.comm.message import Message, MessageCodec


class InProcRouter:
    """Shared mailbox fabric; one per simulated deployment."""

    def __init__(self, encode: bool = True):
        self._backends: dict[int, "InProcBackend"] = {}
        self._lock = threading.Lock()
        self.encode = encode

    def register(self, rank: int, backend: "InProcBackend") -> None:
        with self._lock:
            self._backends[rank] = backend

    def deliver_raw(self, rank: int, wire: bytes) -> None:
        """Raw-frame delivery (the reliability layer's resends/acks):
        the pre-assembled wire bytes go straight through the receiver's
        _deliver_frame chokepoint, same as an encoded route()."""
        with self._lock:
            dst = self._backends.get(rank)
        if dst is None:
            raise KeyError(f"no backend registered for rank {rank}")
        dst._obs_received(len(wire))
        dst._deliver_frame(wire)

    def route(self, msg: Message) -> int:
        """Deliver; returns the encoded frame size (0 when encode=False
        skips the codec) so both endpoints' byte counters agree."""
        rank = msg.get_receiver_id()
        with self._lock:
            dst = self._backends.get(rank)
        if dst is None:
            raise KeyError(f"no backend registered for rank {rank}")
        nbytes = 0
        if self.encode:   # exercise the wire codec even in-memory —
            # including the v2 transport/compression features a sender
            # opted into, so the simulation sees the same lossy values
            # a socket deployment would.  The raw frame goes through
            # the receiver's _deliver_frame chokepoint, so an installed
            # ingest sink (async decode pool) sees inproc traffic too.
            payload = MessageCodec.encode(msg)
            nbytes = len(payload)
            dst._obs_received(nbytes)
            dst._deliver_frame(payload)
            return nbytes
        dst._obs_received(nbytes)
        # no-encode: the Message object crosses directly — strip the
        # sender's trace stamp here (the codec-framed _deliver_frame
        # chokepoint never runs) so handlers don't see obs params
        dst._note_frame(msg)
        dst._on_message(msg)
        return nbytes


class InProcBackend(BaseCommManager):
    backend_name = "inproc"

    def __init__(self, rank: int, router: InProcRouter):
        super().__init__()
        self.rank = rank
        self.router = router
        router.register(rank, self)

    @property
    def supports_frame_sink(self) -> bool:
        # a no-encode router hands Message objects across directly —
        # frames never exist, so a sink would never fire
        return bool(self.router.encode)

    @property
    def supports_reliability(self) -> bool:
        # same constraint: the envelope wraps wire frames, which a
        # no-encode router never materializes
        return bool(self.router.encode)

    def _raw_send(self, receiver: int, wire: bytes) -> None:
        self.router.deliver_raw(receiver, wire)

    def send_message(self, msg: Message) -> None:
        if not self._stamp_frame(msg):
            return                  # chaos send gate dropped the frame
        if self._reliable_tx:
            payload = MessageCodec.encode(msg)
            wire = self._reliability_endpoint().send(
                msg.get_receiver_id(), payload)
            self._obs_sent(len(wire))
            return
        self._obs_sent(self.router.route(msg))
