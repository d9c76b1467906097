"""Comm abstraction: BaseCommManager + Observer.

Parity: fedml_core/distributed/communication/base_com_manager.py:7-27 and
observer.py:4-7.  Backends push received Messages into an internal queue;
`handle_receive_message()` drains it and fans out to observers — a blocking
get instead of the reference's 0.3 s polling loop
(mpi/com_manager.py:71-78).
"""
from __future__ import annotations

import abc
import logging
import queue
import time

from fedml_tpu_torch import obs
from fedml_tpu_torch.obs import propagate
from fedml_tpu_torch.comm import reliability
from fedml_tpu_torch.comm.message import Message, MessageCodec

log = logging.getLogger(__name__)


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type, msg_params: Message) -> None: ...


class BaseCommManager(abc.ABC):
    """Backend interface. Concrete backends implement `send_message` and
    arrange for inbound messages to reach `_on_message` (thread-safe).

    Observability hooks: every backend carries byte/message counters in
    the process metrics registry, labeled by `backend_name` (a class
    attr each concrete backend sets).  Concrete send/recv paths call
    `_obs_sent(nbytes)` / `_obs_received(nbytes)` where the wire size
    is known, and `_obs_retry()` on reconnect/resend attempts — so
    "where did the round's bytes go" is answerable per backend from
    one Prometheus snapshot (fedml_tpu_torch/obs)."""

    backend_name = "base"
    # True when inbound traffic reaches the _deliver_frame chokepoint as
    # raw wire frames, so an installed frame sink actually sees it; a
    # backend whose receive path hands over already-decoded Messages
    # (broker JSON, no-encode inproc) must override with False so ingest
    # pools fall back to inline decode instead of idling silently
    supports_frame_sink = True
    # True when the backend can carry the reliability envelope (raw
    # binary frames + a way to push acks back): MQTT speaks broker JSON
    # (the broker's QoS is its reliability story) and a no-encode inproc
    # router never materializes frames — both override with False
    supports_reliability = True

    def __init__(self):
        self._observers: list[Observer] = []
        self._inbox: "queue.Queue[Optional[Message]]" = queue.Queue()
        self._running = False
        self._draining = False
        self._frame_sink = None
        self._ingest_pressure = None    # reactor backpressure probe
        self._ingest_ready_hooks = []   # reactor resume wakeups
        self._chaos = None              # ChaosPolicy (install_chaos)
        self._rel_ep = None             # lazy ReliableEndpoint
        self._reliable_tx = False       # sends are enveloped when True
        b = self.backend_name
        self._m_sent_msgs = obs.counter("comm_sent_messages_total",
                                        backend=b)
        self._m_sent_bytes = obs.counter("comm_sent_bytes_total", backend=b)
        self._m_recv_msgs = obs.counter("comm_received_messages_total",
                                        backend=b)
        self._m_recv_bytes = obs.counter("comm_received_bytes_total",
                                         backend=b)
        self._m_retries = obs.counter("comm_retries_total", backend=b)
        # robustness accounting: frames dropped at the bounded
        # inbox during shutdown drain, frames quarantined instead of
        # killing a recv thread, and recv threads that DID die (the
        # chaos acceptance gate demands this stays 0)
        self._m_dropped = obs.counter("comm_frames_dropped_total",
                                      backend=b)
        self._m_quarantined = obs.counter("comm_frames_quarantined_total")
        self._m_recv_deaths = obs.counter("comm_recv_thread_deaths_total")
        self._m_decode_seconds = obs.histogram(
            "comm_decode_seconds",
            buckets=obs.metrics.DECODE_SECONDS_BUCKETS, backend=b)
        # federation-wide tracing (fedml_tpu_torch/obs/propagate.py): per-peer
        # clock-offset estimator fed by the trace blocks send paths
        # stamp and receive paths strip at the chokepoints below
        self._clock = propagate.make_clock(b)

    # -- observability hooks -------------------------------------------------
    def _obs_sent(self, nbytes: int) -> None:
        self._m_sent_msgs.inc()
        self._m_sent_bytes.inc(nbytes)

    def _obs_received(self, nbytes: int) -> None:
        self._m_recv_msgs.inc()
        self._m_recv_bytes.inc(nbytes)

    def _obs_retry(self) -> None:
        self._m_retries.inc()

    # -- chaos + reliability ---------------------------------------
    def install_chaos(self, policy) -> None:
        """Install a seeded fault injector (comm/chaos.py) at this
        backend's two frame chokepoints: the send gate in _stamp_frame
        and the raw-frame receive path in _deliver_frame.  One policy
        may be shared across backends."""
        if not self.supports_frame_sink and self.backend_name != "mqtt":
            # a no-encode inproc router hands Message objects across —
            # frames never exist, so wire-level faults cannot apply
            log.warning(
                "chaos installed on %s, but this backend never "
                "materializes wire frames — only the send gate "
                "(partition/drop/delay) applies", self.backend_name)
        cfg = getattr(policy, "cfg", None)
        if (getattr(self, "reactor_mode", False) and cfg is not None
                and getattr(cfg, "delay", 0.0) > 0.0):
            # on the reactor transport the receive path runs on a
            # SHARED event loop: an injected delay sleeps the loop, so
            # it models a NIC-level stall hitting every conn on that
            # loop, not one slow peer (the thread transport's shape) —
            # loud, because the head-of-line coupling changes what the
            # fault measures
            log.warning(
                "chaos delay faults on the %s reactor transport stall "
                "the shared event loop (head-of-line for every conn on "
                "it), not just the injected peer — use the thread "
                "transport (reactor=False) for per-peer delay "
                "semantics", self.backend_name)
        self._chaos = policy

    def enable_reliability(self, policy=None) -> bool:
        """Opt this backend's SENDS into the reliability envelope
        (comm/reliability.py): per-peer seq + CRC32, ack/nack, backoff
        resend.  Receives always unwrap envelopes regardless (mixed
        deployments interoperate).  Returns False — and stays on the
        byte-identical pre-PR wire — under the FEDML_RELIABLE=0 escape
        hatch or on backends that can't carry the envelope."""
        if reliability.escape_hatch_off():
            log.info(
                "FEDML_RELIABLE=0: reliability envelope disabled on %s",
                self.backend_name)
            return False
        if not self.supports_reliability:
            log.warning(
                "reliability requested on %s, which cannot carry the "
                "envelope (broker JSON / no-encode router) — sends stay "
                "fire-and-forget", self.backend_name)
            return False
        self._reliability_endpoint(policy)
        self._reliable_tx = True
        return True

    def _reliability_endpoint(self, policy=None):
        """Lazy per-backend ReliableEndpoint — created on enable, or on
        the first inbound FMLR frame from an enveloping peer (so acks
        and the dedup ledger work even when this side's own sends are
        plain)."""
        if self._rel_ep is None:
            self._rel_ep = reliability.ReliableEndpoint(
                getattr(self, "rank", 0), self._raw_send, policy=policy,
                name=self.backend_name)
        return self._rel_ep

    def _raw_send(self, receiver: int, wire: bytes) -> None:
        """Raw wire write of pre-assembled bytes to a peer — the resend
        thread's and the ack path's transmit primitive.  Codec-framed
        backends override; the base refuses (MQTT / no-encode inproc
        never carry envelopes)."""
        raise NotImplementedError(
            f"{self.backend_name} has no raw-frame send path")

    def _chaos_disconnect(self, msg: Message) -> bool:
        """Backend hook for the disconnect-mid-frame fault: transmit a
        deliberately torn frame and kill the connection (TCP overrides).
        Returns False when unsupported — the gate degrades the fault to
        a drop."""
        return False

    # -- federation-wide tracing -----------------------------------
    def _stamp_frame(self, msg: Message) -> bool:
        """Outbound chokepoint twin of `_deliver_frame`: the chaos send
        gate (partition / per-peer drop / delay / disconnect-mid-frame),
        then the compact trace block (sender rank, send timestamps,
        span digest, clock echo) BEFORE encode.  Every concrete backend
        calls this first in `send_message` and returns without sending
        when it yields False.  With tracing disabled nothing is added —
        frames stay byte-identical to the untraced build (pinned in
        tests/test_wire_codec.py)."""
        chaos = self._chaos
        if chaos is not None:
            act, delay = chaos.plan_send(msg.get_receiver_id())
            if act in ("drop", "partition"):
                return False
            if act == "delay":
                time.sleep(min(delay, 1.0))
            elif act == "disconnect":
                self._chaos_disconnect(msg)
                return False        # the frame died mid-wire either way
        propagate.stamp(msg, getattr(self, "rank", 0), clock=self._clock)
        return True

    def _note_frame(self, msg: Message) -> None:
        """Strip + account the trace block / piggybacked metrics delta
        of an inbound Message before the FSM sees it (clock-offset
        estimate, trace.recv instant, cohort metrics fold)."""
        propagate.note(msg, backend=self.backend_name, clock=self._clock)

    # -- reference API -------------------------------------------------------
    @abc.abstractmethod
    def send_message(self, msg: Message) -> None: ...

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        """Blocking dispatch loop; returns after stop_receive_message()."""
        self._running = True
        while self._running:
            msg = self._inbox.get()
            if msg is None:       # sentinel from stop_receive_message
                break
            self._notify(msg)

    def stop_receive_message(self) -> None:
        self._running = False
        self._draining = True   # release recv threads blocked in put()
        if self._rel_ep is not None:
            self._rel_ep.close()           # stop the resend thread
        try:
            self._inbox.put_nowait(None)   # wake a get() blocked on empty
        except queue.Full:
            pass   # bounded + full: get() returns an item, sees _running

    def bound_inbox(self, maxsize: int) -> None:
        """Swap the unbounded inbox for a bounded one BEFORE traffic
        starts (ingestion-style consumers): a full inbox blocks
        `_on_message`, stalling the recv thread so transport flow
        control reaches the sender instead of decoded frames piling up
        on the heap — the legacy (sink-less) torture arm's memory
        bound."""
        self._inbox = queue.Queue(maxsize=maxsize)

    # -- backend-side delivery ----------------------------------------------
    def set_frame_sink(self, sink) -> None:
        """Install a raw-frame interceptor (the async ingest path,
        fedml_tpu/async_/lifecycle.py): inbound wire frames reach
        `sink(payload)` BEFORE decode, so an ingest pool can
        decode-into preallocated buffer rows off the recv thread.  The
        sink returns None when it consumed the frame, or a decoded
        Message to dispatch through the normal observer path.  A
        blocking sink is the backpressure mechanism: the transport's
        recv loop stalls, and flow control propagates to the sender."""
        self._frame_sink = sink

    def set_ingest_pressure(self, fn) -> None:
        """Install a non-blocking admission probe: `fn()`
        returns True while the consumer CANNOT take another frame (the
        decode pool is at its in-flight bound).  Reactor transports
        consult it BEFORE delivering a reassembled frame and suspend
        the peer's read interest instead of blocking a shared loop
        thread — the event-loop twin of the blocking-sink backpressure
        thread transports get for free.  Thread transports ignore it
        (their recv thread blocking in the sink IS the backpressure)."""
        self._ingest_pressure = fn

    def add_ingest_ready_hook(self, fn) -> None:
        """Register a wakeup a reactor loop installs the first time it
        suspends a peer for pressure: the consumer calls
        `_notify_ingest_ready()` whenever capacity frees, so paused
        reads resume within one event-loop wakeup instead of waiting
        for the housekeeping scan."""
        if fn not in self._ingest_ready_hooks:
            self._ingest_ready_hooks.append(fn)

    def _notify_ingest_ready(self) -> None:
        for fn in list(self._ingest_ready_hooks):
            try:
                fn()
            except Exception:
                log.exception("ingest-ready hook failed")

    def _reactor_pressure(self) -> bool:
        """True while a reactor must NOT deliver another frame: the
        installed ingest probe says the pool is full, or the bounded
        inbox is — both resolve by suspending reads, never by blocking
        the loop."""
        fn = self._ingest_pressure
        if fn is not None:
            try:
                if fn():
                    return True
            except Exception:
                log.exception("ingest pressure probe failed — treating "
                              "as no pressure")
        if self._inbox.maxsize > 0 and self._inbox.full():
            return True
        return False

    def _deliver_frame(self, payload, reply=None) -> None:
        """Inbound raw-frame chokepoint shared by every codec-framed
        backend: chaos receive faults first (drop/dup/reorder/delay/
        corrupt on the raw bytes), then per surviving frame the
        reliability envelope (CRC quarantine, dedup ledger, ack via
        `reply` — the transport's reverse channel — or _raw_send), then
        the frame sink when one is installed, otherwise inline decode
        (timed into comm_decode_seconds) and the dispatch queue.  A
        frame the codec rejects is QUARANTINED (counted + logged), never
        an exception up the recv thread."""
        chaos = self._chaos
        if chaos is not None:
            for p in chaos.filter_recv(payload):
                self._deliver_one(p, reply)
            return
        self._deliver_one(payload, reply)

    def _deliver_one(self, payload, reply=None) -> None:
        if bytes(payload[:4]) == reliability.MAGIC:
            payload = self._reliability_endpoint().on_wire(payload,
                                                           reply=reply)
            if payload is None:
                return              # ack/nack, suppressed dup, quarantine
        sink = self._frame_sink
        if sink is not None:
            msg = sink(payload)
            if msg is None:
                return
            self._note_frame(msg)   # idempotent (note pops the params)
        else:
            t0 = time.perf_counter()
            try:
                with obs.span("comm.decode", backend=self.backend_name,
                              nbytes=len(payload)):
                    msg = MessageCodec.decode(payload)
            except Exception as e:
                # corrupt/alien frame with no envelope to nack through:
                # quarantine instead of killing the recv thread
                self._m_quarantined.inc()
                log.warning(
                    "%s: undecodable frame (%d bytes) quarantined: %s",
                    self.backend_name, len(payload), e)
                return
            self._m_decode_seconds.observe(time.perf_counter() - t0)
            self._note_frame(msg)
        self._on_message(msg)

    def _on_message(self, msg: Message) -> None:
        if self._inbox.maxsize > 0:
            # bounded inbox: block (= recv-thread backpressure) but wake
            # periodically so shutdown can release us — a put() stuck
            # forever on a full queue after the dispatch loop exited
            # would leak every recv thread and its decoded payload
            while not self._draining:
                try:
                    self._inbox.put(msg, timeout=0.2)
                    return
                except queue.Full:
                    continue
            # shutting down: drop the frame — COUNTED, so the rollup
            # shows how much shutdown loss the drain swallowed instead
            # of it vanishing silently
            self._m_dropped.inc()
            return
        self._inbox.put(msg)

    def _notify(self, msg: Message) -> None:
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)
