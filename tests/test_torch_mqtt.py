"""The port's MQTT leg (fedml_tpu_torch/comm/mqtt_wire.py, mqtt_backend.py),
on the CPU.

* Topic matching answers as the JAX package's on a table of filters and
  topics; the reference topic scheme (the server publishes fedml0_<c> and
  subscribes fedml_<c>, clients the mirror image) holds through a fake
  paho client, and over real MQTT 3.1.1 frames through the in-repo broker
  with the fallback wire client (this box has no paho).
* The broker carries binary and text payloads, multi-MB payloads while
  keepalive pings interleave, and the manager FSM; `wire_compress` wraps
  the JSON in FMLZ zlib.
* A JAX MqttBackend and a port one exchange messages through one broker,
  both ways, and publish the same JSON bytes for the same message.
* Chaos receive faults act on the JSON payloads; the broker path refuses
  the reliability envelope, as in JAX.
* Messaging FedAvg over MQTT (LR on the mnist stand-in) is bitwise the
  same run over INPROC: f32 rides JSON floats exactly.

The broker listens on a free port above the ephemeral range; every wait is
bounded.
"""
import dataclasses
import importlib.util
import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.comm.mqtt_backend import MqttBackend as JaxMqttBackend
from fedml_tpu.comm.mqtt_wire import topic_matches as jax_topic_matches
from fedml_tpu_torch import obs
from fedml_tpu_torch.comm import ChaosConfig, ChaosPolicy, Message
from fedml_tpu_torch.comm.fedavg_messaging import run_messaging_fedavg
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.mqtt_backend import MqttBackend
from fedml_tpu_torch.comm.mqtt_wire import (MiniMqttBroker, MiniMqttClient,
                                            topic_matches)
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data.loaders import load_data
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import with_free_ports

torch.set_num_threads(2)
WAIT = 20.0


@pytest.fixture
def broker():
    b = with_free_ports(1, lambda base: MiniMqttBroker(port=base))
    yield b
    b.close()


class FakeBroker:
    """In-memory broker behind a paho-compatible fake client."""

    def __init__(self):
        self._subs, self._lock, self.sent = {}, threading.Lock(), []

    def client_factory(self, client_id):
        return _FakeClient(self, client_id)

    def subscribe(self, topic, client):
        with self._lock:
            self._subs.setdefault(topic, []).append(client)

    def publish(self, topic, payload):
        self.sent.append(payload)
        with self._lock:
            targets = list(self._subs.get(topic, []))
        for c in targets:
            c.deliver(topic, payload)


class _FakeMsg:
    def __init__(self, topic, payload):
        self.topic, self.payload = topic, payload


class _FakeClient:
    def __init__(self, broker, client_id):
        self._broker, self.client_id = broker, client_id
        self.on_message, self.connected = None, False

    def connect(self, host, port, keepalive):
        self.connected = True

    def subscribe(self, topic):
        self._broker.subscribe(topic, self)

    def publish(self, topic, payload):
        self._broker.publish(
            topic, payload.encode() if isinstance(payload, str) else payload)

    def deliver(self, topic, payload):
        if self.on_message is not None:
            self.on_message(self, None, _FakeMsg(topic, payload))

    def loop_start(self):
        pass

    def loop_stop(self):
        pass

    def disconnect(self):
        self.connected = False


def _wait_for(pred, timeout=WAIT):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.01)


def test_topic_matching_is_jax():
    filters = ["fedml_1", "fedml0_2", "a/+/c", "a/#", "#", "+", "a/b",
               "+/+", "a/+", "a/b/#"]
    topics = ["fedml_1", "fedml_2", "fedml0_2", "a/b/c", "a/b/d", "a/b",
              "a", "a/b/c/d", "x/y", ""]
    got = [[topic_matches(f, t) for t in topics] for f in filters]
    assert got == [[jax_topic_matches(f, t) for t in topics] for f in filters]
    assert topic_matches("a/#", "a/b/c/d") and not topic_matches("a/b", "a/b/c")


def test_topic_scheme_round_trip():
    fake = FakeBroker()
    server = MqttBackend(0, 3, client_factory=fake.client_factory)
    c1 = MqttBackend(1, 3, client_factory=fake.client_factory)
    c2 = MqttBackend(2, 3, client_factory=fake.client_factory)
    got = {}
    for name, b in (("server", server), ("c1", c1), ("c2", c2)):
        b._on_message = (lambda m, n=name: got.setdefault(n, []).append(m))
    up = Message(3, 1, 0)
    up.add_params("n", 17)
    c1.send_message(up)
    assert [m.get("n") for m in got["server"]] == [17] and set(got) == {
        "server"}
    down = Message(2, 0, 2)
    down.add_params("w", torch.eye(2))
    server.send_message(down)
    assert "c1" not in got and got["c2"][0].get("w") == [[1.0, 0.0],
                                                         [0.0, 1.0]]
    for b in (server, c1, c2):
        b.close()
    assert not server._mqtt.connected


def test_broker_round_trip_with_keepalive_pings(broker):
    got = []
    sub = MiniMqttClient(client_id="sub")
    sub.on_message = lambda c, u, m: got.append((m.topic, m.payload))
    sub.connect(broker.host, broker.port, keepalive=1)
    sub.subscribe("t/1")
    sub.loop_start()
    pub = MiniMqttClient(client_id="pub")
    pub.connect(broker.host, broker.port)
    try:
        pub.publish("t/1", b"\x00binary ok\xff")
        pub.publish("t/2", b"not subscribed")
        _wait_for(lambda: got)
        time.sleep(1.5)                   # pings keep the link alive
        pub.publish("t/1", "text ok")
        _wait_for(lambda: len(got) >= 2)
        assert got == [("t/1", b"\x00binary ok\xff"), ("t/1", b"text ok")]
    finally:
        pub.disconnect()
        sub.disconnect()


def test_large_payloads_with_pings(broker):
    """Multi-MB PUBLISHes arrive intact while pings interleave: the
    broker's per-connection write lock and the client's blocking reads."""
    got = []
    sub = MiniMqttClient(client_id="sub")
    sub.on_message = lambda c, u, m: got.append(m.payload)
    sub.connect(broker.host, broker.port, keepalive=1)
    sub.subscribe("big")
    sub.loop_start()
    pub = MiniMqttClient(client_id="pub")
    pub.connect(broker.host, broker.port, keepalive=1)
    pub.loop_start()
    blob = bytes(range(256)) * (8 << 10)              # 2 MiB
    try:
        for _ in range(3):
            pub.publish("big", blob)
            time.sleep(0.3)
        _wait_for(lambda: len(got) >= 3)
        assert all(p == blob for p in got)
    finally:
        pub.disconnect()
        sub.disconnect()


def test_backend_over_the_wire_falls_back_to_the_wire_client(broker):
    factory = (None if importlib.util.find_spec("paho") is None
               else MiniMqttClient)
    kw = dict(host=broker.host, port=broker.port, client_factory=factory)
    server, c1, c2 = (MqttBackend(r, 3, **kw) for r in range(3))
    try:
        assert isinstance(server._mqtt, MiniMqttClient)
        assert not server.supports_reliability
        assert server.enable_reliability() is False   # broker JSON: no envelope
        up = Message(3, 1, 0)
        up.add_params("w", torch.arange(6, dtype=torch.float32).reshape(2, 3))
        c1.send_message(up)
        got = server._inbox.get(timeout=WAIT)
        assert torch.equal(torch.as_tensor(got.get("w")),
                           torch.arange(6.0).reshape(2, 3))
        assert c1._inbox.qsize() == c2._inbox.qsize() == 0
    finally:
        for b in (server, c1, c2):
            b.close()


def test_manager_dispatch_over_mqtt(broker):
    log = []

    class Srv(ServerManager):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler(
                "hello", lambda m: (log.append(m.get("k")), self.finish()))

    kw = dict(host=broker.host, port=broker.port)
    srv = Srv(0, 2, "MQTT", **kw)
    cli = ClientManager(1, 2, "MQTT", **kw)
    assert type(srv.com_manager).__name__ == "MqttBackend"
    st = srv.run_async()
    m = Message("hello", 1, 0)
    m.add_params("k", 42)
    cli.send_message(m)
    st.join(timeout=WAIT)
    assert not st.is_alive() and log == [42]
    cli.finish()


def test_wire_compress_wraps_the_json_in_fmlz():
    fake = FakeBroker()
    server = MqttBackend(0, 2, client_factory=fake.client_factory)
    client = MqttBackend(1, 2, client_factory=fake.client_factory)
    try:
        w = torch.linspace(0.0, 1.0, 512).reshape(32, 16)
        msg = Message(2, 0, 1)
        msg.add_params("w", w)
        msg.wire_compress = True
        server.send_message(msg)
        got = client._inbox.get(timeout=WAIT)
        assert torch.equal(torch.as_tensor(got.get("w")), w)
        plain = Message(2, 0, 1).init(dict(msg.msg_params)).to_json().encode()
        assert fake.sent[-1][:4] == b"FMLZ" and len(fake.sent[-1]) < len(plain)
        import zlib
        assert zlib.decompress(fake.sent[-1][4:]) == plain
        other = Message(2, 0, 1)
        other.add_params("n", 7)
        server.send_message(other)
        assert fake.sent[-1][:1] == b"{"
        assert client._inbox.get(timeout=WAIT).get("n") == 7
    finally:
        server.close()
        client.close()


def _tree(seed):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(4, 3).astype(np.float32),
            "b": rs.randn(3).astype(np.float32)}


@pytest.mark.parametrize("port_is_server", [True, False])
def test_jax_and_port_peers_share_one_broker(broker, port_is_server):
    """Through one broker, both ways: the message a port peer publishes and
    the one a JAX peer publishes for the same content are the same JSON
    bytes, and each side reads the other's."""
    wire = []
    spy = MiniMqttClient(client_id="spy")
    spy.on_message = lambda c, u, m: wire.append((m.topic, m.payload))
    spy.connect(broker.host, broker.port)
    spy.subscribe("#")
    spy.loop_start()
    kw = dict(host=broker.host, port=broker.port, client_factory=MiniMqttClient)
    PortS, JaxS = ((MqttBackend, JaxMqttBackend) if port_is_server
                   else (JaxMqttBackend, MqttBackend))
    server, client = PortS(0, 2, **kw), JaxS(1, 2, **kw)
    try:
        tree = _tree(0)
        for sender, rx, msg_cls, leaf in (
                (server, client, Message if port_is_server else JaxMessage,
                 torch.from_numpy if port_is_server else np.asarray),
                (client, server, JaxMessage if port_is_server else Message,
                 np.asarray if port_is_server else torch.from_numpy)):
            m = msg_cls(2 if sender is server else 3, sender.rank, rx.rank)
            m.add_params("model_params", {k: leaf(v) for k, v in tree.items()})
            m.add_params("num_samples", 12.5)
            m.add_params("round_idx", 3)
            sender.send_message(m)
            got = rx._inbox.get(timeout=WAIT)
            for k, v in tree.items():
                np.testing.assert_array_equal(
                    np.asarray(got.get("model_params")[k], np.float32), v)
            assert got.get("num_samples") == 12.5 and got.get("round_idx") == 3
        _wait_for(lambda: len(wire) >= 2)
        (t_down, p_down), (t_up, p_up) = sorted(wire)
        assert (t_down, t_up) == ("fedml0_1", "fedml_1")
        # the same content from the other package: the same bytes
        for payload, cls, leaf, kind in (
                (p_down, Message, torch.from_numpy, 2),
                (p_down, JaxMessage, np.asarray, 2),
                (p_up, Message, torch.from_numpy, 3),
                (p_up, JaxMessage, np.asarray, 3)):
            m = cls(kind, 0 if kind == 2 else 1, 1 if kind == 2 else 0)
            m.add_params("model_params", {k: leaf(v) for k, v in tree.items()})
            m.add_params("num_samples", 12.5)
            m.add_params("round_idx", 3)
            assert m.to_json().encode() == payload
    finally:
        server.close()
        client.close()
        spy.disconnect()


def test_chaos_receive_faults_act_on_the_json(clean_obs):
    fake = FakeBroker()
    server = MqttBackend(0, 2, client_factory=fake.client_factory)
    client = MqttBackend(1, 2, client_factory=fake.client_factory)
    try:
        msg = Message(2, 0, 1)
        msg.add_params("n", 1)
        client.install_chaos(ChaosPolicy(ChaosConfig(dup=1.0, seed=0)))
        server.send_message(msg)
        assert client._inbox.qsize() == 2
        client.install_chaos(ChaosPolicy(ChaosConfig(
            corrupt=1.0, corrupt_nbytes=16, seed=0)))
        server.send_message(msg)
        assert client._inbox.qsize() == 2           # quarantined, not raised
        assert obs.counter("comm_frames_quarantined_total").value == 1
    finally:
        server.close()
        client.close()


@pytest.fixture
def clean_obs():
    obs.reset()
    yield
    obs.reset()


def test_messaging_fedavg_over_mqtt_is_inproc(broker):
    """FedML's edge leg: LR on the mnist stand-in, 4 clients, 2 rounds
    over MQTT, then 1 round with FMLZ; every global model bitwise the
    INPROC run's."""
    data = load_data("mnist", client_num_in_total=4, batch_size=10,
                     synthetic_scale=0.01, seed=0)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=2, epochs=1, batch_size=10, lr=0.03,
                    frequency_of_the_test=100)
    trainer = ClientTrainer(create_model("lr", 10), lr=cfg.lr)
    v0 = trainer.init(torch.Generator().manual_seed(0), "cpu")

    def run(backend, rounds, **kw):
        models = []
        c = dataclasses.replace(cfg, comm_round=rounds)
        out = run_messaging_fedavg(
            trainer, data, c, backend=backend, device="cpu",
            variables=dict(v0), timeout=60,
            on_round_done=lambda r, v: models.append(
                {k: t.clone() for k, t in v.items()}), **kw)
        return models + [out]

    want = run("INPROC", 2)
    got = run("MQTT", 2, host=broker.host, port=broker.port)
    zipped = run("MQTT", 1, host=broker.host, port=broker.port,
                 wire_compress=True)
    for a, b in zip(got[:2] + zipped[:1], want[:2] + want[:1]):
        for k in v0:
            assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
    assert any(not torch.equal(want[-1][k], v0[k]) for k in v0)
