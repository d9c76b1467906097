"""The port's arrival processes (fedml_tpu_torch/scale/arrivals.py) and its
connection swarm (fedml_tpu_torch/comm/connswarm.py), on the CPU.

* The same seed gives the JAX package's arrival times bitwise, for every
  mode (constant, diurnal, flash crowd, a replayed trace), with the same
  rates, rate fractions and slowdowns; the configuration refuses the same
  inputs.
* The swarm's uplink bytes (the FMLR envelope around a frame) are the JAX
  swarm's for the same seed and senders, and its seeded draws the same.
* A 16-connection swarm in this process against the port's reactor: every
  uplink the swarm sent is delivered once and acked once.

The reactor listens on a free port above the ephemeral range; every wait
is bounded.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from fedml_tpu.comm import connswarm as jax_connswarm
from fedml_tpu.scale import arrivals as jax_arrivals
from fedml_tpu_torch.comm import Message, MessageCodec, reliability
from fedml_tpu_torch.comm.connswarm import (ConnectionSwarm, SwarmConfig,
                                            _CConn)
from fedml_tpu_torch.comm.tcp_backend import TcpBackend
from fedml_tpu_torch.scale import arrivals
from tests.test_torch_transports import _close, with_free_ports

torch.set_num_threads(2)
WAIT = 20.0

MODES = {
    "constant": dict(mode="constant", rate=40.0, seed=3),
    "diurnal": dict(mode="diurnal", rate=50.0, period_s=60.0, amplitude=0.8,
                    seed=5),
    "flash": dict(mode="flash", rate=20.0, period_s=100.0, amplitude=0.3,
                  flash_at_s=5.0, flash_duration_s=3.0, flash_boost=6.0,
                  seed=9),
}


def _take(proc, n=500, rng=None):
    it = proc.arrivals(0.25, rng)
    return np.asarray([next(it) for _ in range(n)])


@pytest.mark.parametrize("mode", sorted(MODES) + ["trace"])
def test_arrivals_are_the_jax_arrivals(mode, tmp_path):
    """Bitwise: the default seeded stream and a caller's generator give
    the JAX times; rate, rate_fraction and slowdown agree on a grid."""
    if mode == "trace":
        times = np.random.RandomState(0).exponential(0.1, 300).cumsum()
        path = tmp_path / "trace.txt"
        path.write_text("".join(f"{float(t)!r}\n" for t in times))
        kw = dict(mode="trace", trace_path=str(path))
    else:
        kw = MODES[mode]
    port = arrivals.make_arrivals(arrivals.ArrivalConfig(**kw))
    ref = jax_arrivals.make_arrivals(jax_arrivals.ArrivalConfig(**kw))
    assert type(port).__name__ == type(ref).__name__
    if mode == "trace":          # the whole replay after t0
        got, want = (np.asarray(list(p.arrivals(0.25))) for p in (port, ref))
        assert got.size == np.count_nonzero(times > 0.25)
    else:
        got, want = _take(port), _take(ref)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) >= 0)
    if mode != "trace":
        np.testing.assert_array_equal(
            _take(port, rng=np.random.default_rng([1, 2])),
            _take(ref, rng=np.random.default_rng([1, 2])))
    for t in np.linspace(0.0, 40.0, 97):
        assert port.rate(t) == ref.rate(t)
        assert port.rate_fraction(t) == ref.rate_fraction(t)
        assert port.slowdown(t) == ref.slowdown(t)
    assert port.peak_rate == ref.peak_rate


def test_arrivals_seeds_differ_and_shape_the_rate():
    proc = arrivals.DiurnalArrivals(rate=100.0, period_s=100.0, amplitude=0.9)
    a = _take(proc, rng=np.random.default_rng(0))
    assert not np.array_equal(a, _take(proc, rng=np.random.default_rng(1)))
    ts = _take(proc, 4000, np.random.default_rng(0))
    ts = ts[ts < 100.0]
    peak = np.count_nonzero((ts >= 15.0) & (ts < 35.0))
    trough = np.count_nonzero((ts >= 65.0) & (ts < 85.0))
    assert peak > 4 * trough and proc.slowdown(75.0) > 3 * proc.slowdown(25.0)


@pytest.mark.parametrize("bad, match", [
    (dict(mode="tidal"), "unknown arrival mode"),
    (dict(mode="diurnal", amplitude=1.5), "amplitude"),
    (dict(mode="constant", rate=0.0), "rate"),
])
def test_arrival_config_refuses_as_jax(bad, match):
    for cfg_cls in (arrivals.ArrivalConfig, jax_arrivals.ArrivalConfig):
        with pytest.raises(ValueError, match=match):
            cfg_cls(**bad)
    with pytest.raises(ValueError, match="trace_path"):
        arrivals.make_arrivals(arrivals.ArrivalConfig(mode="trace"))
    assert arrivals.make_arrivals(arrivals.ArrivalConfig()) is None
    with pytest.raises(ValueError, match="empty arrival trace"):
        arrivals.TraceArrivals([])


class _Sock:
    """Captures what the swarm writes to a connection."""
    _fd = 1000

    def __init__(self):
        self.sent = []
        _Sock._fd += 1
        self.fd = _Sock._fd

    def fileno(self):
        return self.fd

    def send(self, buf):
        self.sent.append(bytes(buf))
        return len(buf)


def _frame():
    m = Message(3, 1, 0)
    m.add_params("w", torch.arange(8, dtype=torch.float32))
    return MessageCodec.encode(m)


def test_swarm_envelope_bytes_and_draws_are_jax():
    cfg = dict(host="127.0.0.1", port=1, n_connections=4, seed=13,
               churn_lifetime_s=2.0,
               arrival=dataclasses.asdict(arrivals.ArrivalConfig(
                   mode="diurnal", rate=5.0, period_s=10.0, seed=2)))
    frame = _frame()
    port = ConnectionSwarm(SwarmConfig(**cfg), frame)
    ref = jax_connswarm.ConnectionSwarm(jax_connswarm.SwarmConfig(**cfg), frame)
    assert SwarmConfig(**cfg).to_json() == jax_connswarm.SwarmConfig(
        **cfg).to_json()
    assert SwarmConfig.from_json(SwarmConfig(**cfg).to_json()) == \
        SwarmConfig(**cfg)
    wires = []
    for swarm, mod in ((port, None), (ref, jax_connswarm)):
        make = mod._CConn if mod else _CConn
        conns = {}
        for sender in (1, 2, 3, 1, 4, 1):
            c = conns.setdefault(sender, make(_Sock(), sender,
                                              target="127.0.0.1:1"))
            c.connected = True
            swarm._conns[c.fd] = c
            assert swarm._uplink(c)
        wires.append({s: c.sock.sent for s, c in conns.items()})
        wires.append([float(swarm._rng.random()) for _ in range(8)])
        wires.append([swarm._arr.rate_fraction(t) for t in (0.0, 2.5, 7.5)])
    assert wires[:3] == wires[3:]
    sent = wires[0][1]
    head = reliability._HEADER.unpack(sent[1][8:8 + reliability.HEADER_LEN])
    assert head[:4] == (reliability.MAGIC, reliability.KIND_DATA, 1, 1)
    assert sent[1][8 + reliability.HEADER_LEN:] == frame
    assert port.stats["frames_sent"] == 6


def test_swarm_of_16_connections_against_the_reactor():
    """Every uplink the swarm sends reaches the reactor once (the
    envelope's ledger suppresses nothing: each (sender, seq) is new) and
    is acked once over the connection it came in on."""
    n_conn = 16
    server = with_free_ports(1, lambda base: TcpBackend(
        0, {0: "127.0.0.1"}, base, reactor=True))
    ep = server._reliability_endpoint()
    acks = []
    real = ep._control

    def control(kind, peer, seq, reply):
        acks.append((kind, peer, seq))
        real(kind, peer, seq, reply)

    ep._control = control
    swarm = ConnectionSwarm(SwarmConfig(
        host="127.0.0.1", port=server.base_port, n_connections=n_conn,
        offered_rate=400.0, ramp_s=0.2, seed=1), _frame()).start()
    try:
        time.sleep(1.5)
    finally:
        swarm.join(timeout=WAIT)
    try:
        assert not swarm._thread.is_alive()
        sent = swarm.stats["frames_sent"]
        assert swarm.stats["connects"] == n_conn and sent > n_conn
        t0 = time.monotonic()
        while server._inbox.qsize() < sent and time.monotonic() - t0 < WAIT:
            time.sleep(0.02)
        time.sleep(0.2)
        got = [server._inbox.get_nowait() for _ in range(server._inbox.qsize())]
        assert len(got) == sent
        assert all(torch.equal(m.get("w"), torch.arange(8.0)) for m in got)
        data_acks = [a for a in acks if a[0] == reliability.KIND_ACK]
        assert len(data_acks) == sent == len(set(data_acks))
        assert {p for _, p, _ in data_acks} == set(range(1, n_conn + 1))
    finally:
        _close(server)
