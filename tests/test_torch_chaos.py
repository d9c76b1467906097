"""The port's chaos layer (fedml_tpu_torch/comm/chaos.py) and the
reliability envelope under it, on the CPU.

* The same seed and frames give the JAX policy's schedule bitwise: every
  plan_send action and delay, every filter_recv output, the event trace
  and the summary (three configurations: receive faults, per-peer send
  overrides with disconnects, reorder-heavy).  One deliberate
  difference: a reorder-held frame waits on its own receive stream (the
  JAX policy's one slot could release it behind another connection's
  frame, acking it to the wrong peer and hanging a round: seed 1 of the
  round test below did).
* Receive faults act through the port's backends at the _deliver_frame
  chokepoint (INPROC, TCP); a partition blocks sends until heal; a torn
  frame over TCP kills one connection, never a receive thread.
* The reliable envelope delivers every message exactly once under
  dropped, duplicated and corrupted frames.
* A messaging FedAvg round (ResNet-18-GN at 4 filters, 2 clients) over
  TCP with reliability and chaos on every rank is bitwise the clean
  round, and no client trained twice.

Socket tests take free ports above the ephemeral range; every wait is
bounded.
"""
import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.comm.chaos import ChaosConfig as JaxChaosConfig
from fedml_tpu.comm.chaos import ChaosPolicy as JaxChaosPolicy
from fedml_tpu_torch import obs
from fedml_tpu_torch.comm import (BackoffPolicy, ChaosConfig, ChaosPolicy,
                                  InProcBackend, InProcRouter, Message)
from fedml_tpu_torch.comm.fedavg_messaging import (FedAvgAggregator,
                                                   FedAvgClientManager,
                                                   FedAvgServerManager)
from fedml_tpu_torch.comm.tcp_backend import TcpBackend
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import _close, with_free_ports

torch.set_num_threads(2)
WAIT = 30.0

SCHEDULES = {
    "recv": dict(drop=0.1, dup=0.1, reorder=0.05, delay=0.05, corrupt=0.1,
                 delay_s=1e-4, corrupt_nbytes=3, seed=7),
    "send": dict(drop=0.05, disconnect=0.1, delay_s=0.5, seed=3,
                 per_peer={1: {"drop": 0.2, "delay": 0.3},
                           2: {"disconnect": 0.5}}),
    "reorder": dict(reorder=0.4, dup=0.2, seed=11),
}


def _drive(policy, payloads, peers=(1, 2, 3)):
    """One thread, a fixed order: each frame through the receive path,
    then one send-gate draw for the next peer (one partitioned a third of
    the way in, healed at two thirds)."""
    out = []
    for i, p in enumerate(payloads):
        if i == len(payloads) // 3:
            policy.partition(2)
        if i == 2 * len(payloads) // 3:
            policy.heal(2)
        out.append(("recv", tuple(bytes(x) for x in policy.filter_recv(p))))
        out.append(("send", policy.plan_send(peers[i % len(peers)])))
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_chaos_schedule_is_the_jax_schedule(name):
    """Bitwise: the same seed, peers and frames give the JAX policy's
    every send action and delay, every delivered frame (dropped,
    duplicated, reordered, byte-flipped), its trace and its summary."""
    rs = np.random.RandomState(0)
    payloads = [rs.bytes(int(n)) for n in rs.randint(1, 200, 300)]
    cfg = SCHEDULES[name]
    port = _drive(ChaosPolicy(ChaosConfig(**cfg)), payloads)
    ref = JaxChaosPolicy(JaxChaosConfig(**cfg))
    want = _drive(ref, payloads)
    assert port == want
    pol = ChaosPolicy(ChaosConfig(**cfg))
    _drive(pol, payloads)
    assert pol.trace() == ref.trace() and pol.summary() == ref.summary()
    assert len(pol.summary()) >= 2            # faults did fire


def test_chaos_seed_deterministic_and_seeds_differ():
    mk = lambda seed: ChaosPolicy(ChaosConfig(
        drop=0.1, dup=0.1, reorder=0.05, corrupt=0.1, disconnect=0.05,
        seed=seed))
    pay = [b"FML1" + bytes(64)] * 400
    a, b, c = mk(7), mk(7), mk(8)
    for p in (a, b, c):
        _drive(p, pay)
    assert a.trace() == b.trace() and a.trace() != c.trace()
    assert set(a.summary()) >= {"drop", "dup", "corrupt", "disconnect"}
    with pytest.raises(ValueError, match="outside"):
        ChaosConfig(drop=1.5)


def test_chaos_is_exported_and_counts_into_the_registry(clean_obs):
    import fedml_tpu_torch.comm as comm
    assert comm.ChaosPolicy is ChaosPolicy and comm.ChaosConfig is ChaosConfig
    pol = ChaosPolicy(drop=1.0, seed=0)          # rates as keywords
    assert list(pol.filter_recv(b"x")) == []
    assert obs.counter("comm_chaos_injected_total").value == 1


@pytest.fixture
def clean_obs():
    obs.reset()
    yield
    obs.reset()


def _tcp_pair(reactor=False):
    ip = {0: "127.0.0.1", 1: "127.0.0.1"}

    def make(base):
        a = TcpBackend(1, ip, base, reactor=reactor)
        try:
            return a, TcpBackend(0, ip, base, reactor=reactor)
        except BaseException:
            _close(a)
            raise
    return with_free_ports(2, make)


def _msg(n=4):
    msg = Message(1, 1, 0)
    msg.add_params("w", torch.arange(n, dtype=torch.float32))
    return msg


def _drain(backend, n, timeout=WAIT):
    got = [backend._inbox.get(timeout=timeout) for _ in range(n)]
    time.sleep(0.1)
    assert backend._inbox.qsize() == 0
    return got


@pytest.mark.parametrize("kind", ["INPROC", "TCP"])
def test_chaos_recv_faults_through_the_backends(kind):
    """drop=1.0 delivers nothing; dup=1.0 without the dedup ledger
    delivers each frame twice: injected at the receiving backend's
    _deliver_frame, not by the test."""
    if kind == "INPROC":
        router = InProcRouter()
        src, dst = InProcBackend(1, router), InProcBackend(0, router)
    else:
        src, dst = _tcp_pair()
    try:
        dst.install_chaos(ChaosPolicy(ChaosConfig(drop=1.0, seed=0)))
        src.send_message(_msg())
        time.sleep(0.2)
        assert dst._inbox.qsize() == 0
        dst.install_chaos(ChaosPolicy(ChaosConfig(dup=1.0, seed=0)))
        src.send_message(_msg())
        for m in _drain(dst, 2):
            assert torch.equal(m.get("w"), torch.arange(4.0))
    finally:
        _close(src, dst)


def test_chaos_partition_blocks_sends_until_heal():
    router = InProcRouter()
    src, dst = InProcBackend(1, router), InProcBackend(0, router)
    pol = ChaosPolicy(ChaosConfig(seed=0))
    src.install_chaos(pol)
    pol.partition(0)
    src.send_message(_msg())
    assert dst._inbox.qsize() == 0
    assert pol.summary() == {"partition": 1} and pol.partitioned() == {0}
    pol.heal()
    src.send_message(_msg())
    assert dst._inbox.qsize() == 1


def test_chaos_disconnect_mid_frame_over_tcp(clean_obs):
    """The sender writes half a frame and kills the connection; the
    receiver drops that connection only (no receive-thread death), and
    the next clean send lands over a new dial."""
    a, b = _tcp_pair()
    try:
        pol = ChaosPolicy(ChaosConfig(disconnect=1.0, seed=0))
        a.install_chaos(pol)
        a.send_message(_msg(64))                   # torn mid-frame
        assert pol.summary() == {"disconnect": 1}
        a.install_chaos(None)
        a.send_message(_msg(64))
        got = b._inbox.get(timeout=WAIT)
        assert torch.equal(got.get("w"), torch.arange(64.0))
        time.sleep(0.1)
        assert obs.counter("comm_recv_thread_deaths_total").value == 0
    finally:
        _close(a, b)


def test_chaos_reactor_delay_warns(caplog):
    """On the reactor a receive delay stalls the shared loop: installing
    one says so (the reason the chaos round runs on threads)."""
    a, b = _tcp_pair(reactor=True)
    try:
        with caplog.at_level("WARNING"):
            b.install_chaos(ChaosPolicy(ChaosConfig(delay=0.1, seed=0)))
        assert "stall the shared event loop" in caplog.text
    finally:
        _close(a, b)


def test_reorder_swaps_never_silently_drops():
    pol = ChaosPolicy(ChaosConfig(reorder=1.0, seed=0))
    frames = [bytes([i]) * 8 for i in range(5)]
    out = []
    for f in frames:
        out.extend(pol.filter_recv(f))
    assert out == frames[:-1] and pol.summary()["reorder"] == 5


def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=WAIT)
    assert not t.is_alive()
    return out[0]


def test_reorder_releases_a_held_frame_on_its_own_stream_only():
    """The port keeps a reorder slot per receive stream: a frame held on
    one connection's thread comes out behind that connection's next frame,
    never behind another connection's (whose reply channel would carry
    its ack to the wrong peer).  The JAX policy's one slot releases it on
    the other thread."""
    for policy, crossed in ((ChaosPolicy, False), (JaxChaosPolicy, True)):
        cfg = (ChaosConfig if policy is ChaosPolicy else JaxChaosConfig)(
            reorder=1.0, seed=0)
        pol = policy(cfg)
        a1, b1, a2 = b"A1" * 4, b"B1" * 4, b"A2" * 4
        assert tuple(pol.filter_recv(a1)) == ()          # this thread: A
        got_b = _in_thread(lambda: tuple(pol.filter_recv(b1)))
        got_a = tuple(pol.filter_recv(a2))
        if crossed:
            assert got_b == (a1,) and got_a == (b1,)
        else:
            assert got_b == () and got_a == (a1,)


@pytest.mark.parametrize("kind", ["INPROC", "TCP"])
def test_reliable_round_trip_under_drop_dup_and_corrupt(kind, clean_obs):
    """Every message arrives exactly once, bitwise: drops are resent,
    duplicates suppressed by the ledger, corrupted frames quarantined and
    resent."""
    if kind == "INPROC":
        router = InProcRouter()
        src, dst = InProcBackend(1, router), InProcBackend(0, router)
    else:
        src, dst = _tcp_pair()
    try:
        assert src.enable_reliability(BackoffPolicy(
            base_s=0.02, mult=1.5, max_s=0.1, jitter=0.0, max_attempts=60))
        pol = ChaosPolicy(ChaosConfig(drop=0.2, dup=0.2, corrupt=0.2,
                                      corrupt_nbytes=4, seed=5))
        dst.install_chaos(pol)
        n = 30
        for i in range(n):
            m = Message(1, 1, 0)
            m.add_params("w", torch.full((16,), float(i)))
            m.add_params("i", i)
            src.send_message(m)
        assert src._rel_ep.flush(timeout=WAIT)
        got = sorted(_drain(dst, n), key=lambda m: m.get("i"))
        assert [m.get("i") for m in got] == list(range(n))
        for m in got:
            assert torch.equal(m.get("w"), torch.full((16,), float(m.get("i"))))
        kinds = pol.summary()
        assert kinds.get("drop") and kinds.get("dup") and kinds.get("corrupt")
        assert obs.counter("comm_reliable_dups_suppressed_total").value > 0
    finally:
        _close(src, dst)


# ---------------------------------------------------------------------------
# a messaging round under chaos is the clean round
# ---------------------------------------------------------------------------

def _data(n_clients=2, per=8, bs=4, hw=8):
    rs = np.random.RandomState(0)
    n = n_clients * per
    x = rs.rand(n, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)}
    ev = tfed.build_eval_shard(x[:bs], y[:bs], bs)
    return tfed.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=tfed.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def hardened_fedavg(trainer, data, cfg, v0, chaos=None, reliable=False):
    """run_messaging_fedavg over Python TCP on threads, built manager by
    manager so that each rank can be hardened as a deployment's CLI does:
    the reliability envelope, and a chaos policy of its own (one per
    rank, as one per process)."""
    size = cfg.client_num_per_round + 1

    def run(base):
        kw = dict(ip_config={r: "127.0.0.1" for r in range(size)},
                  base_port=base, reactor=False, force_python_tcp=True)
        agg = FedAvgAggregator(v0, size - 1, cfg.client_num_in_total,
                               size - 1, device="cpu")
        managers = [FedAvgServerManager(agg, cfg.comm_round, 0, size,
                                        "TCP", **kw)]
        try:
            for r in range(1, size):
                managers.append(FedAvgClientManager(
                    trainer, data, cfg.epochs, r, size, "TCP", device="cpu",
                    seed=cfg.seed, **kw))
        except BaseException:
            for m in managers:
                m.finish()
            raise
        return agg, managers

    agg, managers = with_free_ports(size, run)
    server, clients = managers[0], managers[1:]
    policies = []
    try:
        for m in managers:
            if reliable:
                assert m.com_manager.enable_reliability()
            if chaos is not None:
                policies.append(ChaosPolicy(ChaosConfig(**chaos)))
                m.com_manager.install_chaos(policies[-1])
        for m in clients + [server]:
            m.run_async()
        server.send_init_msg()
        assert server.done.wait(timeout=60), "the hardened round hung"
    finally:
        for m in clients + [server]:
            m.finish()
    return agg.variables, policies, [c.rounds_seen for c in clients]


def test_chaos_messaging_round_is_the_clean_round(clean_obs):
    trainer = ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                            lr=0.1)
    data = _data()
    cfg = FedConfig(client_num_in_total=2, client_num_per_round=2,
                    comm_round=2, epochs=1, batch_size=4, lr=0.1,
                    frequency_of_the_test=100)
    v0 = trainer.init(torch.Generator().manual_seed(0), "cpu")
    clean, _, seen = hardened_fedavg(trainer, data, cfg, dict(v0))
    chaos = dict(drop=0.15, dup=0.15, reorder=0.15, delay=0.15, corrupt=0.1,
                 delay_s=0.002, seed=1)
    got, policies, seen_chaos = hardened_fedavg(trainer, data, cfg, dict(v0),
                                                chaos=chaos, reliable=True)
    assert seen == seen_chaos == [cfg.comm_round] * 2   # nobody trained twice
    for k in v0:
        assert torch.equal(got[k], clean[k]), k
    assert any(not torch.equal(got[k], v0[k]) for k in v0)   # it trained
    injected = {}
    for p in policies:
        for k, v in p.summary().items():
            injected[k] = injected.get(k, 0) + v
    assert sum(injected.values()) > 0, injected
    assert obs.counter("comm_recv_thread_deaths_total").value == 0
