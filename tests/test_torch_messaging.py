"""Message-driven FedAvg and remote SplitNN on the port
(fedml_tpu_torch/comm/fedavg_messaging.py, split_messaging.py), on the CPU.

* The messaging round is FedAvg: over INPROC, TCP and the native transport
  it equals the port's FedAvgEngine (3 rounds, ResNet-18-GN at 4 filters on
  8x8 images, GroupNorm's plain version), within rtol 1e-6 (it is bitwise
  here); with bf16 local masters it equals the same clients trained and
  folded by hand, and the uploads are bf16 leaves.
* It matches the JAX package's run_messaging_fedavg from JAX's init (LR
  and the FedAvg CNN) within test_comm.py's rtol 2e-4 / atol 2e-5.
* The straggler watchdog completes rounds, an unfired one changes nothing,
  and a stale upload is dropped (tests/test_straggler.py's three cases).
* Remote SplitNN matches the JAX protocol on test_split_messaging.py's
  _Lower/_Upper pair from JAX's params, over INPROC and TCP.
* secure= and MQTT refuse by name; the entry points default to the card.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fedml_tpu.comm.fedavg_messaging import \
    run_messaging_fedavg as jax_run_messaging
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch import obs
from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.comm import fedavg_messaging as fm
from fedml_tpu_torch.comm.fedavg_messaging import (FedAvgAggregator,
                                                   FedAvgClientManager,
                                                   FedAvgServerManager,
                                                   MyMessage,
                                                   run_messaging_fedavg)
from fedml_tpu_torch.comm.inproc import InProcBackend, InProcRouter
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.split_messaging import (SplitClientCompute,
                                                  SplitNNClientManager,
                                                  SplitNNServerManager,
                                                  SplitServerCompute)
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.ops.aggregate import weighted_mean_flat
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import with_free_ports

torch.set_num_threads(2)
WAIT = 30.0
CLIENTS = 4


def _data(mod, n_clients=CLIENTS, per=8, bs=4, hw=8, ch=3, seed=0):
    """FederatedData of either package from the same numpy arrays."""
    rs = np.random.RandomState(seed)
    n = n_clients * per
    x = rs.rand(n, hw, hw, ch).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    idx = {i: np.arange(i * per, (i + 1) * per) for i in range(n_clients)}
    ev = mod.build_eval_shard(x[:bs], y[:bs], bs)
    return mod.FederatedData(
        train_data_num=n, test_data_num=bs, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, bs),
        client_num_samples=np.full(n_clients, per, np.float32),
        test_client_shards=None, class_num=10, synthetic=True)


def _cfg(cls=FedConfig, n=CLIENTS, rounds=3, bs=4):
    return cls(client_num_in_total=n, client_num_per_round=n,
               comm_round=rounds, epochs=1, batch_size=bs, lr=0.1,
               frequency_of_the_test=100)


def _resnet_trainer():
    return ClientTrainer(create_model("resnet18_gn", 10, num_filters=4),
                         lr=0.1)


def _over(backend, size, run):
    """run(**backend kwargs) over `backend` for `size` ranks on this host,
    on free ports for the socket transports."""
    if backend == "INPROC":
        return run(router=InProcRouter())
    extra = {"force_python_tcp": True} if backend == "TCP" else {}
    return with_free_ports(size, lambda base: run(
        ip_config={r: "127.0.0.1" for r in range(size)}, base_port=base,
        **extra))


# ---------------------------------------------------------------------------
# the messaging round is FedAvg
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_run():
    trainer, data, cfg = _resnet_trainer(), _data(tfed), _cfg()
    engine = FedAvgEngine(trainer, data, cfg, device="cpu")
    v0 = engine.init_variables()
    return trainer, data, cfg, v0, engine.run(variables=dict(v0))


@pytest.mark.parametrize("backend", ["INPROC", "TCP", "NATIVE_TCP"])
def test_messaging_equals_the_engine(engine_run, backend):
    trainer, data, cfg, v0, want = engine_run
    got = _over(backend, CLIENTS + 1, lambda **kw: run_messaging_fedavg(
        trainer, data, cfg, backend=backend, device="cpu",
        variables=dict(v0), timeout=WAIT, **kw))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)


def test_bf16_masters_round_is_the_hand_fold_and_uploads_bf16(monkeypatch):
    """local_dtype=bf16: each client trains a bf16 flat vector from the
    received f32 model and uploads bf16 leaves; the server's fold is the
    weighted mean of those rows."""
    trainer, data, cfg = _resnet_trainer(), _data(tfed), _cfg(rounds=1)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cpu")
    dtypes = set()
    real_add = FedAvgAggregator.add_local_trained_result

    def spy(self, index, variables, sample_num):
        dtypes.update(v.dtype for v in variables.values())
        return real_add(self, index, variables, sample_num)

    monkeypatch.setattr(FedAvgAggregator, "add_local_trained_result", spy)
    got = run_messaging_fedavg(trainer, data, cfg, device="cpu",
                               variables=dict(v0), timeout=WAIT,
                               local_dtype=torch.bfloat16)
    assert dtypes == {torch.bfloat16}
    rows, ns = [], []
    for c in range(CLIENTS):
        flat = trainer.flatten({k: v.to(torch.bfloat16) for k, v in v0.items()})
        shard = {k: torch.as_tensor(v[c]) for k, v in
                 data.client_shards.items()}
        row, _, n = trainer.local_train(
            flat, shard, 1, generator=client_generator(cfg.seed, 0, c, "cpu"))
        rows.append(row)
        ns.append(float(n))
    mean = weighted_mean_flat(torch.stack(rows), torch.tensor(ns))
    want = trainer.unflatten(mean)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k].float()), k


def test_bf16_downlink_halves_the_model_bytes():
    trainer, data, cfg = _resnet_trainer(), _data(tfed), _cfg(rounds=1)
    v0 = trainer.init(torch.Generator().manual_seed(cfg.seed), "cpu")
    sizes = {}
    for transport in (None, "bf16"):
        frames = []

        class Capture(InProcRouter):
            def route(self, msg):
                n = super().route(msg)
                if msg.get_type() == MyMessage.MSG_TYPE_S2C_INIT_CONFIG:
                    frames.append(n)
                return n

        out = run_messaging_fedavg(trainer, data, cfg, device="cpu",
                                   variables=dict(v0), timeout=WAIT,
                                   router=Capture(),
                                   model_transport=transport)
        sizes[transport] = frames
        assert all(torch.isfinite(v).all() for v in out.values())
    n_bytes = 4 * trainer.spec.n
    assert len(sizes[None]) == CLIENTS and len(sizes["bf16"]) == CLIENTS
    assert all(n_bytes < s < n_bytes + 16384 for s in sizes[None])
    assert all(n_bytes // 2 < s < n_bytes // 2 + 16384 for s in sizes["bf16"])


# ---------------------------------------------------------------------------
# against the JAX package's messaging FedAvg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,clients", [("lr", 4), ("cnn", 2)])
def test_messaging_matches_jax_messaging(model, clients):
    jdata = _data(jfed, n_clients=clients, bs=8, hw=28, ch=1, seed=3)
    tdata = _data(tfed, n_clients=clients, bs=8, hw=28, ch=1, seed=3)
    jcfg = _cfg(JaxFedConfig, n=clients, rounds=2, bs=8)
    jtrainer = JaxClientTrainer(jax_create_model(model, 10), lr=0.1)
    want = jax_run_messaging(jtrainer, jdata, jcfg)
    init = jtrainer.init(jax.random.PRNGKey(jcfg.seed),
                         jnp.asarray(jdata.client_shards["x"][0, 0]))
    got = run_messaging_fedavg(
        ClientTrainer(create_model(model, 10), lr=0.1), tdata,
        _cfg(n=clients, rounds=2, bs=8), device="cpu", timeout=WAIT,
        variables=flax_to_torch(jax.tree.map(np.asarray, init)))
    want = flax_to_torch(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

def _lr_setup(n=3):
    return (ClientTrainer(create_model("lr", 10, input_dim=8 * 8 * 3),
                          lr=0.1), _data(tfed, n_clients=n), _cfg(n=n))


def test_straggler_timeout_completes_rounds(monkeypatch):
    trainer, data, cfg = _lr_setup()
    real = FedAvgClientManager._handle_sync

    def slow(self, msg):
        if self.rank == 3:                 # rank 3 is the straggler
            time.sleep(1.2)
        return real(self, msg)

    monkeypatch.setattr(FedAvgClientManager, "_handle_sync", slow)
    t0 = time.time()
    out = run_messaging_fedavg(trainer, data, cfg, device="cpu",
                               worker_num=3, straggler_timeout=0.3,
                               timeout=WAIT)
    assert time.time() - t0 < WAIT
    assert all(torch.isfinite(v).all() for v in out.values())


def test_unfired_straggler_timeout_changes_nothing():
    trainer, data, cfg = _lr_setup()
    a = run_messaging_fedavg(trainer, data, cfg, device="cpu", worker_num=3,
                             timeout=WAIT)
    b = run_messaging_fedavg(trainer, data, cfg, device="cpu", worker_num=3,
                             straggler_timeout=60.0, timeout=WAIT)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_stale_upload_after_timeout_is_dropped():
    """An uplink arriving after the watchdog closed its round takes no
    slot, and the next round's aggregate is bitwise the weighted mean of
    that round's uploads alone."""
    def upload(sender, round_idx, vals, n):
        m = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, sender, 0)
        m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                     {"w": np.asarray(vals, np.float32)})
        m.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, float(n))
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND, round_idx)
        return m

    router = InProcRouter()
    InProcBackend(1, router), InProcBackend(2, router)   # sync mailboxes
    agg = FedAvgAggregator({"w": np.zeros(3, np.float32)}, 2, 2, 2,
                           device="cpu")
    seen, done = {}, threading.Event()

    def on_round(idx, variables):
        seen[idx] = {k: v.clone() for k, v in variables.items()}
        if idx == 1:
            done.set()

    server = FedAvgServerManager(agg, 2, 0, 3, "INPROC", router=router,
                                 straggler_timeout=0.15,
                                 on_round_done=on_round)
    server.register_message_receive_handlers()
    try:
        server._handle_model_from_client(upload(1, 0, [1.0] * 3, 4))
        t0 = time.time()
        while 0 not in seen and time.time() - t0 < 10:
            time.sleep(0.01)
        assert 0 in seen, "straggler timeout never closed round 0"
        assert torch.equal(seen[0]["w"], torch.ones(3))
        assert server.partial_rounds == 1
        server._handle_model_from_client(upload(2, 0, [9.0] * 3, 100))
        assert agg.received_count() == 0, "stale upload took a slot"
        server._handle_model_from_client(upload(1, 1, [2.0] * 3, 1))
        server._handle_model_from_client(upload(2, 1, [4.0] * 3, 3))
        assert done.wait(timeout=10)
        want = weighted_mean_flat(
            torch.tensor([[2.0] * 3, [4.0] * 3]), torch.tensor([1.0, 3.0]))
        assert torch.equal(seen[1]["w"], want)
    finally:
        server.finish()


# ---------------------------------------------------------------------------
# observability on the messaging path
# ---------------------------------------------------------------------------

def test_obs_spans_and_bitwise_on_off(tmp_path):
    trainer, data, cfg = _lr_setup(n=2)
    obs.reset()
    try:
        off = run_messaging_fedavg(trainer, data, cfg, device="cpu",
                                   timeout=WAIT)
        obs.configure(str(tmp_path), install_signal=False,
                      export_at_exit=False)
        on = run_messaging_fedavg(trainer, data, cfg, device="cpu",
                                  timeout=WAIT)
        names = [e["name"] for e in obs.tracer().events()]
        assert names.count("fsm.local_train") == 2 * cfg.comm_round
        assert names.count("fsm.aggregate") == cfg.comm_round
        assert names.count("comm.decode") == 4 * cfg.comm_round
        assert names.count("trace.recv") == 4 * cfg.comm_round
        # metrics are always on: both runs' messages are counted
        assert obs.registry().counter("comm_sent_messages_total",
                                      backend="inproc").value == \
            2 * 4 * cfg.comm_round
    finally:
        obs.reset()
    for k in off:
        assert torch.equal(off[k], on[k]), k


# ---------------------------------------------------------------------------
# remote SplitNN against the JAX protocol
# ---------------------------------------------------------------------------

class _Lower(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(12, 16)

    def forward(self, x):
        return torch.relu(self.Dense_0(x))


class _Upper(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = Dense(16, 3)

    def forward(self, a):
        return self.Dense_0(a)


def _split_shards(seed, n_batches=4, bs=8, dim=12):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(7).randn(dim, 3)
    x = rng.randn(n_batches, bs, dim).astype(np.float32)
    y = np.argmax(x @ w, axis=-1).astype(np.int64)
    return {"x": x, "y": y, "mask": np.ones((n_batches, bs), np.float32)}


def _run_split(managers, wait=WAIT):
    server, clients = managers
    try:
        for m in [server] + clients:
            m.run_async()
        clients[0].start_protocol()
        assert server.done.wait(timeout=wait), "protocol did not finish"
        for c in clients:
            assert c.done.wait(timeout=wait)
    finally:
        for m in clients + [server]:
            m.finish()
    return server, clients


def _jax_split(epochs):
    from tests.test_split_messaging import _build
    from fedml_tpu.comm.inproc import InProcRouter as JRouter
    server, clients = _build(n_clients=2, epochs=epochs, backend="INPROC",
                             router=JRouter())
    init_c = jax.tree.map(np.asarray, clients[0].params)
    init_s = jax.tree.map(np.asarray, server.params)
    return _run_split((server, clients)), init_c, init_s


def _port_split(init_c, init_s, epochs, backend="INPROC"):
    ccomp = SplitClientCompute(_Lower(), lr=0.1, device="cpu")
    scomp = SplitServerCompute(_Upper(), lr=0.1, device="cpu")

    def build(**kw):
        sp, sopt = scomp.init(params=flax_to_torch(init_s))
        made = [SplitNNServerManager(scomp, sp, sopt, max_rank=2,
                                     backend=backend, **kw)]
        try:
            for r in (1, 2):
                cp, copt = ccomp.init(params=flax_to_torch(init_c))
                made.append(SplitNNClientManager(
                    ccomp, cp, copt, _split_shards(seed=r),
                    _split_shards(seed=100 + r), rank=r, max_rank=2,
                    epochs=epochs, backend=backend, **kw))
        except BaseException:
            for m in made:
                m.finish()
            raise
        return made[0], made[1:]

    return _run_split(_over(backend, 3, build))


def test_split_messaging_matches_jax_from_its_params():
    (jserver, jclients), init_c, init_s = _jax_split(epochs=2)
    server, clients = _port_split(init_c, init_s, epochs=2)
    assert len(server.val_history) == 4
    assert [h["active_node"] for h in server.val_history] == [1, 2, 1, 2]
    for h, jh in zip(server.val_history, jserver.val_history):
        assert h["val_acc"] == jh["val_acc"]
        np.testing.assert_allclose(h["val_loss"], jh["val_loss"], rtol=1e-5)
    pairs = [(server.params, jserver.params)] + [
        (c.params, jc.params) for c, jc in zip(clients, jclients)]
    for port, jax_params in pairs:
        want = flax_to_torch(jax.tree.map(np.asarray, jax_params))
        for k in want:
            np.testing.assert_allclose(port[k].numpy(), want[k].numpy(),
                                       rtol=2e-4, atol=2e-5)


def test_split_messaging_over_tcp_equals_inproc():
    (_, _), init_c, init_s = _jax_split(epochs=1)
    a_server, a_clients = _port_split(init_c, init_s, 1, "INPROC")
    b_server, b_clients = _port_split(init_c, init_s, 1, "TCP")
    assert len(b_server.val_history) == 2
    for a, b in [(a_server.params, b_server.params)] + [
            (x.params, y.params) for x, y in zip(a_clients, b_clients)]:
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# refusals and the default device
# ---------------------------------------------------------------------------

def test_secure_and_mqtt_refuse_by_name():
    trainer, data, cfg = _lr_setup(n=2)
    with pytest.raises(NotImplementedError, match="slice 4"):
        run_messaging_fedavg(trainer, data, cfg, device="cpu",
                             secure=object())
    with pytest.raises(NotImplementedError, match="slice 4"):
        FedAvgAggregator({"w": np.zeros(2)}, 2, 2, 2, secure=object(),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="slice 4"):
        FedAvgClientManager(trainer, data, 1, 1, 2, secure=object(),
                            device="cpu", router=InProcRouter())
    with pytest.raises(NotImplementedError, match="slice 5b-ii"):
        run_messaging_fedavg(trainer, data, cfg, backend="MQTT",
                             device="cpu")
    assert "secagg" not in " ".join(
        n for n in dir(fm) if not n.startswith("_")).lower()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trainer, data, cfg = _lr_setup(n=2)
    for make in (lambda: run_messaging_fedavg(trainer, data, cfg),
                 lambda: FedAvgAggregator({"w": np.zeros(2)}, 2, 2, 2),
                 lambda: SplitClientCompute(_Lower()),
                 lambda: SplitServerCompute(_Upper())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
