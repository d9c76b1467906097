"""The ingest and connection tortures and secure messaging FedAvg of the
PyTorch port, against the JAX package.

* run_ingest_torture over INPROC, TCP and gRPC (ports above the
  ephemeral range), the streaming decode-into pool arm and the legacy arm (inline
  decode, drained commit), reliable clients under seeded chaos, and the
  defended arm (every arrival screened): commits to the budget, finite
  model, every committed update folded once; its report's keys are the
  JAX package's (the JAX torture run over INPROC at the same size).
* run_connection_torture with 16 live connections on the reactor: FD
  delta 0, no receive-thread death, the JAX report's keys.
* run_messaging_fedavg(secure=...): the masked uplink frame is byte for
  byte the JAX client's for the same trained variables (LR and a CNN:
  the row is the JAX leaf order and layouts, conv kernels HWIO); two
  rounds within rtol 2e-4 / atol 2e-5 of the JAX package's secure round
  (the field sum dequantizes exactly; training in another framework);
  one round within the quantizer's bound (K * 2^-16 of scale) of the
  plain round; too few survivors raise SecAggBelowThreshold by name and
  keep the round open; a quantizer refusal drops and counts the uplink.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.async_.torture import run_connection_torture as \
    jax_connection_torture
from fedml_tpu.async_.torture import run_ingest_torture as jax_ingest
from fedml_tpu.comm import fedavg_messaging as jfm
from fedml_tpu.comm.inproc import InProcRouter as JaxRouter
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.comm.message import MessageCodec as JaxCodec
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.secure.secagg import SecAggConfig as JaxSecAggConfig
from fedml_tpu.secure.secagg import SecureAggregator as JaxSecureAggregator
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch import obs
from fedml_tpu_torch.async_ import (DefenseConfig, run_connection_torture,
                                    run_ingest_torture)
from fedml_tpu_torch.async_.torture import make_template
from fedml_tpu_torch.comm.fedavg_messaging import (FedAvgAggregator,
                                                   FedAvgClientManager,
                                                   MyMessage,
                                                   run_messaging_fedavg,
                                                   secure_row)
from fedml_tpu_torch.comm.inproc import InProcRouter
from fedml_tpu_torch.comm.message import Message, MessageCodec
from fedml_tpu_torch.convert import flax_to_torch
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.secure import (SecAggBelowThreshold, SecAggConfig,
                                    SecureAggregator)
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_transports import with_free_ports

WAIT = 60.0


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the ingest torture
# ---------------------------------------------------------------------------

SMALL = dict(n_clients=4, p=2048, buffer_k=4, commits=3, warmup_commits=1,
             timeout_s=WAIT)


def _check(r, commits=3, k=4):
    assert r["finite"] and r["recv_thread_deaths"] == 0
    assert r["updates_committed"] == commits * k
    assert r["committed_updates_per_sec"] > 0
    assert r["decode_p95_s"] >= r["decode_p50_s"] >= 0.0


ARMS = {
    "streaming_pool": dict(ingest_pool=2, decode_into=True, streaming=True),
    "legacy": dict(ingest_pool=0, decode_into=False, streaming=False),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("backend", ["INPROC", "TCP", "GRPC"])
def test_ingest_torture_commits_every_update(backend, arm):
    if backend != "INPROC":
        r = with_free_ports(1, lambda base: run_ingest_torture(
            backend=backend, base_port=base, device="cpu", **SMALL,
            **ARMS[arm]))
    else:
        r = run_ingest_torture(backend="INPROC", device="cpu", **SMALL,
                               **ARMS[arm])
    _check(r)
    assert r["backend"] == backend
    if backend == "INPROC":      # a socket client may see the server close
        assert r["clients_alive_at_end"] == 4
    assert r["streaming"] == ARMS[arm]["streaming"]


def test_ingest_torture_reliable_under_chaos():
    r = with_free_ports(1, lambda base: run_ingest_torture(
        backend="TCP", base_port=base, device="cpu", reliable=True,
        chaos={"drop": 0.10, "dup": 0.05, "corrupt": 0.05}, chaos_seed=3,
        ingest_pool=2, **SMALL))
    _check(r)
    assert sum(r["chaos_injected"].values()) >= 1
    assert r["acks"] > 0


def test_ingest_torture_defended_arm_screens_every_arrival():
    r = run_ingest_torture(backend="INPROC", device="cpu",
                           defense=DefenseConfig(norm_bound=1e6),
                           ingest_pool=2, **SMALL)
    _check(r)
    assert r["defense"] and r["admission"]["quarantined_total"] == 0
    # every committed update was screened (uplinks racing the last commit
    # are screened too)
    assert r["admission"]["accepted"] >= 12


def test_ingest_report_keys_are_jax():
    want = jax_ingest(backend="INPROC", ingest_pool=2, **SMALL)
    got = run_ingest_torture(backend="INPROC", ingest_pool=2, device="cpu",
                             **SMALL)
    assert sorted(got) == sorted(want)
    assert got["p"] == want["p"] == 2048
    assert sorted(got["slo_arm"]) == sorted(want["slo_arm"])
    assert sum(t.numel() for t in make_template(2048).values()) == 2048


def test_connection_torture_sixteen_live_connections():
    kw = dict(n_connections=16, p=256, buffer_k=8, commits=3,
              warmup_commits=1, ingest_pool=2, offered_rate=400.0,
              timeout_s=WAIT)
    r = with_free_ports(1, lambda base: run_connection_torture(
        base_port=base, device="cpu", **kw))
    assert r["finite"] and r["recv_thread_deaths"] == 0
    assert r["fd_leaked"] == 0
    assert r["updates_committed"] >= 3 * 8
    assert r["open_connections_peak"] <= 16
    assert r["admission_p95_s"] >= r["admission_p50_s"] >= 0.0
    want = with_free_ports(1, lambda base: jax_connection_torture(
        base_port=base, **kw))
    assert sorted(r) == sorted(want)


# ---------------------------------------------------------------------------
# secure messaging FedAvg
# ---------------------------------------------------------------------------

def _data(mod, n_clients, per=8, bs=8, hw=28, ch=1, seed=3):
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


def _cfg(cls, n, rounds=2):
    return cls(client_num_in_total=n, client_num_per_round=n,
               comm_round=rounds, epochs=1, batch_size=8, lr=0.1,
               frequency_of_the_test=100)


def _jax_setup(model, n):
    jdata = _data(jfed, n)
    jt = JaxClientTrainer(jax_create_model(model, 10), lr=0.1)
    init = jt.init(jax.random.PRNGKey(0),
                   jnp.asarray(jdata.client_shards["x"][0, 0]))
    return jt, jdata, jax.tree.map(np.asarray, init)


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_masked_uplink_frame_is_jax_byte_for_byte(model):
    """Both clients handle the same sync message with local training
    replaced by the same trained variables; the encoded uplinks match."""
    n, rank, rnd = 3, 2, 1
    jt, jdata, init = _jax_setup(model, n)
    trained = jax.tree.map(lambda a: (a * 0.9 + 0.01).astype(np.float32),
                           init)
    port_trained = flax_to_torch(trained)
    dim = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(init))
    np.testing.assert_array_equal(
        secure_row(port_trained),
        np.concatenate([a.reshape(-1) for a in jax.tree.leaves(trained)]
                       ).astype(np.float64))

    jsec = JaxSecureAggregator(JaxSecAggConfig(seed=7), range(1, n + 1), dim)
    jclient = jfm.FedAvgClientManager(jt, jdata, 1, rank, n + 1, "INPROC",
                                      secure=jsec, router=JaxRouter())
    jclient._local_train = lambda v, shard, rng: (
        trained, jnp.float32(0.5), jnp.float32(8.0))
    sent = []
    jclient.send_message = sent.append
    sync = JaxMessage(jfm.MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0,
                      rank)
    sync.add_params(jfm.MyMessage.MSG_ARG_KEY_MODEL_PARAMS, init)
    sync.add_params(jfm.MyMessage.MSG_ARG_KEY_CLIENT_INDEX, 1)
    sync.add_params(jfm.MyMessage.MSG_ARG_KEY_ROUND, rnd)
    jclient._handle_sync(sync)
    jclient.finish()

    tsec = SecureAggregator(SecAggConfig(seed=7), range(1, n + 1), dim,
                            device="cpu")
    trainer = ClientTrainer(create_model(model, 10), lr=0.1)
    tclient = FedAvgClientManager(trainer, _data(tfed, n), 1, rank, n + 1,
                                  secure=tsec, device="cpu",
                                  router=InProcRouter())
    row = tclient.trainer.flatten(port_trained)
    tclient.trainer.local_train = lambda *a, **k: (
        row, torch.tensor(0.5), torch.tensor(8.0))
    tsent = []
    tclient.send_message = tsent.append
    tsync = Message(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, rank)
    tsync.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                     flax_to_torch(init))
    tsync.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, 1)
    tsync.add_params(MyMessage.MSG_ARG_KEY_ROUND, rnd)
    tclient._handle_sync(tsync)
    tclient.finish()
    assert len(sent) == len(tsent) == 1
    assert MessageCodec.encode(tsent[0]) == JaxCodec.encode(sent[0])


def test_secure_round_matches_jax_and_the_plain_round():
    n = 2
    jt, jdata, init = _jax_setup("cnn", n)
    want = jfm.run_messaging_fedavg(jt, jdata, _cfg(JaxFedConfig, n),
                                    secure=JaxSecAggConfig(seed=3))
    v0 = flax_to_torch(init)
    kw = dict(device="cpu", timeout=WAIT, variables=dict(v0))
    trainer = ClientTrainer(create_model("cnn", 10), lr=0.1)
    got = run_messaging_fedavg(trainer, _data(tfed, n), _cfg(FedConfig, n),
                               secure=SecAggConfig(seed=3), **kw)
    want = flax_to_torch(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    # one round against the plain one: the fixed-point bound K * 2^-16
    sec1 = run_messaging_fedavg(trainer, _data(tfed, n),
                                _cfg(FedConfig, n, rounds=1),
                                secure=SecAggConfig(seed=3), **kw)
    plain1 = run_messaging_fedavg(trainer, _data(tfed, n),
                                  _cfg(FedConfig, n, rounds=1), **kw)
    for k in plain1:
        assert (sec1[k] - plain1[k]).abs().max() <= n * 2.0 ** -16, k


def test_secure_barrier_below_threshold_and_refused_uplinks():
    tmpl = {"w": torch.zeros(4)}
    sec = SecureAggregator(SecAggConfig(seed=1, threshold=3), range(1, 4),
                           4, device="cpu")
    agg = FedAvgAggregator(tmpl, 3, 3, 3, secure=sec, device="cpu")
    row = sec.client_row(1, 0, np.ones(4), 2.0)
    assert not agg.add_local_trained_result(0, torch.from_numpy(row), 1.0)
    with pytest.raises(SecAggBelowThreshold, match="threshold"):
        agg.aggregate(0)
    assert agg.received_count() == 1           # the round stays open
    # a row the field cannot hold is refused at the client and counted
    trainer = ClientTrainer(create_model("lr", 10, input_dim=4), lr=0.1)
    client = FedAvgClientManager(trainer, _data(tfed, 3), 1, 1, 4,
                                 secure=sec, device="cpu",
                                 router=InProcRouter())
    c0 = obs.counter("secagg_rejected_uplinks_total").value
    huge = {k: torch.full_like(v, 1e9)
            for k, v in trainer.init(torch.Generator().manual_seed(0),
                                     "cpu").items()}
    sec_big = SecureAggregator(SecAggConfig(seed=1), range(1, 4),
                               sum(v.numel() for v in huge.values()),
                               device="cpu")
    client.secure = sec_big
    assert client.uplink(huge, 8.0, 0.1, 0) is None
    assert client.secagg_rejected == 1
    assert obs.counter("secagg_rejected_uplinks_total").value == c0 + 1
    client.finish()
