"""FedGKT in the PyTorch port against the JAX package: the temperature KL
loss and its zero-logit switch, the GroupNorm ResNet pair for GKT, and one
round of the engine (the clients' local phases, the server's distillation
epoch over the uploaded features, and the server logits it returns).

Sizes: ResNetClientGKT(n_blocks=1) and ResNetServerGKT(n_per_stage=1) on
8x8x3 images, 3 clients of 8, 5 and 3 samples in batches of 4 (so one
client has an all-padding batch, frozen in both phases).  Weights come
from the JAX engine's init through ``convert.flax_to_torch``.
Tolerances: f32 leaves and logits within atol 1e-4 / rtol 1e-3 (as
tests/test_torch_fedavg.py), losses within rel 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedgkt import FedGKTEngine as JaxFedGKT
from fedml_tpu.algorithms.fedgkt import kl_divergence_loss as jax_kl
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import resnet_gkt as jgkt
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fedgkt import FedGKTEngine, kl_divergence_loss
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.trainer import masked_cross_entropy
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models.resnet_gkt import ResNetClientGKT, ResNetServerGKT
from fedml_tpu_torch.utils.config import FedConfig

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-4)
HW, BS, SIZES, CLASSES = 8, 4, (8, 5, 3), 10


def _data(mod):
    rs = np.random.RandomState(0)
    n = sum(SIZES)
    x = rs.rand(n, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, CLASSES, n).astype(np.int64)
    ends = np.cumsum(SIZES)
    idx = {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(SIZES, ends))}
    ev = mod.build_eval_shard(x[:6], y[:6], BS)
    return mod.FederatedData(
        train_data_num=n, test_data_num=6, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, BS),
        client_num_samples=np.asarray(SIZES, np.float32),
        test_client_shards=None, class_num=CLASSES)


def _cfg(cls):
    return cls(client_num_in_total=3, client_num_per_round=3, comm_round=1,
               epochs=1, batch_size=BS, lr=0.05, frequency_of_the_test=100)


def _flax(state):
    return torch_to_flax(state)["params"]


def _close(got, want, **tol):
    tol = tol or TOL
    want = dict(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                 want)))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_allclose(got[path], a,
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [1.0, 3.0])
@pytest.mark.parametrize("mask", ["all", "some", "none"])
def test_kl_divergence_matches_jax(temperature, mask):
    rs = np.random.RandomState(1)
    s = rs.standard_normal((6, CLASSES)).astype(np.float32) * 3
    t = rs.standard_normal((6, CLASSES)).astype(np.float32) * 3
    t[0] = [40.0] + [-40.0] * (CLASSES - 1)      # saturated: clip(t, 1e-8)
    m = {"all": np.ones(6), "some": np.array([1, 0, 1, 1, 0, 1]),
         "none": np.zeros(6)}[mask].astype(np.float32)
    want = float(jax_kl(jnp.asarray(s), jnp.asarray(t), jnp.asarray(m),
                        temperature))
    got = float(kl_divergence_loss(torch.tensor(s), torch.tensor(t),
                                   torch.tensor(m), temperature))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-7)
    assert got >= -1e-6
    assert float(kl_divergence_loss(torch.tensor(s), torch.tensor(s),
                                    torch.tensor(m), temperature)) < 1e-5


@pytest.fixture(scope="module")
def gkt():
    jeng = JaxFedGKT(jgkt.ResNetClientGKT(num_classes=CLASSES, n_blocks=1),
                     jgkt.ResNetServerGKT(num_classes=CLASSES, n_per_stage=1),
                     _data(jfed), _cfg(JaxFedConfig))
    eng = FedGKTEngine(ResNetClientGKT(CLASSES, n_blocks=1),
                       ResNetServerGKT(CLASSES, n_per_stage=1), _data(tfed),
                       _cfg(FedConfig), device="cpu")
    cp0, sp0 = jax.tree.map(np.asarray, jeng.init_params())
    return jeng, eng, cp0, sp0


def test_client_kl_term_switches_on_with_any_nonzero_server_logit(gkt):
    """Round 0's server logits are zeros: the client loss is pure CE; one
    nonzero logit anywhere in the batch turns the KL term on."""
    _, eng, cp0, _ = gkt
    p = eng.client.flatten(flax_to_torch(cp0))
    shard = {k: torch.tensor(v[0, 0]) for k, v in eng.data.client_shards.items()}
    _, logits = eng.client(p, shard["x"])
    ce = masked_cross_entropy(logits, shard["y"], shard["mask"])
    zeros = torch.zeros(BS, CLASSES)
    assert torch.equal(eng._client_loss(p, shard, zeros), ce)
    one = zeros.clone()
    one[2, 3] = 0.5
    kl = kl_divergence_loss(logits, one, shard["mask"], eng.temperature)
    assert float(kl) > 0
    assert float(eng._client_loss(p, shard, one)) == pytest.approx(
        float(ce + kl), rel=1e-6)


def test_gkt_pair_matches_flax(gkt):
    jeng, eng, cp0, sp0 = gkt
    x = np.asarray(jeng.data.client_shards["x"][0, 0])
    feats, logits = jeng.client_model.apply({"params": cp0}, x)
    want_s = jeng.server_model.apply({"params": sp0}, feats)
    cp, sp = eng.client.flatten(flax_to_torch(cp0)), eng.server.flatten(
        flax_to_torch(sp0))
    f, lg = eng.client(cp, torch.tensor(x))
    assert f.shape == (BS, HW, HW, 16) and f.is_contiguous()
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(feats),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(eng.server(sp, f).detach().numpy(),
                               np.asarray(want_s), rtol=1e-4, atol=1e-5)


def test_full_width_pair_sizes():
    assert sum(p.numel() for p in ResNetClientGKT().parameters()) == 14_650
    assert sum(p.numel() for p in ResNetServerGKT().parameters()) == 563_658


@pytest.mark.parametrize("server_logits", ["zeros", "random"])
def test_gkt_round_matches_jax(gkt, server_logits):
    """One round: every client's local phase (CE, plus KL once the server
    logits are nonzero), the uploads, the server's distillation epoch and
    the server logits it returns, against the JAX engine's jitted
    phases."""
    jeng, eng, cp0, sp0 = gkt
    C, B = len(SIZES), eng.data.client_shards["mask"].shape[1]
    slog0 = np.zeros((C, B, BS, CLASSES), np.float32)
    if server_logits == "random":
        slog0 = np.random.RandomState(2).standard_normal(slog0.shape).astype(
            np.float32)
    shards, _ = jeng.data.device_shards()
    cp_stack = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (C,) + a.shape),
                            cp0)
    j_cp, j_feats, j_logits, j_losses = jeng._client_phase_v(
        cp_stack, shards, jnp.asarray(slog0))
    j_opt = jeng.server_tx.init(jax.tree.map(jnp.asarray, sp0))
    j_sp, _, j_slog, j_sloss = jeng._server_phase_j(
        jax.tree.map(jnp.asarray, sp0), j_opt, j_feats, j_logits, shards["y"],
        shards["mask"])

    tshards, _ = eng.data.device_shards("cpu")
    sp = eng.server.flatten(flax_to_torch(sp0))
    flats, t_sp, _, t_slog, t_losses, t_sloss = eng.train_round(
        [eng.client.flatten(flax_to_torch(cp0))] * C, sp,
        eng.server_tx.init(sp), torch.tensor(slog0), tshards)
    for c in range(C):
        _close(_flax(eng.client.unflatten(flats[c])),
               jax.tree.map(lambda a, c=c: a[c], j_cp))
    np.testing.assert_allclose(t_losses.numpy(), np.asarray(j_losses),
                               rtol=1e-4)
    _close(_flax(eng.server.unflatten(t_sp)), j_sp)
    assert float(t_sloss) == pytest.approx(float(j_sloss), rel=1e-4)
    assert t_slog.shape == (C, B, BS, CLASSES)
    np.testing.assert_allclose(t_slog.numpy(), np.asarray(j_slog), **TOL)


def test_gkt_run_matches_jax(gkt):
    """The public loop: one round then the evaluation, from the same init."""
    jeng, eng, cp0, sp0 = gkt
    j_cps, j_sp = jeng.run(rounds=1)
    cps, sp = eng.run(rounds=1, params=flax_to_torch((cp0, sp0)))
    assert len(cps) == len(j_cps) == len(SIZES)
    _close(_flax(sp), j_sp)
    _close(_flax(cps[1]), j_cps[1])
    got, want = eng.metrics_history[-1], jeng.metrics_history[-1]
    for k in ("client_loss", "server_loss"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert got["test_acc"] == want["test_acc"]
