"""The one-card algorithms of slice 7a-i in the PyTorch port against the
JAX package: TurboAggregate, hierarchical FedAvg, the centralized
trainer, DSGD and push-sum gossip, vertical FL, SplitNN with its split
models, and FedGAN with its GAN pair; and the converter on the nested
params and the pairs these engines carry.

Each engine runs one round (or epoch) from the same weights, the JAX
engine's init carried across by ``convert.flax_to_torch``, on the same
data (built bitwise equal by both packages' loaders).  Tolerances: f32
leaves within atol 1e-4 / rtol 1e-3 (as tests/test_torch_fedavg.py),
losses within rel 1e-4.  FedGAN's z comes from ``jax.random`` in JAX and
from a torch generator here, so its parity holds on the batch steps given
JAX's z, and on z's shape and moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.centralized import (
    CentralizedTrainer as JaxCentralized)
from fedml_tpu.algorithms.decentralized import (
    DecentralizedGossipEngine as JaxGossip)
from fedml_tpu.algorithms.fedgan import FedGANEngine as JaxFedGAN
from fedml_tpu.algorithms.hierarchical import (
    HierarchicalFedAvgEngine as JaxHierarchical)
from fedml_tpu.algorithms.split_nn import SplitNNEngine as JaxSplitNN
from fedml_tpu.algorithms.turboaggregate import (
    TurboAggregateEngine as JaxTurbo)
from fedml_tpu.algorithms.vertical_fl import VFLEngine as JaxVFL
from fedml_tpu.core.topology import (
    AsymmetricTopologyManager as JaxAsymmetric,
    SymmetricTopologyManager as JaxSymmetric)
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import load_data as jax_load_data
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models import gan as jgan
from fedml_tpu.models import split as jsplit
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms import (DecentralizedGossipEngine,
                                        HierarchicalFedAvgEngine)
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.decentralized import debias, rebias
from fedml_tpu_torch.algorithms.fedgan import FedGANEngine
from fedml_tpu_torch.algorithms.fedgkt import FedGKTEngine
from fedml_tpu_torch.algorithms.fedseg import FedSegEngine
from fedml_tpu_torch.algorithms.split_nn import SplitNNEngine
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateEngine
from fedml_tpu_torch.algorithms.vertical_fl import VFLEngine
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                           SymmetricTopologyManager)
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import load_data
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.gan import Discriminator, Generator
from fedml_tpu_torch.models.resnet_gkt import ResNetClientGKT, ResNetServerGKT
from fedml_tpu_torch.models.split import split_cnn, split_mlp
from fedml_tpu_torch.utils.config import FedConfig

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, **tol):
    """The port's {name: tensor} against a flax tree (variables with their
    collections, or a params dict), leaf by leaf by path."""
    tol = tol or TOL
    got = torch_to_flax(got)
    if "params" not in want:
        got = got["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(_np(want)))
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_allclose(got[path], a, err_msg=jax.tree_util.keystr(path),
                                   **tol)


def _mnist(cls_load, clients=4, batches=2, bs=8):
    return cls_load("mnist", client_num_in_total=clients, batch_size=bs,
                    synthetic_scale=0.005, max_batches_per_client=batches,
                    seed=0)


def _cfg(cls, **kw):
    base = dict(client_num_in_total=4, client_num_per_round=4, comm_round=1,
                epochs=1, batch_size=8, lr=0.1, frequency_of_the_test=100)
    return cls(**{**base, **kw})


# ---------------------------------------------------------------------------
# TurboAggregate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def turbo():
    jdata = _mnist(jax_load_data)
    jeng = JaxTurbo(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                    jdata, _cfg(JaxFedConfig, client_num_per_round=3))
    v0 = _np(jeng.init_variables())
    want = jeng.run(variables=jax.tree.map(jnp.asarray, v0), rounds=1)
    eng = TurboAggregateEngine(ClientTrainer(create_model("lr", 10), lr=0.1),
                               _mnist(load_data),
                               _cfg(FedConfig, client_num_per_round=3),
                               device="cpu")
    return eng, v0, want, jeng.metrics_history[-1]


def test_turboaggregate_round_matches_jax(turbo):
    eng, v0, want, want_m = turbo
    got = eng.run(variables=flax_to_torch(v0), rounds=1)
    _assert_trees_close(got, want)
    m = eng.metrics_history[-1]
    assert m["test_loss"] == pytest.approx(want_m["test_loss"], rel=1e-4)


def test_turboaggregate_secure_mean_is_the_plain_mean_to_the_grid(turbo):
    """The masks cancel exactly: the secure mean differs from the plain
    weighted mean (the fold's finalize form) only by the fixed-point
    rounding of K contributions, at most K * 2^-16."""
    eng, v0, _, _ = turbo
    rows, ns = eng.train_cohort(flax_to_torch(v0), 0)
    secure, plain = eng.secure_mean(rows, ns, 0), eng.plain_mean(rows, ns)
    K = len(rows)
    for k in plain:
        err = float((secure[k] - plain[k]).abs().max())
        assert err <= K * 2.0 ** -16, (k, err)
    # the share seeds differ per round; the sum does not
    other = eng.secure_mean(rows, ns, 5)
    for k in plain:
        assert torch.equal(other[k], secure[k])


# ---------------------------------------------------------------------------
# hierarchical FedAvg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group_num,inner", [(2, 1), (2, 2), (4, 1)])
def test_hierarchical_round_matches_jax(group_num, inner):
    jeng = JaxHierarchical(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                           _mnist(jax_load_data), _cfg(JaxFedConfig),
                           group_num=group_num, group_comm_round=inner,
                           donate=False)
    v0 = _np(jeng.init_variables())
    want = jeng.run(variables=jax.tree.map(jnp.asarray, v0), rounds=1)
    eng = HierarchicalFedAvgEngine(
        ClientTrainer(create_model("lr", 10), lr=0.1), _mnist(load_data),
        _cfg(FedConfig), group_num=group_num, group_comm_round=inner,
        device="cpu")
    got = eng.run(variables=flax_to_torch(v0), rounds=1)
    _assert_trees_close(got, want)
    g, w = eng.metrics_history[-1], jeng.metrics_history[-1]
    for k in ("train_loss", "test_loss"):
        assert g[k] == pytest.approx(w[k], rel=1e-4), k


def test_hierarchical_result_does_not_depend_on_grouping():
    """The reference's CI oracle: full participation, one full batch per
    client, E=1, one inner round: every grouping gives the global mean of
    the clients' single GD steps."""
    data = _mnist(load_data, batches=1, bs=64)
    cfg = _cfg(FedConfig, batch_size=64)
    trainer = ClientTrainer(create_model("lr", 10), lr=0.1)
    v0 = trainer.init(torch.Generator().manual_seed(0), "cpu")
    out = [HierarchicalFedAvgEngine(trainer, data, cfg, group_num=g,
                                    device="cpu").run(variables=dict(v0),
                                                      rounds=2)
           for g in (1, 2, 4)]
    for other in out[1:]:
        for k in out[0]:
            np.testing.assert_allclose(other[k].numpy(), out[0][k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_hierarchical_refuses_an_uneven_split():
    eng = HierarchicalFedAvgEngine(ClientTrainer(create_model("lr", 10)),
                                   _mnist(load_data), _cfg(FedConfig),
                                   group_num=3, device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        eng.run(rounds=1)


# ---------------------------------------------------------------------------
# centralized
# ---------------------------------------------------------------------------

def test_centralized_epoch_matches_jax():
    jtr = JaxCentralized(JaxClientTrainer(jax_create_model("lr", 10), lr=0.1),
                         _mnist(jax_load_data), _cfg(JaxFedConfig))
    v0 = _np(jtr.trainer.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 784), jnp.float32)))
    want = jtr.run(epochs=2, variables=jax.tree.map(jnp.asarray, v0))
    tr = CentralizedTrainer(ClientTrainer(create_model("lr", 10), lr=0.1),
                            _mnist(load_data), _cfg(FedConfig), device="cpu")
    got = tr.run(epochs=2, variables=flax_to_torch(v0))
    _assert_trees_close(got, want)
    for g, w in zip(tr.metrics_history, jtr.metrics_history):
        assert g["epoch"] == w["epoch"]
        for k in ("train_loss", "test_loss", "train_acc"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), k
    assert tr._shard("train") is tr._shard("train")       # uploaded once


def test_centralized_mesh_is_slice_6():
    with pytest.raises(NotImplementedError, match="slice 6"):
        CentralizedTrainer(ClientTrainer(create_model("lr", 10)),
                           _mnist(load_data), _cfg(FedConfig), mesh=object(),
                           device="cpu")


# ---------------------------------------------------------------------------
# decentralized: DSGD and push-sum
# ---------------------------------------------------------------------------

def _susy(loader):
    return loader("susy", client_num_in_total=8, batch_size=8,
                  synthetic_scale=0.01, seed=0)


def _gossip_pair(push_sum: bool):
    topo = ((JaxAsymmetric(8, neighbor_num=3, deleted_ratio=0.3),
             AsymmetricTopologyManager(8, neighbor_num=3, deleted_ratio=0.3))
            if push_sum else (JaxSymmetric(8, neighbor_num=2),
                              SymmetricTopologyManager(8, neighbor_num=2)))
    cfg = dict(client_num_in_total=8, client_num_per_round=8)
    jeng = JaxGossip(JaxClientTrainer(jax_create_model("lr", 2, input_dim=18),
                                      lr=0.1),
                     _susy(jax_load_data), _cfg(JaxFedConfig, **cfg),
                     topology=topo[0], push_sum=push_sum)
    eng = DecentralizedGossipEngine(
        ClientTrainer(create_model("lr", 2, input_dim=18), lr=0.1),
        _susy(load_data), _cfg(FedConfig, **cfg), topology=topo[1],
        push_sum=push_sum, device="cpu")
    return jeng, eng


def _rows(eng, stacked):
    """A JAX [C, ...] stacked pytree -> the port's [C, P] rows."""
    C = jax.tree.leaves(stacked)[0].shape[0]
    return torch.stack([eng.trainer.flatten(flax_to_torch(
        jax.tree.map(lambda a, c=c: np.asarray(a[c]), stacked)))
        for c in range(C)])


@pytest.mark.parametrize("push_sum", [False, True])
def test_gossip_round_matches_jax(push_sum):
    """One round from JAX's states, with push-sum weights away from 1 so
    the de-bias and re-bias matter."""
    jeng, eng = _gossip_pair(push_sum)
    stacked, w = jeng.init_states()
    if push_sum:
        w = jnp.asarray(np.random.RandomState(1).uniform(0.5, 1.5, 8),
                        jnp.float32)
    np.testing.assert_array_equal(eng.W.numpy(), np.asarray(jeng.W))
    cohort, _ = jeng.data.device_shards()
    want_s, want_w, want_m = jeng.round_fn(
        jax.tree.map(jnp.copy, stacked), w, cohort, jax.random.PRNGKey(1))
    rows = _rows(eng, stacked)
    tw = torch.tensor(np.asarray(w))
    got_s, got_w, got_m = eng.round_fn(rows, tw, eng.data.device_shards("cpu")[0])
    np.testing.assert_allclose(got_s.numpy(), _rows(eng, want_s).numpy(), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6)
    assert float(got_m["train_loss"]) == pytest.approx(
        float(want_m["train_loss"]), rel=1e-4)
    want_e, got_e = jeng.evaluate(want_s, want_w), eng.evaluate(got_s, got_w)
    assert got_e["test_loss"] == pytest.approx(want_e["test_loss"], rel=1e-4)


def test_push_sum_debias_and_rebias_match_jax():
    rs = np.random.RandomState(2)
    x = rs.standard_normal((5, 7)).astype(np.float32)
    w = rs.uniform(0.3, 2.0, 5).astype(np.float32)
    jw = jnp.asarray(w)
    want_d = np.asarray(jnp.asarray(x) / jw.reshape((-1, 1)))
    want_r = np.asarray(jnp.asarray(x) * jw.reshape((-1, 1)))
    got_d = debias(torch.tensor(x), torch.tensor(w)).numpy()
    got_r = rebias(torch.tensor(x), torch.tensor(w)).numpy()
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_allclose(rebias(debias(torch.tensor(x), torch.tensor(w)),
                                      torch.tensor(w)).numpy(), x, rtol=1e-6)


@pytest.mark.parametrize("push_sum", [False, True])
def test_gossip_learns_and_mixing_shrinks_spread(push_sum):
    """tests/test_decentralized.py's oracles on the port: the consensus
    learns the SUSY stream, push-sum mass stays positive, and mixing
    alone shrinks the clients' disagreement."""
    _, eng = _gossip_pair(push_sum)
    eng.cfg.comm_round = 15
    eng.cfg.frequency_of_the_test = 5
    stacked, weights = eng.run()
    assert eng.metrics_history[-1]["test_acc"] > (0.7 if push_sum else 0.75)
    assert bool((weights > 0).all()) and set(stacked) == set(
        eng.trainer.spec.names)
    rows, w = eng.init_states()
    rows = rows + torch.randn(rows.shape, generator=torch.Generator()
                              .manual_seed(0))
    spread = lambda s: float(s.std(dim=0).mean())
    s0 = spread(rows)
    for _ in range(5):
        rows, w = eng._mix(rows, w)
    assert spread(rows) < s0 * 0.5


# ---------------------------------------------------------------------------
# vertical FL
# ---------------------------------------------------------------------------

def _vfl_task(n=512, d1=6, d2=4):
    rs = np.random.RandomState(0)
    x = rs.randn(n, d1 + d2).astype(np.float32)
    w = rs.randn(d1 + d2).astype(np.float32)
    return x, (x @ w > 0).astype(np.int64), [d1, d2]


def test_vfl_epoch_matches_jax():
    x, y, splits = _vfl_task()
    kw = dict(batch_size=64, lr=0.1, comm_round=2, client_optimizer="adam")
    jeng = JaxVFL(splits, JaxFedConfig(**kw))
    p0 = _np(jeng.init_params())
    want = jeng.fit(x, y)
    eng = VFLEngine(splits, FedConfig(**kw), device="cpu")
    got = eng.fit(x, y, params=flax_to_torch(p0))
    assert set(got) == {"party_0.kernel", "party_0.bias", "party_1.kernel",
                        "party_1.bias", "guest_head.kernel", "guest_head.bias"}
    _assert_trees_close(got, want)
    for g, w in zip(eng.metrics_history, jeng.metrics_history):
        assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
    assert eng.score(got, x, y) == jeng.score(want, x, y)


def test_vfl_two_party_learns_and_inits_like_jax():
    x, y, splits = _vfl_task()
    eng = VFLEngine(splits, FedConfig(batch_size=64, lr=0.1, comm_round=30,
                                      client_optimizer="adam"), device="cpu")
    p0 = eng.init_params()
    ref = _np(JaxVFL(splits, JaxFedConfig()).init_params())
    for k, v in flax_to_torch(ref).items():     # same shapes and scales
        assert p0[k].shape == v.shape
        if k.endswith("kernel"):
            assert float(p0[k].std()) == pytest.approx(float(v.std()), rel=0.5)
    assert eng.score(eng.fit(x, y), x, y) > 0.85


# ---------------------------------------------------------------------------
# SplitNN and the split models
# ---------------------------------------------------------------------------

def test_split_models_match_flax():
    rs = np.random.RandomState(0)
    for (jl, ju), (tl, tu), x in (
            (jsplit.split_mlp(10, hidden=32), split_mlp(10, hidden=32),
             rs.rand(4, 784).astype(np.float32)),
            (jsplit.split_cnn(10), split_cnn(10),
             rs.rand(4, 28, 28, 1).astype(np.float32))):
        lv = jl.init(jax.random.PRNGKey(0), x)
        acts = jl.apply(lv, x)
        uv = ju.init(jax.random.PRNGKey(1), acts)
        want = np.asarray(ju.apply(uv, acts))
        tl_p, tu_p = flax_to_torch((_np(lv), _np(uv)))
        got = torch.func.functional_call(tu, tu_p, (torch.func.functional_call(
            tl, tl_p, (torch.tensor(x),)),))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5)


def test_splitnn_round_matches_jax():
    jeng = JaxSplitNN(*jsplit.split_mlp(10, hidden=32), _mnist(jax_load_data),
                      _cfg(JaxFedConfig, lr=0.05))
    cp0, sp0 = _np(jeng.init_params())
    want_c, want_s = jeng.run(rounds=1)
    eng = SplitNNEngine(*split_mlp(10, hidden=32), _mnist(load_data),
                        _cfg(FedConfig, lr=0.05), device="cpu")
    got_c, got_s = eng.run(rounds=1, params=flax_to_torch((cp0, sp0)))
    assert len(got_c) == len(want_c) == 4
    _assert_trees_close(got_s, want_s)
    for g, w in zip(got_c, want_c):
        _assert_trees_close(g, w)
    g, w = eng.metrics_history[-1], jeng.metrics_history[-1]
    assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
    assert g["test_acc"] == pytest.approx(w["test_acc"], abs=1e-6)


# ---------------------------------------------------------------------------
# FedGAN and the GAN pair
# ---------------------------------------------------------------------------

LATENT = 8


@pytest.fixture(scope="module")
def gan():
    jdata = _mnist(jax_load_data, clients=2)
    jeng = JaxFedGAN(jgan.Generator(latent_dim=LATENT, out_dim=784),
                     jgan.Discriminator(), jdata,
                     _cfg(JaxFedConfig, client_num_in_total=2,
                          client_num_per_round=2, lr=0.01),
                     latent_dim=LATENT)
    eng = FedGANEngine(Generator(LATENT, 784), Discriminator(784),
                       _mnist(load_data, clients=2),
                       _cfg(FedConfig, client_num_in_total=2,
                            client_num_per_round=2, lr=0.01),
                       latent_dim=LATENT, device="cpu")
    return jeng, eng, _np(jeng.init_params())


def _jax_zs(rng, n_batches, bs):
    """The z draws of JAX's _local_train batch loop, in order."""
    zs = []
    for _ in range(n_batches):
        rng, zk1, zk2 = jax.random.split(rng, 3)
        zs += [np.asarray(jax.random.normal(k, (bs, LATENT))) for k in (zk1, zk2)]
    return zs


def test_gan_models_match_flax(gan):
    _, eng, p0 = gan
    z = np.random.RandomState(0).standard_normal((4, LATENT)).astype(np.float32)
    x = np.random.RandomState(1).rand(4, 784).astype(np.float32)
    g, d = eng._split(flax_to_torch(p0))
    want_g = jgan.Generator(latent_dim=LATENT, out_dim=784).apply(
        {"params": p0["gen"]}, z)
    want_d = jgan.Discriminator().apply({"params": p0["disc"]}, x)
    np.testing.assert_allclose(eng.gen(g, torch.tensor(z)).numpy(),
                               np.asarray(want_g), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(eng.disc(d, torch.tensor(x)).numpy(),
                               np.asarray(want_d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_batches", [1, 2])
def test_gan_local_train_matches_jax_given_its_z(gan, n_batches):
    """A D step on real and fake, then a G step against the updated D,
    adam on both: JAX's _local_train on one client, and the port's batch
    steps fed JAX's z draws."""
    jeng, eng, p0 = gan
    jshard = jax.tree.map(lambda a: jnp.asarray(a[0, :n_batches]),
                          jeng.data.client_shards)
    rng = jax.random.PRNGKey(3)
    want_p, want_dl, want_gl, want_n = jax.jit(jeng._local_train)(
        jax.tree.map(jnp.asarray, p0), jshard, rng)
    zs = [torch.tensor(z) for z in _jax_zs(rng, n_batches, 8)]
    shard = {k: torch.tensor(np.asarray(v)) for k, v in jshard.items()}
    g, d = eng._split(flax_to_torch(p0))
    g, d, dl, gl, n = eng._local_train(g, d, shard, lambda bs: zs.pop(0))
    assert not zs
    _assert_trees_close(eng._join(g, d), want_p)
    assert float(dl) == pytest.approx(float(want_dl), rel=1e-4)
    assert float(gl) == pytest.approx(float(want_gl), rel=1e-4)
    assert float(n) == float(want_n)


def test_gan_round_draws_z_and_folds_the_pair(gan):
    """The public round: z of the right shape and unit moments from each
    client's host generator (the same on any device), a finite (G, D)
    mean that equals the sample-weighted mean of the clients' pairs."""
    _, eng, p0 = gan
    draws = eng._draw(0, 1)(4096)
    assert draws.shape == (4096, LATENT) and draws.dtype == torch.float32
    assert abs(float(draws.mean())) < 0.05 and abs(float(draws.std()) - 1) < 0.05
    assert torch.equal(eng._draw(0, 1)(8), eng._draw(0, 1)(8))
    assert not torch.equal(eng._draw(0, 1)(8), eng._draw(0, 0)(8))
    start = flax_to_torch(p0)
    cohort, w = eng.data.cohort(np.arange(2), "cpu")
    new, m = eng.round_fn(dict(start), cohort, 0)
    rows = []
    for i in range(2):
        g, d, *_ = eng._local_train(*eng._split(start),
                                    {k: t[i] for k, t in cohort.items()},
                                    eng._draw(0, i))
        rows.append(torch.cat([g, d]))
    want = (w[:, None] * torch.stack(rows)).sum(0) / w.sum()
    got = torch.cat(eng._split(new))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert np.isfinite(float(m["d_loss"])) and np.isfinite(float(m["g_loss"]))
    params = eng.run(rounds=2, params=start)
    imgs = eng.generate(params, 4)
    assert imgs.shape == (4, 784) and bool(torch.isfinite(imgs).all())


# ---------------------------------------------------------------------------
# the converter on nested params and pairs
# ---------------------------------------------------------------------------

def test_converter_round_trips_pairs_and_nested_params(gan):
    _, _, p0 = gan
    vfl = _np(JaxVFL([3, 2], JaxFedConfig()).init_params())
    mlp = jsplit.split_mlp(10, hidden=16)
    x = np.zeros((1, 784), np.float32)
    lv = _np(mlp[0].init(jax.random.PRNGKey(0), x)["params"])
    uv = _np(mlp[1].init(jax.random.PRNGKey(1), np.zeros((1, 16), np.float32))
             ["params"])
    pair = flax_to_torch((lv, uv))
    assert isinstance(pair, tuple) and "Dense_1.kernel" in pair[0]
    for tree, ours in ((p0, flax_to_torch(p0)), (vfl, flax_to_torch(vfl))):
        back = torch_to_flax(ours)["params"]
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    assert "gen.Dense_2.kernel" in flax_to_torch(p0)
    assert "party_1.kernel" in flax_to_torch(vfl)
    back = torch_to_flax(pair)
    for a, b in zip(jax.tree.leaves([t["params"] for t in back]),
                    jax.tree.leaves([lv, uv])):
        np.testing.assert_array_equal(a, b)


def test_new_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, cfg = _mnist(load_data), _cfg(FedConfig)
    trainer = ClientTrainer(create_model("lr", 10))
    topo = SymmetricTopologyManager(4)
    for make in (
            lambda: TurboAggregateEngine(trainer, data, cfg),
            lambda: HierarchicalFedAvgEngine(trainer, data, cfg),
            lambda: CentralizedTrainer(trainer, data, cfg),
            lambda: DecentralizedGossipEngine(trainer, data, cfg, topo),
            lambda: VFLEngine([3, 2], cfg),
            lambda: SplitNNEngine(*split_mlp(10), data, cfg),
            lambda: FedGANEngine(Generator(), Discriminator(), data, cfg),
            lambda: FedSegEngine(trainer, data, cfg),
            lambda: FedGKTEngine(ResNetClientGKT(), ResNetServerGKT(), data,
                                 cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
