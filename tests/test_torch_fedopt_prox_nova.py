"""FedOpt, FedProx and FedNova in the PyTorch port against the JAX package.

* The four server optimizers step by step against optax (the JAX
  package's ``make_server_optimizer``), state included: rtol 1e-5 (the same
  f32 formulas; bias corrections and square roots may round differently).
* Engine rounds at ResNet-18-GN num_filters=8 on 16x16 images, on a ragged
  cohort (clients of 8, 4, 6 and 12 samples in batches of 4, so their
  step counts tau differ):
  - FedOpt, each server optimizer, three rounds so the state carries: the
    JAX side is its ``FedOptEngine.aggregate`` after the cohort's jitted
    training (the composition of test_torch_robust.py);
  - FedProx (mu 1.0), both engines, two rounds against the JAX trainer's
    proximal loss and FedAvg's aggregate;
  - FedNova, both engines, two rounds against the JAX ``FedNovaEngine``'s
    tau and normalized average after the cohort's jitted training, with 3
    of the 4 clients sampled so that the chunked engine carries a
    zero-weight pad lane.
  Each port round starts from JAX's model of the round before, as in
  test_torch_robust.py; tolerance as there: per leaf atol 1e-4 / rtol 1e-3
  each round, train loss rel 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgEngine as JaxFedAvgEngine
from fedml_tpu.algorithms.fednova import FedNovaEngine as JaxFedNovaEngine
from fedml_tpu.algorithms.fednova import fednova_tau as jax_fednova_tau
from fedml_tpu.algorithms.fedopt import FedOptEngine as JaxFedOptEngine
from fedml_tpu.algorithms.fedopt import \
    make_server_optimizer as jax_make_server_optimizer
from fedml_tpu.data import federated as jfed
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fednova import FedNovaEngine, fednova_tau
from fedml_tpu_torch.algorithms.fedopt import (FedOptEngine,
                                               make_server_optimizer)
from fedml_tpu_torch.algorithms.fedprox import FedProxEngine
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.parallel.engine import (MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshFedProxEngine)
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_robust import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_robust import (assert_rounds_match, flat, jax_chain,
                                     jax_cohort, jax_init, jax_trainer,
                                     make_cfg, make_data, port_trainer)

SERVER_OPTS = {"sgd": (1.0, 0.0), "fedavgm": (0.5, 0.9), "adam": (0.01, 0.0),
               "yogi": (0.01, 0.0), "adagrad": (0.3, 0.0)}


# ---------------------------------------------------------------------------
# server optimizers against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SERVER_OPTS))
def test_server_optimizer_steps_match_optax(name):
    lr, momentum = SERVER_OPTS[name]
    rs = np.random.RandomState(0)
    params = {"a": rs.randn(4, 3).astype(np.float32),
              "b": rs.randn(6).astype(np.float32)}
    ours = make_server_optimizer(name, lr, momentum)
    ref = jax_make_server_optimizer(name, lr, momentum)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = ours.init(tp), ref.init(jp)
    for step in range(5):
        g = {k: (rs.randn(*v.shape) * 10.0 ** (step - 2)).astype(np.float32)
             for k, v in params.items()}
        g["b"][0] = 0.0                       # a coordinate with no gradient
        tu, ts = ours.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        ju, js = ref.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"{k} {step}")
        tp = {k: tp[k] + tu[k] for k in tp}
        jp = optax.apply_updates(jp, ju)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-6)


def test_server_optimizer_defaults_are_optaxs():
    """The accumulators start where optax's do: adagrad at 0.1 (torch's
    Adagrad at 0), yogi's moments at 1e-6."""
    p = {"a": torch.zeros(3)}
    assert torch.equal(make_server_optimizer("adagrad", 0.1).init(p)
                       ["sum_of_squares"]["a"], torch.full((3,), 0.1))
    yogi = make_server_optimizer("yogi", 0.1).init(p)
    assert torch.equal(yogi["nu"]["a"], torch.full((3,), 1e-6))
    assert make_server_optimizer("sgd", 1.0, 0.0).init(p) == {}
    with pytest.raises(ValueError, match="unknown server optimizer"):
        make_server_optimizer("lamb", 0.1)


def test_fednova_tau_matches_jax():
    shards = make_data(tfed).client_shards
    want = [float(jax_fednova_tau({"mask": jnp.asarray(m)}, 3))
            for m in shards["mask"]]
    got = fednova_tau({"mask": torch.tensor(shards["mask"])}, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want == [6.0, 3.0, 6.0, 9.0]       # ragged: tau differs
    assert float(fednova_tau({"mask": torch.tensor(shards["mask"][1])}, 3)) == 3.0


# ---------------------------------------------------------------------------
# engine rounds
# ---------------------------------------------------------------------------

def _opt_cfg(cls, name):
    lr, momentum = SERVER_OPTS[name]
    return make_cfg(cls, server_optimizer=name, server_lr=lr,
                    server_momentum=momentum, comm_round=3)


@functools.lru_cache(maxsize=None)
def jax_fedopt(name):
    """Three rounds of the JAX FedOptEngine: the cohort's training, then
    the engine's own aggregate (server optimizer state carried)."""
    tr, train = jax_trainer()
    eng = JaxFedOptEngine(tr, make_data(jfed), _opt_cfg(JaxFedConfig, name),
                          donate=False)
    state = [eng.server_init(jax_init())]

    def round_fn(v, r):
        stacked, losses, ns = train(v, jax_cohort())
        v, state[0] = eng.aggregate(stacked, ns, v, state[0],
                                    jax.random.PRNGKey(r))
        return v, jnp.sum(losses * ns) / jnp.sum(ns)
    return jax_chain(round_fn, 3)


@pytest.mark.parametrize("engine_cls,name", [
    (MeshFedOptEngine, "sgd"), (MeshFedOptEngine, "fedavgm"),
    (MeshFedOptEngine, "adam"), (MeshFedOptEngine, "yogi"),
    (MeshFedOptEngine, "adagrad"), (FedOptEngine, "adam")])
def test_fedopt_three_rounds_match_jax(engine_cls, name):
    kw = {"chunk": 2} if engine_cls is MeshFedOptEngine else {}
    eng = engine_cls(port_trainer(), make_data(tfed), _opt_cfg(FedConfig, name),
                     device="cpu", **kw)
    assert_rounds_match(eng, jax_fedopt(name))


PROX_MU = 1.0


@functools.lru_cache(maxsize=None)
def jax_fedavg_rounds(prox_mu):
    """Two FedAvg rounds with the JAX trainer at `prox_mu`: its training
    (handed the round's global params when mu > 0), then the FedAvg
    engine's aggregate."""
    tr, train = jax_trainer(None, prox_mu)
    eng = JaxFedAvgEngine(tr, make_data(jfed), make_cfg(JaxFedConfig),
                          donate=False)

    def round_fn(v, r):
        stacked, losses, ns = train(v, jax_cohort())
        v, _ = eng.aggregate(stacked, ns, v, (), jax.random.PRNGKey(r))
        return v, jnp.sum(losses * ns) / jnp.sum(ns)
    return jax_chain(round_fn, 2)


@pytest.mark.parametrize("engine_cls", [MeshFedProxEngine, FedProxEngine])
def test_fedprox_two_rounds_match_jax(engine_cls):
    trainer = port_trainer()
    kw = {"chunk": 2} if engine_cls is MeshFedProxEngine else {}
    eng = engine_cls(trainer, make_data(tfed),
                     make_cfg(FedConfig, prox_mu=PROX_MU), device="cpu", **kw)
    assert trainer.prox_mu == 0.0 and eng.trainer.prox_mu == PROX_MU
    chain = jax_fedavg_rounds(PROX_MU)
    assert_rounds_match(eng, chain)
    # the proximal term moves the result ten times beyond that tolerance
    want, plain = flat(chain[0][0]), flat(jax_fedavg_rounds(0.0)[0][0])
    assert (np.abs(want - plain) > 10 * (1e-4 + 1e-3 * np.abs(plain))).any()


NOVA_CLIENTS = 3


@functools.lru_cache(maxsize=None)
def jax_fednova():
    """Two rounds of the JAX FedNovaEngine over the sampler's 3-client
    cohorts: the cohort's training, then its _round's tau and nova_avg
    (algorithms/fednova.py:47-63)."""
    eng = JaxFedNovaEngine(jax_trainer()[0], make_data(jfed),
                           make_cfg(JaxFedConfig,
                                    client_num_per_round=NOVA_CLIENTS),
                           donate=False)
    _, train = jax_trainer()

    def round_fn(v, r):
        (cohort,) = eng._round_args(r)
        stacked, losses, ns = train(v, cohort)
        taus = jax.vmap(lambda s: jax_fednova_tau(s, 1))(cohort)
        p = ns / jnp.sum(ns)
        tau_eff = jnp.sum(p * taus)

        def nova_avg(g, w):
            shape = (-1,) + (1,) * (w.ndim - 1)
            d = jnp.sum(p.reshape(shape) * (g[None] - w)
                        / jnp.maximum(taus.reshape(shape), 1.0), axis=0)
            return g - tau_eff * d

        return ({"params": jax.tree.map(nova_avg, v["params"],
                                        stacked["params"])},
                jnp.sum(losses * ns) / jnp.sum(ns))
    return jax_chain(round_fn, 2)


@pytest.mark.parametrize("engine_cls", [MeshFedNovaEngine, FedNovaEngine])
def test_fednova_two_rounds_match_jax(engine_cls):
    kw = {"chunk": 2} if engine_cls is MeshFedNovaEngine else {}
    eng = engine_cls(port_trainer(), make_data(tfed),
                     make_cfg(FedConfig, client_num_per_round=NOVA_CLIENTS),
                     device="cpu", **kw)
    assert_rounds_match(eng, jax_fednova())
