"""FedNAS in the PyTorch port against the JAX package
(fedml_tpu/algorithms/fednas.py), in JAX's micro search space (steps 2,
C 4, one cell, 8x8 inputs, batches of 2; tests/test_fednas.py).

The JAX references are jitted single-step functions, built once a module
(``_arch_grad`` first and second order, the two optax chains' updates,
``value_and_grad`` of the loss), looped over batches here; JAX's scanned
rounds are not run (its unrolled and GDAS rounds are its heaviest
programs).  The weights are the port's init carried to flax by
``torch_to_flax``.  Comparisons run in f64 (``jax.enable_x64``), where
flax's fast-variance GroupNorm and the port's two-pass one agree:

* the two optimizers against optax, bitwise in f32 on fixed inputs (the
  clip at a gradient norm below, at and above 5: dyadic gradients, whose
  norm every summation order gives exactly);
* ``_arch_grad`` first and second order within 1e-6 relative, and the
  second-order correction g2 - g1 (nonzero) within 1e-6 of its own norm;
* one client's search (the interleaved split, the gates, an all-padding
  validation batch, the w step on the updated alphas), a single-batch
  unrolled step and a GDAS step given JAX's uniforms, within 1e-9;
* a first-order round, whose server mean folds in f32 (the fold's plain
  version), within rtol 1e-6;
* the retrain engine's FedAvg round against JAX's ``make_train_engine``
  at C 4, layers 2, in f32 (rtol 1e-3, atol 1e-4, as the other engine
  tests);
* a search round in each mode and the search -> retrain flow run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms import fednas as jfednas
from fedml_tpu.core.pytree import tree_weighted_mean
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import darts as jdarts
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fednas import (FedNASSearchEngine,
                                               make_train_engine)
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.trainer import Optimizer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models.darts import DARTS_V2, Genotype
from fedml_tpu_torch.utils.config import FedConfig

torch.set_num_threads(2)
BS, HW, CLASSES, LR = 2, 8, 10, 0.05
MICRO = dict(C=4, layers=1, steps=2, multiplier=2)
F64 = dict(rtol=1e-9, atol=1e-9)


def _data(mod, sizes=(8, 8)):
    rs = np.random.RandomState(0)
    n = sum(sizes)
    x = rs.rand(n, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, CLASSES, n).astype(np.int64)
    ends = np.cumsum(sizes)
    idx = {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(sizes, ends))}
    ev = mod.build_eval_shard(x[:4], y[:4], BS)
    return mod.FederatedData(
        train_data_num=n, test_data_num=4, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, BS),
        client_num_samples=np.asarray(sizes, np.float32),
        test_client_shards=None, class_num=CLASSES, synthetic=True)


def _cfg(cls, n=2):
    return cls(client_num_in_total=n, client_num_per_round=n, comm_round=1,
               epochs=1, batch_size=BS, lr=LR, frequency_of_the_test=1)


def _port(unrolled=False, gdas=False, sizes=(8, 8)):
    return FedNASSearchEngine(_data(tfed, sizes), _cfg(FedConfig, len(sizes)),
                              unrolled=unrolled, gdas=gdas, device="cpu",
                              **MICRO)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        a, jnp.float64 if np.asarray(a).dtype.kind == "f" else None), tree)


class JaxSteps:
    """The JAX engine's single-step functions, jitted, and its local
    search looped over them in Python (the scan's gates as branches)."""

    def __init__(self, unrolled=False, gdas=False):
        eng = jfednas.FedNASSearchEngine(_data(jfed), _cfg(JaxFedConfig),
                                         unrolled=unrolled, gdas=gdas,
                                         donate=False, **MICRO)
        self.eng = eng
        self.arch = jax.jit(eng._arch_grad)
        self.a_upd = jax.jit(eng.a_tx.update)
        self.w_vg = jax.jit(jax.value_and_grad(eng._loss))
        self.w_upd = jax.jit(eng.w_tx.update)

    def local_search(self, p, a, shard):
        """shard: numpy {x, y, mask} [B, bs, ...] -> (p, a, epoch loss)."""
        B = shard["mask"].shape[0]
        half = B // 2
        split = ((lambda s: s[0::2][:half]), (lambda s: s[1::2][:half])) \
            if half else ((lambda s: s), (lambda s: s))
        train, val = ({k: f(v) for k, v in shard.items()} for f in split)
        w_opt, a_opt = self.eng.w_tx.init(p), self.eng.a_tx.init(a)
        losses, counts = [], []
        for b in range(train["mask"].shape[0]):
            tb = _f64({k: v[b] for k, v in train.items()})
            vb = _f64({k: v[b] for k, v in val.items()})
            ga = self.arch(p, a, tb, vb)
            ua, a_opt2 = self.a_upd(ga, a_opt, a)
            if float(jnp.sum(vb["mask"])) > 0:
                a, a_opt = optax.apply_updates(a, ua), a_opt2
            loss, gw = self.w_vg(p, a, tb)
            uw, w_opt2 = self.w_upd(gw, w_opt, p)
            n = float(jnp.sum(tb["mask"]))
            if n > 0:
                p, w_opt = optax.apply_updates(p, uw), w_opt2
            losses.append(float(loss) if n > 0 else 0.0)
            counts.append(n)
        return p, a, np.dot(losses, counts) / max(sum(counts), 1.0)


@pytest.fixture(scope="module")
def jax_first():
    with jax.enable_x64(True):
        yield JaxSteps()


@pytest.fixture(scope="module")
def jax_unrolled():
    with jax.enable_x64(True):
        yield JaxSteps(unrolled=True)


def _state(eng, seed=0, alpha_scale=300.0):
    """The port's init in f64: (flat w, flat alphas, flax params, flax
    alphas), the alphas scaled off the near-uniform 1e-3 init."""
    params, alphas = eng.init_state(torch.Generator().manual_seed(seed))
    params = {k: v.double() for k, v in params.items()}
    alphas = {k: v.double() * alpha_scale for k, v in alphas.items()}
    p = torch.cat([params[n].reshape(-1) for n in eng.net.spec.names])
    a = eng.flatten_alphas(alphas)
    with jax.enable_x64(True):
        jp = _f64(torch_to_flax(params)["params"])
        ja = {k: jnp.asarray(v.numpy()) for k, v in alphas.items()}
    return p, a, jp, ja


def _batch64(shard, c, b):
    return {k: torch.tensor(np.asarray(v[c, b], np.float64 if k != "y"
                                       else np.int64)) for k, v in shard.items()}


def _flat_params(eng, jp):
    state = flax_to_torch({"params": jax.tree.map(np.asarray, jp)})
    return torch.cat([state[n].reshape(-1) for n in eng.net.spec.names])


def _flat_alphas(ja):
    return np.concatenate([np.asarray(ja["normal"]).ravel(),
                           np.asarray(ja["reduce"]).ravel()])


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

def _dyadic_grads(norm, steps=3, n=64):
    """Gradients with +-3 and +-4 (norm / 5) at two random places and zeros
    elsewhere: ||g|| = norm exactly, whatever the order of the sum."""
    rs = np.random.RandomState(int(norm * 8))
    out = []
    for _ in range(steps):
        g = np.zeros(n, np.float32)
        g[rs.choice(n, 2, replace=False)] = (3.0, 4.0)
        g *= rs.choice([-1.0, 1.0], n).astype(np.float32)
        out.append(g * np.float32(norm / 5.0))
    return out


@pytest.mark.parametrize("norm", [2.5, 5.0, 10.0],
                         ids=["below", "at", "above"])
def test_w_optimizer_matches_optax_bitwise(norm):
    """clip_by_global_norm(5) -> add_decayed_weights(3e-4) -> sgd(lr,
    momentum=0.9): the clip before the decay, at || g || below, at
    (optax clips at equality) and above the bound."""
    tx = optax.chain(optax.clip_by_global_norm(5.0),
                     optax.add_decayed_weights(3e-4),
                     optax.sgd(0.025, momentum=0.9))
    ours = Optimizer("sgd", 0.025, 0.9, 3e-4, clip_norm=5.0)
    p0 = np.random.RandomState(1).randn(64).astype(np.float32)
    jp, tp = jnp.asarray(p0), torch.tensor(p0)
    js, ts = tx.init(jp), ours.init(tp)
    for g in _dyadic_grads(norm):
        assert float(np.sqrt(np.sum(g.astype(np.float64) ** 2))) == norm
        ju, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ours.update(torch.tensor(g), ts, tp)
        tp = tp + tu
        assert np.array_equal(tp.numpy(), np.asarray(jp))


def test_alpha_optimizer_matches_optax_bitwise():
    """add_decayed_weights(1e-3) -> scale_by_adam(b1=0.5, b2=0.999) ->
    scale(-3e-4), four steps at gradient scales 1e-2 to 10."""
    tx = optax.chain(optax.add_decayed_weights(1e-3),
                     optax.scale_by_adam(b1=0.5, b2=0.999), optax.scale(-3e-4))
    ours = Optimizer("adam", 3e-4, weight_decay=1e-3, b1=0.5, b2=0.999)
    rs = np.random.RandomState(2)
    p0 = rs.randn(2 * 5 * 8).astype(np.float32) * 1e-3
    jp, tp = jnp.asarray(p0), torch.tensor(p0)
    js, ts = tx.init(jp), ours.init(tp)
    for step in range(4):
        g = rs.randn(p0.size).astype(np.float32) * 10.0 ** (step - 2)
        ju, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ours.update(torch.tensor(g), ts, tp)
        tp = tp + tu
        assert np.array_equal(tp.numpy(), np.asarray(jp))


def test_optimizer_defaults_unchanged():
    opt = Optimizer("adam", 0.1)
    assert (opt.clip_norm, opt.B1, opt.B2, opt.EPS) == (None, 0.9, 0.999, 1e-8)


# ---------------------------------------------------------------------------
# the architect
# ---------------------------------------------------------------------------

def _arch_grads(eng, jsteps, c=0, b=0):
    data = eng.data.client_shards
    p, a, jp, ja = _state(eng)
    tb, vb = _batch64(data, c, b), _batch64(data, c, b + 1)
    got = eng._arch_grad(p, a, tb, vb).numpy()
    with jax.enable_x64(True):
        jtb = _f64({k: v[c, b] for k, v in data.items()})
        jvb = _f64({k: v[c, b + 1] for k, v in data.items()})
        want = _flat_alphas(jsteps.arch(jp, ja, jtb, jvb))
    return got, want


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_arch_grad_first_order_f64(jax_first):
    got, want = _arch_grads(_port(), jax_first)
    assert np.abs(want).max() > 0 and _rel(got, want) < 1e-6


def test_arch_grad_second_order_and_correction_f64(jax_first, jax_unrolled):
    g1, j1 = _arch_grads(_port(), jax_first)
    g2, j2 = _arch_grads(_port(unrolled=True), jax_unrolled)
    assert _rel(g2, j2) < 1e-6
    # the second-order correction on its own: nonzero, and JAX's within
    # 1e-6 of its own norm (a correction that lost the GroupNorm terms
    # would hide inside a tolerance on g2 itself)
    corr, jcorr = g2 - g1, j2 - j1
    assert np.abs(jcorr).max() > 1e-8
    assert _rel(corr, jcorr) < 1e-6


# ---------------------------------------------------------------------------
# one client's search: the split, the gates, the order of the steps
# ---------------------------------------------------------------------------

def _search_vs_jax(eng, jsteps, shard_np):
    p, a, jp, ja = _state(eng, seed=1)
    shard = {k: torch.tensor(np.asarray(v, np.float64 if k != "y" else
                                        np.int64)) for k, v in shard_np.items()}
    gen = torch.Generator().manual_seed(0)
    p1, a1, loss, n = eng._local_search(p, a, shard, 1, gen)
    with jax.enable_x64(True):
        jp1, ja1, jloss = jsteps.local_search(jp, ja, shard_np)
    np.testing.assert_allclose(p1.numpy(), _flat_params(eng, jp1).numpy(),
                               **F64)
    np.testing.assert_allclose(a1.numpy(), _flat_alphas(ja1), **F64)
    np.testing.assert_allclose(float(loss), jloss, **F64)
    assert float(n) == float(shard_np["mask"].sum())
    return a, a1


def test_local_search_interleaved_split_matches_jax(jax_first):
    """A client of 7 samples in 4 batches of 2 (the last half padding):
    train on batches 0 and 2, alpha steps on 1 and 3."""
    eng = _port(sizes=(7, 2))
    shard = {k: v[0] for k, v in eng.data.client_shards.items()}
    assert shard["mask"].sum(axis=1).tolist() == [2, 2, 2, 1]
    _search_vs_jax(eng, jax_first, shard)


def test_gates_all_padding_validation_batch(jax_first):
    """Masks [real, padding, real, real]: the first alpha step is gated
    off (and keeps Adam's state and count), the second runs; a client
    whose whole validation half is padding keeps its alphas bitwise."""
    eng = _port(sizes=(7, 2))
    shard = {k: v[0].copy() for k, v in eng.data.client_shards.items()}
    shard["mask"][1] = 0.0
    a0, a1 = _search_vs_jax(eng, jax_first, shard)
    assert not torch.equal(a0, a1)
    lonely = {k: v[1] for k, v in eng.data.client_shards.items()}
    assert lonely["mask"].sum(axis=1).tolist() == [2, 0, 0, 0]
    a0, a1 = _search_vs_jax(eng, jax_first, lonely)
    assert torch.equal(a0, a1)


def test_unrolled_single_batch_step_matches_jax(jax_unrolled):
    """A single-batch client: single-level search, one exact second-order
    alpha step and one w step on the same batch."""
    eng = _port(unrolled=True, sizes=(2, 8))
    shard = {k: v[0][:1] for k, v in eng.data.client_shards.items()}
    _search_vs_jax(eng, jax_unrolled, shard)


def test_gdas_step_given_jax_uniforms():
    """GDAS: the loss and its gradients for w and for the alphas (the
    first-order arch gradient) with JAX's Gumbel uniforms handed to the
    port (the draws themselves cannot match jax.random)."""
    eng = _port(gdas=True)
    p, a, jp, ja = _state(eng, seed=2, alpha_scale=100.0)
    data = eng.data.client_shards
    rng = jax.random.PRNGKey(4)
    with jax.enable_x64(True):
        jeng = jfednas.FedNASSearchEngine(_data(jfed), _cfg(JaxFedConfig),
                                          gdas=True, donate=False, **MICRO)
        tb = _f64({k: v[0, 0] for k, v in data.items()})
        want_l, (want_w, want_a) = jax.jit(jax.value_and_grad(
            jeng._loss, argnums=(0, 1)))(jp, ja, tb, rng)
        rn, rr = jax.random.split(rng)
        u = np.stack([np.asarray(jax.random.uniform(
            k, (5, 8), jnp.float64, minval=1e-20, maxval=1.0))
            for k in (rn, rr)])
    noise, batch = torch.tensor(u), _batch64(data, 0, 0)
    got_a = eng._arch_grad(p, a, batch, batch, noise).numpy()
    want_a = _flat_alphas(want_a)
    assert np.abs(want_a).max() > 0 and _rel(got_a, want_a) < 1e-6
    leaf = p.clone().requires_grad_()
    loss = eng._loss(leaf, a, batch, noise)
    (gw,) = torch.autograd.grad(loss, leaf)
    np.testing.assert_allclose(float(loss.detach()), float(want_l), **F64)
    np.testing.assert_allclose(gw.numpy(), _flat_params(eng, want_w).numpy(),
                               **F64)


# ---------------------------------------------------------------------------
# rounds
# ---------------------------------------------------------------------------

def test_first_order_round_matches_jax(jax_first):
    """Both clients' searches (one with a padding tail), then the server's
    sample-weighted mean of [w | alphas], folded in f32."""
    eng = _port(sizes=(7, 2))
    p, a, jp, ja = _state(eng, seed=3)
    shards = eng.data.client_shards
    cohort = {k: torch.tensor(np.asarray(v, np.float64 if k != "y" else
                                         np.int64)) for k, v in shards.items()}
    p1, a1, m = eng.round_fn(p, a, cohort, 0)
    assert p1.dtype == torch.float32
    with jax.enable_x64(True):
        outs = [jax_first.local_search(jp, ja, {k: v[c] for k, v in
                                                shards.items()})
                for c in range(2)]
        ns = jnp.asarray(eng.data.client_num_samples, jnp.float64)
        stack = lambda trees: jax.tree.map(lambda *l: jnp.stack(l), *trees)
        jp1 = tree_weighted_mean(stack([o[0] for o in outs]), ns)
        ja1 = tree_weighted_mean(stack([o[1] for o in outs]), ns)
        jloss = float(np.dot([o[2] for o in outs], ns) / ns.sum())
    tol = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(p1.numpy(), _flat_params(eng, jp1).numpy(),
                               **tol)
    np.testing.assert_allclose(a1.numpy(), _flat_alphas(ja1), **tol)
    np.testing.assert_allclose(float(m["train_loss"]), jloss, **tol)


@pytest.mark.parametrize("mode", ["first_order", "unrolled", "gdas"])
def test_search_round_runs_and_moves_both_trees(mode):
    eng = _port(unrolled=mode == "unrolled", gdas=mode == "gdas")
    p0, a0 = eng.init_state()
    params, alphas = eng.run(rounds=1)
    stats = eng.metrics_history[-1]
    assert np.isfinite(stats["train_loss"]) and 0.0 <= stats["test_acc"] <= 1.0
    # layers=1: the lone cell is a reduction cell
    assert not torch.equal(alphas["reduce"], a0["reduce"])
    assert any(not torch.equal(params[k], p0[k]) for k in p0)


def test_gdas_noise_is_the_same_on_every_run():
    """GDAS's uniforms come from the client's host generator: two runs of
    the same round give bitwise the same result."""
    outs = []
    for _ in range(2):
        eng = _port(gdas=True)
        params, alphas = eng.run(rounds=1)
        outs.append(eng.flatten_alphas(alphas))
    assert torch.equal(*outs)


def test_search_then_retrain_flow():
    eng = _port()
    _, alphas = eng.run(rounds=1)
    genotype = eng.genotype(alphas)
    for gene in (genotype.normal, genotype.reduce):
        assert len(gene) == 4 and all(op != "none" for op, _ in gene)
    train = make_train_engine(genotype, eng.data, eng.cfg, C=4, layers=2,
                              device="cpu")
    v0 = train.init_variables()
    v1 = train.run(variables=dict(v0), rounds=1)
    assert train.metrics_history and np.isfinite(
        train.metrics_history[-1]["train_loss"])
    assert any(not torch.equal(v1[k], v0[k]) for k in v0)


def test_retrain_round_matches_jax():
    """make_train_engine's FedAvg round (SGD lr 0.05, momentum 0.9, wd
    3e-4) on DartsNetwork(DARTS_V2, C 4, layers 2) against JAX's, from the
    same weights, in f32."""
    tdata, jdata = _data(tfed), _data(jfed)
    ours = make_train_engine(DARTS_V2, tdata, _cfg(FedConfig), C=4, layers=2,
                             device="cpu")
    v0 = ours.init_variables(torch.Generator().manual_seed(5))
    ref = jfednas.make_train_engine(jdarts.DARTS_V2, jdata, _cfg(JaxFedConfig),
                                    C=4, layers=2, donate=False)
    want = ref.run(variables=jax.tree.map(jnp.asarray, torch_to_flax(v0)),
                   rounds=1)
    got = ours.run(variables=dict(v0), rounds=1)
    want = flax_to_torch(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ours.metrics_history[-1]["train_loss"],
                               ref.metrics_history[-1]["train_loss"],
                               rtol=1e-4)


def test_genotype_type_and_defaults():
    eng = _port()
    g = eng.genotype({k: torch.zeros(5, 8) for k in ("normal", "reduce")})
    assert isinstance(g, Genotype) and g.normal_concat == [2, 3]


def test_entry_point_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedNASSearchEngine(_data(tfed), _cfg(FedConfig), **MICRO)
