"""Norm-clipped aggregation and the robust defenses of the PyTorch port
against the JAX package.

* The clipped fold's plain twins and ``robust_weighted_mean`` against
  ``robust_weighted_mean_pallas(..., interpret=True)`` (its Pallas kernels
  in interpret mode, as the JAX tests run them on the CPU) and against
  ``vmap(norm_diff_clip)`` + ``tree_weighted_mean``, at bounds that clip
  none, some and all clients.  Tolerance: rtol 1e-5 / atol 1e-6 (f32 sums
  over a few clients in another order).
* ``core/robust.py`` function by function, with the JAX package's pins
  (outlier rejection, NaN and Inf rows, the even-count median) as cases.
* Two rounds of ``FedAvgRobustEngine`` (all five defenses) and
  ``MeshRobustEngine`` (all five, f32 and bf16 local masters) at
  ResNet-18-GN num_filters=8 on 16x16 images.  The JAX side is the JAX
  package's own round, composed as its engines compose it: each client
  trained by the JAX ClientTrainer's train_step (jitted once, looped over
  the batches and clients as the port loops them; see jax_trainer), then
  the JAX engine's aggregation (``FedAvgRobustEngine.aggregate``; for the
  mesh engine ``client_transform`` + the f32 fold + ``_finalize_from_sums``
  + ``server_update``, or the order-statistic lines of ``_shard_body``),
  so that one compile serves every defense.  Each port round starts from
  JAX's model of the round before (``port_rounds`` says why).  f32: per
  leaf atol 1e-4 / rtol 1e-3 each round (20 conv and GroupNorm layers,
  sums in another order); bf16 local masters: within 2x of the distance
  bf16 rounding itself puts between JAX's bf16 and f32 rounds (L2 over the
  model).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustEngine as JaxFedAvgRobustEngine
from fedml_tpu.core import pytree as jpytree
from fedml_tpu.core import robust as jrobust
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.core.trainer import TrainState
from fedml_tpu.data import federated as jfed
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu.ops.aggregate import (flatten_stacked_tree as jax_flatten,
                                     robust_weighted_mean_pallas,
                                     unflatten_to_tree as jax_unflatten)
from fedml_tpu.parallel.engine import MeshRobustEngine as JaxMeshRobustEngine
from fedml_tpu.parallel.engine import cast_local, weighted_sum_tree
from fedml_tpu.parallel.mesh import make_mesh
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustEngine
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core import pytree, robust
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops import aggregate
from fedml_tpu_torch.ops.aggregate import (TILE, clip_agg_plain, clip_fold,
                                           robust_weighted_mean, shift_toward,
                                           sqnorm_plain)
from fedml_tpu_torch.parallel.engine import MeshRobustEngine
from fedml_tpu_torch.utils.config import FedConfig

SHAPES = {"conv": (3, 3, 2, 4), "scale": (4,), "dense": (5, 3)}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes at
    once, and PyTorch's default of one thread per core in each of them
    oversubscribes the cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
DEFENSES = ("norm_clip", "krum", "multi_krum", "median", "trimmed_mean")


def _stacked(seed, C=5):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(C, *s).astype(np.float32) for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the clipped fold: kernel twins and robust_weighted_mean
# ---------------------------------------------------------------------------

def _distances(st, g):
    return np.sqrt(sum(((st[k] - g[k][None]) ** 2).reshape(len(st[k]), -1)
                       .sum(1) for k in st))


@pytest.mark.parametrize("clipped", ["none", "some", "all"])
def test_robust_weighted_mean_matches_pallas_and_clip_then_mean(clipped):
    st = _stacked(3)
    g = {k: v[0] * 0.5 for k, v in st.items()}
    w = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    d = _distances(st, g)
    tau = {"none": 2 * d.max(), "some": float(np.median(d)),
           "all": 0.5 * d.min()}[clipped]
    n_clipped = int((d > tau).sum())
    assert {"none": n_clipped == 0, "some": 0 < n_clipped < 5,
            "all": n_clipped == 5}[clipped]
    got = robust_weighted_mean(_t(st), torch.tensor(w), _t(g), tau)
    pallas = robust_weighted_mean_pallas(_j(st), jnp.asarray(w), _j(g), tau,
                                         interpret=True)
    clipped_tree = jax.vmap(lambda p: jrobust.norm_diff_clip(p, _j(g), tau))(
        _j(st))
    mean = jpytree.tree_weighted_mean(clipped_tree, jnp.asarray(w))
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(pallas[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(mean[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_sqnorm_plain_is_the_squared_distance():
    rs = np.random.RandomState(4)
    V = rs.randn(3, 2 * TILE).astype(np.float32)
    g = rs.randn(2 * TILE).astype(np.float32)
    want = ((V.astype(np.float64) - g) ** 2).sum(1)
    np.testing.assert_allclose(sqnorm_plain(torch.tensor(V), torch.tensor(g)),
                               want, rtol=1e-6)
    # bf16 lanes against a bf16 g: the difference is taken in f32
    Vb, gb = torch.tensor(V).bfloat16(), torch.tensor(g).bfloat16()
    want_b = ((Vb.double() - gb.double()) ** 2).sum(1)
    np.testing.assert_allclose(sqnorm_plain(Vb, gb), want_b, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_fold_is_client_transform_then_the_fold(dtype):
    """num += sum(w) g + sum_k w_k s_k (v_k - g) against the JAX mesh
    engine's per-client norm_diff_clip in the local dtype, then its f32
    fold.  f32: rtol 1e-5; bf16: JAX subtracts, scales and re-adds in bf16
    where the kernel works in f32, so within 4 bf16 ulps of |g| + |v|."""
    rs = np.random.RandomState(5)
    P = 2 * TILE
    V = torch.tensor(rs.randn(3, P), dtype=dtype)
    g = torch.tensor(rs.randn(P) * 0.5, dtype=dtype)
    w = torch.tensor([3.0, 0.0, 5.0])          # a zero-weight pad lane
    acc0 = rs.randn(P).astype(np.float32)
    tau = float(np.median(np.sqrt(sqnorm_plain(V, g).numpy())))
    s = pytree.clip_scale(sqnorm_plain(V, g), tau)
    assert (s < 1).any() and (s == 1).any()
    acc = torch.tensor(acc0)
    clip_fold(acc, V, g, (w * s).contiguous(), w.sum())

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jV = jnp.asarray(V.float().numpy(), jdt)
    jg = jnp.asarray(g.float().numpy(), jdt)
    clipped = jax.vmap(lambda v: jrobust.norm_diff_clip(
        {"p": v}, {"p": jg}, tau)["p"])(jV)
    want = jnp.asarray(acc0) + weighted_sum_tree(jnp.asarray(w.numpy()),
                                                 {"p": clipped})["p"]
    if dtype == torch.float32:
        np.testing.assert_allclose(acc.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        scale = (w.sum() * (g.float().abs() + V.float().abs().amax(0))).numpy()
        assert np.all(np.abs(acc.numpy() - np.asarray(want))
                      <= 4 * 2.0 ** -8 * scale + 1e-5)


def test_clip_fold_is_fednovas_d_fold():
    """base 0, cf = -w / max(tau, 1): sum_k (w_k / tau_k) (g - v_k), the
    JAX FedNova chunk body's einsum (engine.py:1151-1157)."""
    rs = np.random.RandomState(6)
    V = rs.randn(3, TILE).astype(np.float32)
    g = rs.randn(TILE).astype(np.float32)
    w = np.asarray([4.0, 2.0, 0.0], np.float32)
    tau = np.asarray([2.0, 1.0, 0.0], np.float32)
    acc = torch.zeros(TILE)
    clip_fold(acc, torch.tensor(V), torch.tensor(g),
              torch.tensor(-w / np.maximum(tau, 1.0)), 0.0)
    coef = jnp.asarray(w) / jnp.maximum(jnp.asarray(tau), 1.0)
    want = jnp.einsum("k,k...->...", coef, jnp.asarray(g)[None] - jnp.asarray(V))
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_shift_toward_writes_in_place_into_g():
    rs = np.random.RandomState(7)
    V = torch.tensor(rs.randn(2, TILE), dtype=torch.float32)
    g = torch.tensor(rs.randn(TILE), dtype=torch.float32)
    g0, ptr = g.clone(), g.data_ptr()
    cf = torch.tensor([0.25, 0.5])
    shift_toward(g, V, cf)
    assert g.data_ptr() == ptr
    np.testing.assert_allclose(g.numpy(),
                               (g0 + (cf[:, None] * (V - g0)).sum(0)).numpy(),
                               rtol=1e-6, atol=1e-6)
    out = torch.zeros(TILE)
    clip_agg_plain(out, V, g0, cf, 1.0, accumulate=False)
    np.testing.assert_allclose(out.numpy(), g.numpy(), rtol=1e-6, atol=1e-6)


def test_robust_wrappers_reject_what_the_kernels_do_not_take():
    V, g = torch.zeros(2, TILE), torch.zeros(TILE)
    with pytest.raises(ValueError, match="sqnorm g"):
        aggregate.sqnorm(V, g.bfloat16())
    with pytest.raises(ValueError, match="accumulate into g"):
        aggregate.clip_agg(g, V, g, torch.ones(2), 1.0, accumulate=True)
    with pytest.raises(ValueError, match="clip_agg out"):
        aggregate.clip_agg(torch.zeros(TILE).bfloat16(), V.bfloat16(),
                           g.bfloat16(), torch.ones(2), 1.0, accumulate=False)
    with pytest.raises(ValueError, match="factors"):
        aggregate.clip_agg(torch.zeros(TILE), V, g, torch.ones(3), 1.0,
                           accumulate=True)
    with pytest.raises(ValueError, match="base"):
        aggregate.clip_agg(torch.zeros(TILE), V, g, torch.ones(2),
                           torch.ones(2), accumulate=True)


# ---------------------------------------------------------------------------
# the pytree helpers and core/robust.py against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_tree_arithmetic_matches_jax(dtype):
    """The same ops in the same dtype; f32 norms summed in another order
    may move a bf16 result by one ulp (rtol 2^-8), f32 by 1e-6."""
    a, b = _stacked(8, 2), _stacked(9, 2)
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 1e-6
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ja = {k: jnp.asarray(v, jdt) for k, v in a.items()}
    jb = {k: jnp.asarray(v, jdt) for k, v in b.items()}
    ta = {k: torch.tensor(v).to(tdt) for k, v in a.items()}
    tb = {k: torch.tensor(v).to(tdt) for k, v in b.items()}
    f = lambda t: {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in t.items()}
    g = lambda t: {k: v.float().numpy() for k, v in t.items()}
    for got, want in ((pytree.tree_add(ta, tb), jpytree.tree_add(ja, jb)),
                      (pytree.tree_sub(ta, tb), jpytree.tree_sub(ja, jb)),
                      (pytree.tree_scale(ta, 0.3), jpytree.tree_scale(ja, 0.3)),
                      (pytree.tree_clip_by_norm(ta, 1.5),
                       jpytree.tree_clip_by_norm(ja, 1.5))):
        for k in SHAPES:
            np.testing.assert_allclose(g(got)[k], f(want)[k], rtol=rtol,
                                       atol=1e-6)
    assert float(pytree.tree_sq_norm(ta)) == pytest.approx(
        float(jpytree.tree_sq_norm(ja)), rel=1e-6)
    assert float(pytree.tree_l2_norm(ta)) == pytest.approx(
        float(jpytree.tree_l2_norm(ja)), rel=1e-6)


@pytest.mark.parametrize("shift", [0.1, 3.0])
def test_norm_diff_clip_and_clip_row_match_jax(shift):
    rs = np.random.RandomState(10)
    gl = {"w": rs.randn(5, 4).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    lo = {k: v + shift for k, v in gl.items()}
    got = robust.norm_diff_clip(_t(lo), _t(gl), 1.0)
    want = jrobust.norm_diff_clip(_j(lo), _j(gl), 1.0)
    for k in gl:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    row = rs.randn(33).astype(np.float32) * shift
    np.testing.assert_allclose(robust.clip_row(torch.tensor(row), 1.0).numpy(),
                               np.asarray(jrobust.clip_row(jnp.asarray(row), 1.0)),
                               rtol=1e-6, atol=1e-7)


def _cluster_with_outlier(k=8, p=6, scale=0.01, seed=3):
    rs = np.random.RandomState(seed)
    flat = rs.randn(k, p).astype(np.float32) * scale
    flat[k - 1] = 50.0                          # the byzantine row
    return flat


def _krum_cases():
    rs = np.random.RandomState(11)
    nan_row = _cluster_with_outlier()
    nan_row[7] = np.nan
    inf_row = _cluster_with_outlier()
    inf_row[7] = np.inf
    line = np.asarray([[0.0], [1.0], [2.0], [100.0]], np.float32)
    return {"outlier": _cluster_with_outlier(), "nan_row": nan_row,
            "inf_row": inf_row, "line": line,
            "random": rs.randn(6, 40).astype(np.float32),
            "ties": np.asarray([[0.0], [1.0], [0.0], [1.0], [5.0]], np.float32)}


@pytest.mark.parametrize("case", sorted(_krum_cases()))
def test_krum_family_matches_jax(case):
    flat = _krum_cases()[case]
    tf, jf = torch.tensor(flat), jnp.asarray(flat)
    for nb in (0, 1):
        got = robust.krum_scores_flat(tf, nb).numpy()
        want = np.asarray(jrobust.krum_scores_flat(jf, nb))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert int(robust.krum_select_flat(tf, nb)) == \
            int(jrobust.krum_select_flat(jf, nb))
        for m in (1, 2, 3):
            np.testing.assert_array_equal(
                robust.multi_krum_select_flat(tf, nb, m).numpy(),
                np.asarray(jrobust.multi_krum_select_flat(jf, nb, m)))
    if case in ("outlier", "nan_row", "inf_row"):
        assert int(robust.krum_select_flat(tf, 1)) != 7
        assert 7 not in set(robust.multi_krum_select_flat(tf, 1, 4).tolist())
    if case == "nan_row":
        assert np.isinf(robust.krum_scores_flat(tf, 1)[7].item())


def test_krum_on_a_stacked_dict_matches_jax():
    st = _stacked(12, 6)
    st["dense"][2] += 30.0
    assert int(robust.krum_select(_t(st), 1)) == \
        int(jrobust.krum_select(_j(st), 1))
    np.testing.assert_array_equal(
        robust.multi_krum_select(_t(st), 1, 3).numpy(),
        np.asarray(jrobust.multi_krum_select(_j(st), 1, 3)))
    for K, nb, m in ((8, 1, None), (4, 3, None), (5, 0, 9), (5, 0, 0)):
        assert robust.default_multi_krum_m(K, nb, m) == \
            jrobust.default_multi_krum_m(K, nb, m)


@pytest.mark.parametrize("n", [4, 5, 6])
def test_median_and_trimmed_mean_match_jax(n):
    """Even counts average the middle pair (jnp.median; torch.median would
    take the lower one); NaN: the median is NaN where any value is, the
    trimmed mean sorts NaN last and trims it."""
    rs = np.random.RandomState(n)
    st = {"a": rs.randn(n, 3, 4).astype(np.float32),
          "b": rs.randn(n, 7).astype(np.float32)}
    st["b"][1, 2] = np.nan
    got_m, want_m = robust.coordinate_median(_t(st)), \
        jrobust.coordinate_median(_j(st))
    for trim in (1, 2, 5):
        got_t, want_t = robust.trimmed_mean(_t(st), trim), \
            jrobust.trimmed_mean(_j(st), trim)
        for k in st:
            np.testing.assert_allclose(got_t[k].numpy(), np.asarray(want_t[k]),
                                       rtol=1e-6, atol=1e-7)
    for k in st:
        np.testing.assert_allclose(got_m[k].numpy(), np.asarray(want_m[k]),
                                   rtol=1e-6, atol=1e-7)
    assert np.isnan(got_m["b"][2].item())
    pair = torch.tensor([[1.0], [2.0], [3.0], [4.0]])
    assert robust.median_axis0(pair).item() == 2.5


def test_weak_dp_noise_statistics_and_seeding():
    params = {"a": torch.zeros(200, 100), "b": torch.ones(5000)}
    noised = robust.add_weak_dp_noise(
        params, torch.Generator().manual_seed(0), 0.05)
    assert not params["a"].any() and (params["b"] == 1).all()  # not mutated
    delta = torch.cat([noised["a"].reshape(-1), noised["b"] - 1])
    assert abs(delta.mean().item()) < 0.05 * 4 / np.sqrt(delta.numel())
    assert delta.std().item() == pytest.approx(0.05, rel=0.02)
    same = robust.add_weak_dp_noise(params, torch.Generator().manual_seed(0),
                                    0.05)
    other = robust.add_weak_dp_noise(params, torch.Generator().manual_seed(1),
                                     0.05)
    assert all(torch.equal(noised[k], same[k]) for k in params)
    assert not torch.equal(noised["a"], other["a"])


# ---------------------------------------------------------------------------
# two rounds of the robust engines against the JAX package
# ---------------------------------------------------------------------------

NF, HW, BS = 8, 16, 4
SIZES = (8, 4, 6, 12)            # 2, 1, 2, 3 non-empty batches of 4
NORM_BOUND = 2.0
LR = 0.1


def make_data(mod):
    """FederatedData of either package from the same numpy arrays."""
    rs = np.random.RandomState(0)
    n = sum(SIZES)
    x = rs.rand(n, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    ends = np.cumsum(SIZES)
    idx = {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(SIZES, ends))}
    ev = mod.build_eval_shard(x[:8], y[:8], BS)
    return mod.FederatedData(
        train_data_num=n, test_data_num=8, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, BS),
        client_num_samples=np.asarray(SIZES, np.float32),
        test_client_shards=None, class_num=10)


def make_cfg(cls, **kw):
    base = dict(model="resnet18_gn", dataset="cifar10",
                client_num_in_total=len(SIZES),
                client_num_per_round=len(SIZES), comm_round=2, epochs=1,
                batch_size=BS, lr=LR, frequency_of_the_test=100,
                norm_bound=NORM_BOUND)
    return cls(**{**base, **kw})


def jax_trainer(train_dtype=None, prox_mu=0.0):
    """(JAX ClientTrainer, the cohort's local training: (variables, cohort)
    -> (stacked, losses, ns)), built once per (train_dtype, prox_mu).

    Each client runs one epoch of the trainer's own train_step, jitted once
    and looped over the batches as the port loops them, with local_train's
    sample-weighted epoch loss.  (XLA compiles local_train's scan, and a
    vmap over clients, to other float orders than the step alone: at some
    weights one client's result then moves by up to 1e-3 inside JAX itself,
    where the port matches the stepped run to 1e-7.)"""
    return _jax_trainer(train_dtype, prox_mu)


@functools.lru_cache(maxsize=None)
def _jax_trainer(train_dtype, prox_mu):
    tr = JaxClientTrainer(JaxResNet18GN(num_classes=10, num_filters=NF),
                          lr=LR, train_dtype=train_dtype or jnp.float32,
                          prox_mu=prox_mu)
    step = jax.jit(tr.train_step)

    def one(variables, shard):
        g = variables["params"] if prox_mu > 0 else None
        state = TrainState(variables=variables, opt_state=tr.init_opt(variables),
                           rng=jax.random.PRNGKey(0))
        losses, counts = [], []
        for b in range(shard["mask"].shape[0]):
            batch = jax.tree.map(lambda a: a[b], shard)
            state, loss = step(state, batch, g)
            losses.append(loss)
            counts.append(jnp.sum(batch["mask"]))
        losses, counts = jnp.stack(losses), jnp.stack(counts)
        return (state.variables,
                jnp.sum(losses * counts) / jnp.maximum(jnp.sum(counts), 1.0),
                jnp.sum(shard["mask"]))

    def train(variables, cohort):
        out = [one(variables, jax.tree.map(lambda a: a[i], cohort))
               for i in range(cohort["mask"].shape[0])]
        return jax.tree.map(lambda *xs: jnp.stack(xs), *out)
    return tr, train


@functools.lru_cache(maxsize=None)
def jax_init():
    tr, _ = jax_trainer()
    sample = jnp.asarray(make_data(jfed).client_shards["x"][0, 0])
    return jax.tree.map(np.asarray, tr.init(jax.random.PRNGKey(0), sample))


def jax_cohort():
    return jax.tree.map(jnp.asarray, make_data(jfed).client_shards)


def port_trainer(local_dtype=None, prox_mu=0.0):
    return ClientTrainer(create_model("resnet18_gn", 10, num_filters=NF),
                         lr=LR, train_dtype=local_dtype or torch.float32,
                         prox_mu=prox_mu)


def leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def flat(tree):
    return np.concatenate([a.ravel() for a in leaves(tree)])


def assert_f32_close(got, want):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def jax_chain(round_fn, rounds: int) -> list:
    """JAX's own run: [(model after round r, train loss of round r)]."""
    v, out = jax_init(), []
    for r in range(rounds):
        v, loss = round_fn(v, r)
        out.append((jax.tree.map(np.asarray, v), float(loss)))
    return out


def port_rounds(eng, chain):
    """Round r of the port engine from JAX's model after round r-1 (the
    port's own server state carried across rounds), next to JAX's round r.

    Each round starts from JAX's model: this tiny model's training
    amplifies float differences of 1e-7 at some weights (a ReLU that flips
    moves its whole gradient), so over several rounds two runs of JAX
    itself, from inits one f32 ulp apart, drift apart by up to 5% of the
    update; started from the same model, the port's round matches JAX's to
    the f32 tolerance."""
    v = flax_to_torch(jax_init())
    state = eng.server_init(v)
    for r, (want, want_loss) in enumerate(chain):
        got, state, m = eng.round_fn(v, state, *eng._round_args(r))
        yield r, torch_to_flax(got), float(m["train_loss"]), want, want_loss
        v = flax_to_torch(want)


def assert_rounds_match(eng, chain):
    for r, got, loss, want, want_loss in port_rounds(eng, chain):
        assert_f32_close(got, want)
        assert loss == pytest.approx(want_loss, rel=1e-4), r


def _attack_jax(stacked):
    return jax.tree.map(lambda x: x.at[3].add(1.0), stacked)


def _attack_port(stacked):
    return {k: torch.cat([v[:3], v[3:] + 1.0]) for k, v in stacked.items()}


@functools.lru_cache(maxsize=None)
def jax_fedavg_robust(defense):
    """Two rounds of the JAX FedAvgRobustEngine: the cohort's training,
    then the engine's own aggregate (client 3 attacked)."""
    eng = JaxFedAvgRobustEngine(jax_trainer()[0], make_data(jfed),
                                make_cfg(JaxFedConfig), defense=defense,
                                n_byzantine=1, multi_krum_m=2,
                                attack_fn=_attack_jax, donate=False)
    _, train = jax_trainer()

    def round_fn(v, r):
        stacked, losses, ns = train(v, jax_cohort())
        v, _ = eng.aggregate(stacked, ns, v, (), jax.random.PRNGKey(r))
        return v, jnp.sum(losses * ns) / jnp.sum(ns)
    return jax_chain(round_fn, 2)


def _jax_mesh_orderstat(flats, defense, n_byzantine, m):
    """The order-statistic lines of the JAX MeshRobustEngine._shard_body
    (engine.py:1351-1364) on the replicated [K, P] matrix."""
    if defense == "krum":
        return flats[jrobust.krum_select_flat(flats, n_byzantine)]
    if defense == "multi_krum":
        idx = jrobust.multi_krum_select_flat(flats, n_byzantine, m)
        return jnp.mean(flats[idx], axis=0)
    if defense == "median":
        return jnp.median(flats, axis=0)
    n = flats.shape[0]
    k = min(max(n_byzantine, 1), (n - 1) // 2)
    return jnp.mean(jnp.sort(flats, axis=0)[k:n - k], axis=0)


@functools.lru_cache(maxsize=None)
def jax_mesh_robust_round(defense, bf16):
    """One round of the JAX MeshRobustEngine on a 1-device mesh, composed
    from its own methods: cast_local, the cohort's training, then
    client_transform + the f32 weighted fold + _finalize_from_sums +
    server_update (norm_clip), or the order statistics over the flattened
    params."""
    ld = jnp.bfloat16 if bf16 else None
    tr, train = jax_trainer(ld)
    eng = JaxMeshRobustEngine(tr, make_data(jfed), make_cfg(JaxFedConfig),
                              defense=defense, n_byzantine=0, multi_krum_m=2,
                              mesh=make_mesh(1), chunk=2, donate=False,
                              local_dtype=ld)
    w = jnp.asarray(SIZES, jnp.float32)

    def round_fn(v, r):
        local = cast_local(v, ld)
        stacked, losses, _ = train(local, jax_cohort())
        lsum, den = jnp.sum(losses * w), jnp.sum(w)
        if defense == "norm_clip":
            clipped = jax.vmap(eng.client_transform, in_axes=(0, 0, None))(
                stacked, w, local)
            avg, _ = eng._finalize_from_sums(
                v, (weighted_sum_tree(w, clipped), den, lsum))
            v, _ = eng.server_update(avg, v, (), jax.random.PRNGKey(r))
        else:
            flats, _ = jax_flatten(stacked["params"])
            new = _jax_mesh_orderstat(flats, defense, 0, eng.multi_krum_m)
            _, spec = jax_flatten(jax.tree.map(lambda a: a[None], v["params"]))
            v = {"params": jax_unflatten(new, spec)}
        return v, lsum / den
    return round_fn


@functools.lru_cache(maxsize=None)
def jax_mesh_robust(defense, bf16):
    return jax_chain(jax_mesh_robust_round(defense, bf16), 2)


def test_the_norm_bound_clips_some_clients_and_not_others():
    """The engine cases below exercise both sides of the clip: at round 1
    some client updates exceed NORM_BOUND and some do not."""
    stacked, _, _ = jax_trainer()[1](jax_init(), jax_cohort())
    d = jax.vmap(lambda p: jpytree.tree_l2_norm(
        jpytree.tree_sub(p, jax_init()["params"])))(stacked["params"])
    d = np.asarray(d)
    assert (d > NORM_BOUND).any() and (d < NORM_BOUND).any(), d


@pytest.mark.parametrize("defense", DEFENSES)
def test_fedavg_robust_two_rounds_match_jax(defense):
    eng = FedAvgRobustEngine(port_trainer(), make_data(tfed),
                             make_cfg(FedConfig), defense=defense,
                             n_byzantine=1, multi_krum_m=2,
                             attack_fn=_attack_port, device="cpu")
    assert_rounds_match(eng, jax_fedavg_robust(defense))


@pytest.mark.parametrize("defense", DEFENSES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_masters"])
def test_mesh_robust_two_rounds_match_jax(defense, bf16):
    """bf16 local masters: each round's distance to JAX's bf16 round is
    within 2x of the distance between JAX's bf16 and f32 rounds from the
    same model (the noise bf16 rounding itself makes)."""
    ld = torch.bfloat16 if bf16 else None
    eng = MeshRobustEngine(port_trainer(ld), make_data(tfed),
                           make_cfg(FedConfig), defense=defense,
                           n_byzantine=0, multi_krum_m=2, chunk=2,
                           local_dtype=ld, device="cpu")
    chain = jax_mesh_robust(defense, bf16)
    if not bf16:
        assert_rounds_match(eng, chain)
        return
    f32_round = jax_mesh_robust_round(defense, False)
    starts = [jax_init()] + [v for v, _ in chain[:-1]]
    for (r, got, _, want, _), start in zip(port_rounds(eng, chain), starts):
        want_f32 = f32_round(start, r)[0]
        noise = np.linalg.norm(flat(want) - flat(want_f32))
        assert noise < np.linalg.norm(flat(want_f32) - flat(start))
        assert np.linalg.norm(flat(got) - flat(want)) <= 2 * noise, r


def test_weak_dp_noise_rides_the_norm_clip_server_update():
    """stddev > 0: the noise is the only difference from the noiseless
    round, its spread is stddev, and the engine's seed fixes it."""
    runs = []
    for stddev, seed in ((0.0, 0), (0.01, 0), (0.01, 0), (0.01, 1)):
        eng = MeshRobustEngine(port_trainer(), make_data(tfed),
                               make_cfg(FedConfig, stddev=stddev, seed=seed),
                               chunk=2, device="cpu")
        v0 = flax_to_torch(jax_init())
        runs.append(eng.round_fn_streaming(
            v0, eng.server_init(v0), *eng.stream_cohort(0))[0])
    base, noised, again, other = runs
    delta = torch.cat([(noised[k] - base[k]).reshape(-1) for k in base])
    assert delta.std().item() == pytest.approx(0.01, rel=0.05)
    assert all(torch.equal(noised[k], again[k]) for k in base)
    assert not all(torch.equal(noised[k], other[k]) for k in base)


def test_mesh_robust_refuses_what_it_does_not_port():
    with pytest.raises(ValueError, match="unknown defense"):
        MeshRobustEngine(port_trainer(), make_data(tfed), make_cfg(FedConfig),
                         defense="bulyan", device="cpu")
    with pytest.raises(NotImplementedError, match="slice 6"):
        MeshRobustEngine(port_trainer(), make_data(tfed), make_cfg(FedConfig),
                         defense="median", stream_block=2, device="cpu")


def test_evaluate_backdoor_matches_jax():
    ev = make_data(tfed).test_global
    jeng = JaxFedAvgRobustEngine(jax_trainer()[0], make_data(jfed),
                                 make_cfg(JaxFedConfig), donate=False)
    teng = FedAvgRobustEngine(port_trainer(), make_data(tfed),
                              make_cfg(FedConfig), device="cpu")
    want = jeng.evaluate_backdoor(jax_init(), ev)
    got = teng.evaluate_backdoor(flax_to_torch(jax_init()), ev)
    assert got["backdoor_acc"] == want["backdoor_acc"]
    assert got["backdoor_loss"] == pytest.approx(want["backdoor_loss"],
                                                 rel=1e-5)
