"""The DARTS search space of the PyTorch port against the JAX package's
(fedml_tpu/models/darts.py), in f64 (``jax.enable_x64``: flax's f32
GroupNorm takes the fast variance, the port the two-pass one).

* every primitive at stride 1 and 2, at 8x8 and at odd 7x7 (where XLA's
  SAME padding is asymmetric and FactorizedReduce pads its offset path),
  forward and the gradients of its parameters, within 1e-9;
* ``DartsSearchNetwork`` (micro: C 4, steps 2) and ``DartsNetwork``
  (DARTS_V2, C 4) forward from JAX's converted params, within 1e-9;
* ``derive_genotype`` exactly; ``st_gumbel_softmax`` given JAX's
  uniforms; the parameter counts at full width; ``create_model("darts")``.

The JAX references are jitted once per module (module-scoped fixtures).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from fedml_tpu.models import darts as jd
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models import create_model, init_params
from fedml_tpu_torch.models import darts as td

torch.set_num_threads(2)
C, N = 4, 2
OPS = td.PRIMITIVES[1:]                 # "none" holds nothing to compare
TOL = dict(rtol=1e-9, atol=1e-9)


class _AllPrimitives(fnn.Module):
    """Every primitive but "none" on the same input, as _FixedOp_0..6."""
    stride: int

    @fnn.compact
    def __call__(self, x):
        return tuple(jd._FixedOp(op, C, self.stride)(x) for op in OPS)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture(scope="module", params=[(1, 8), (1, 7), (2, 8), (2, 7)],
                ids=lambda p: f"s{p[0]}-{p[1]}x{p[1]}")
def primitives_ref(request):
    """JAX's outputs and parameter gradients of sum_i sum(sin(out_i)) for
    one (stride, size)."""
    stride, hw = request.param
    x = np.random.RandomState(hw).standard_normal((N, hw, hw, C))
    holder = torch.nn.Module()
    for i, op in enumerate(OPS):
        holder.add_module(f"_FixedOp_{i}", td._FixedOp(op, C, stride))
    state = {k: v.double() for k, v in init_params(
        holder, torch.Generator().manual_seed(0)).items()}
    m = _AllPrimitives(stride)
    with jax.enable_x64(True):
        v = _f64(torch_to_flax(state))
        loss = lambda v, x: sum(jnp.sum(jnp.sin(o)) for o in m.apply(v, x))
        outs = jax.jit(m.apply)(v, jnp.asarray(x))
        grads = jax.jit(jax.grad(loss))(v, jnp.asarray(x))
    return stride, x, state, [np.asarray(o) for o in outs], \
        flax_to_torch(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("op", OPS)
def test_primitive_matches_flax_f64(primitives_ref, op):
    stride, x, state, outs, grads = primitives_ref
    i = OPS.index(op)
    prefix = f"_FixedOp_{i}."
    mine = {k[len(prefix):]: t.clone().requires_grad_()
            for k, t in state.items() if k.startswith(prefix)}
    module = td._FixedOp(op, C, stride).double()
    assert set(mine) == set(dict(module.named_parameters()))
    y = torch.func.functional_call(module, mine, (torch.tensor(x),))
    np.testing.assert_allclose(y.detach().numpy(), outs[i], **TOL)
    if mine:
        names = list(mine)
        got = torch.autograd.grad(y.sin().sum(), [mine[k] for k in names])
        for k, g in zip(names, got):
            np.testing.assert_allclose(g.numpy(), grads[prefix + k].numpy(),
                                       err_msg=k, **TOL)


def _alphas_np(steps, seed):
    with jax.enable_x64(True):
        a = jd.init_alphas(jax.random.PRNGKey(seed), steps=steps)
        # larger than the 1e-3 init, so the mix is far from uniform
        return {k: np.asarray(v, np.float64) * 300 for k, v in a.items()}


def _net_close(jax_model, torch_model, x, *extra):
    """Both models on the same f64 weights (the port's init, carried to
    flax by ``torch_to_flax``: flax's own init of the supernet takes tens
    of seconds here) and inputs; extra: numpy dicts (the alphas)."""
    state = {k: v.double() for k, v in init_params(
        torch_model, torch.Generator().manual_seed(1)).items()}
    with jax.enable_x64(True):
        extra_jax = [{k: jnp.asarray(v) for k, v in e.items()} for e in extra]
        v = _f64(torch_to_flax(state))
        want = np.asarray(jax.jit(jax_model.apply)(v, jnp.asarray(x),
                                                   *extra_jax))
    torch_model = torch_model.double()
    assert set(state) == set(dict(torch_model.named_parameters()))
    extra_torch = [{k: torch.tensor(v) for k, v in e.items()} for e in extra]
    got = torch.func.functional_call(torch_model, state,
                                     (torch.tensor(x), *extra_torch))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_search_network_matches_flax_f64():
    x = np.random.RandomState(0).rand(N, 8, 8, 3)
    a = _alphas_np(2, 0)
    _net_close(jd.DartsSearchNetwork(num_classes=10, C=C, layers=3, steps=2,
                                     multiplier=2),
               td.DartsSearchNetwork(10, C=C, layers=3, steps=2,
                                     multiplier=2), x, a)


def test_fixed_network_matches_flax_f64():
    x = np.random.RandomState(1).rand(N, 8, 8, 3)
    _net_close(jd.DartsNetwork(num_classes=10, genotype=jd.DARTS_V2, C=C,
                               layers=3),
               td.DartsNetwork(10, td.DARTS_V2, C=C, layers=3), x)


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("steps", [2, 4])
def test_derive_genotype_exact(seed, steps):
    with jax.enable_x64(False):
        a = jd.init_alphas(jax.random.PRNGKey(seed), steps=steps)
        a = {k: v * 1000.0 for k, v in a.items()}
        want = jd.derive_genotype(a, steps=steps, multiplier=steps)
    got = td.derive_genotype({k: torch.tensor(np.asarray(v)) for k, v in
                              a.items()}, steps=steps, multiplier=steps)
    assert got == td.Genotype(*want)


def test_st_gumbel_softmax_given_jax_uniforms():
    key = jax.random.PRNGKey(5)
    logits = np.random.RandomState(2).standard_normal((14, 8)).astype(
        np.float32)
    u = np.asarray(jax.random.uniform(key, (14, 8), minval=1e-20, maxval=1.0))
    want = np.asarray(jd.st_gumbel_softmax(jnp.asarray(logits), key, 0.7))
    w = np.random.RandomState(3).standard_normal((14, 8)).astype(np.float32)
    want_grad = np.asarray(jax.grad(lambda l: jnp.sum(
        jd.st_gumbel_softmax(l, key, 0.7) * w))(jnp.asarray(logits)))
    lt = torch.tensor(logits, requires_grad=True)
    got = td.st_gumbel_softmax(lt, torch.tensor(u), 0.7)
    assert np.array_equal(got.detach().numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-6)
    # the forward value is one-hot per edge
    assert torch.equal(got.detach().sum(-1), torch.ones(14))


def test_gumbel_uniform_range_and_generator():
    g = torch.Generator().manual_seed(0)
    u = td.gumbel_uniform((64, 8), g)
    assert u.shape == (64, 8) and float(u.min()) >= 1e-20 and float(u.max()) < 1
    assert torch.equal(u, td.gumbel_uniform((64, 8),
                                            torch.Generator().manual_seed(0)))


def test_parameter_counts_at_full_width():
    search = td.DartsSearchNetwork(10)
    assert sum(p.numel() for p in search.parameters()) == 1_987_194
    model = create_model("darts", 10)
    assert isinstance(model, td.DartsNetwork)
    assert sum(p.numel() for p in model.parameters()) == 3_349_342
    # 705 GroupNorm layers in the supernet, 239 in the retrain net, at the
    # (C, G) pairs the DARTS widths give
    gns = lambda m: [g for n, g in m.named_modules()
                     if n.rsplit(".", 1)[-1].startswith("GroupNorm")]
    assert len(gns(search)) == 705 and len(gns(model)) == 239
    assert {(g.scale.numel(), g.num_groups) for g in gns(search)} == {
        (48, 8), (16, 8), (32, 8), (64, 8)}
    assert {(g.scale.numel(), g.num_groups) for g in gns(model)} >= {
        (36, 4), (72, 8), (108, 4), (144, 8)}


def test_alphas_shape_and_scale():
    a = td.init_alphas(torch.Generator().manual_seed(0))
    assert a["normal"].shape == a["reduce"].shape == (td.num_edges(4), 8)
    assert float(a["normal"].abs().max()) < 1e-2
