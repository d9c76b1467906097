"""The weighted client fold and the pytree helpers of the PyTorch port
against the JAX package.

The JAX side of the finalize form is ``weighted_mean_pallas(...,
interpret=True)`` (its Pallas kernel in interpret mode, as the JAX tests
run it on the CPU); the accumulate form is held against the mesh engine's
``weighted_acc`` step.  Tolerance for float sums: rtol 1e-6 / atol 1e-6
(f32 sums over a few clients, taken in another order); the flattening is
exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core import pytree as jpytree
from fedml_tpu.ops.aggregate import (flatten_stacked_tree as jax_flatten,
                                     unflatten_to_tree as jax_unflatten,
                                     weighted_mean_pallas)
from fedml_tpu.parallel.engine import weighted_acc
from fedml_tpu_torch.core import pytree
from fedml_tpu_torch.ops import aggregate
from fedml_tpu_torch.ops.aggregate import (TILE, flatten_stacked_tree, fold,
                                           unflatten_to_tree, weighted_mean,
                                           weighted_mean_flat)

SHAPES = {"conv": (3, 3, 2, 4), "scale": (4,), "dense": (5, 3)}


def _stacked(seed, C=5):
    rs = np.random.RandomState(seed)
    return {k: rs.randn(C, *s).astype(np.float32) for k, s in SHAPES.items()}


def _weights(seed, C=5):
    return np.random.RandomState(seed).randint(1, 400, C).astype(np.float32)


def test_flatten_matches_jax_layout_bitwise():
    st = _stacked(0)
    flat, spec = flatten_stacked_tree({k: torch.tensor(v) for k, v in st.items()})
    # the JAX package flattens in sorted-key order (jax.tree.leaves)
    jflat, jspec = jax_flatten({k: jnp.asarray(st[k]) for k in SHAPES})
    order = sorted(SHAPES)
    n = spec.n
    assert flat.shape[1] % TILE == 0 and flat.shape == np.asarray(jflat).shape
    offs = dict(zip(spec.names, np.cumsum([0] + spec.sizes)[:-1]))
    joff = 0
    for k in order:
        size = int(np.prod(SHAPES[k]))
        np.testing.assert_array_equal(
            flat[:, offs[k]:offs[k] + size].numpy(),
            np.asarray(jflat)[:, joff:joff + size])
        joff += size
    assert not flat[:, n:].any()
    back = unflatten_to_tree(flat[2], spec)
    jback = jax_unflatten(jflat[2], jspec)
    for k, v in st.items():
        np.testing.assert_array_equal(back[k].numpy(), v[2])
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
        assert back[k].dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_mean_matches_pallas_interpret(seed):
    st, w = _stacked(seed), _weights(seed)
    got = weighted_mean({k: torch.tensor(v) for k, v in st.items()},
                        torch.tensor(w))
    want = weighted_mean_pallas({k: jnp.asarray(v) for k, v in st.items()},
                                jnp.asarray(w), interpret=True)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_accumulate_matches_weighted_acc(dtype):
    rs = np.random.RandomState(3)
    acc0 = rs.randn(2 * TILE).astype(np.float32)
    V = torch.tensor(rs.randn(2, 2 * TILE), dtype=dtype)
    w = rs.randint(1, 400, 2).astype(np.float32)
    acc = torch.tensor(acc0)
    fold(acc, V, torch.tensor(w))
    jv = jnp.asarray(V.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    want = weighted_acc(jnp.asarray(w))(jnp.asarray(acc0), jv)
    np.testing.assert_allclose(acc.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)


def test_fold_accumulates_across_chunks_like_one_mean():
    """Two chunk folds then one divide == the finalize form over all rows."""
    rs = np.random.RandomState(4)
    V = torch.tensor(rs.randn(4, TILE), dtype=torch.float32)
    w = torch.tensor(_weights(4, 4))
    acc = torch.zeros(TILE)
    fold(acc, V[:2], w[:2].contiguous())
    fold(acc, V[2:], w[2:].contiguous())
    np.testing.assert_allclose((acc / w.sum()).numpy(),
                               weighted_mean_flat(V, w).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_finalize_guards_zero_weight_sum():
    out = weighted_mean_flat(torch.ones(3, TILE), torch.zeros(3))
    assert torch.isfinite(out).all() and not out.any()


def test_wsum_rejects_what_the_kernel_does_not_take():
    V = torch.zeros(2, TILE)
    with pytest.raises(ValueError, match="accumulator"):
        aggregate.wsum(torch.zeros(TILE, dtype=torch.float64), V,
                       torch.ones(2), finalize=False)
    with pytest.raises(ValueError, match="row-major"):
        aggregate.wsum(torch.zeros(2), V.t(), torch.ones(TILE), finalize=False)
    with pytest.raises(TypeError):
        aggregate.wsum(torch.zeros(TILE), V.half(), torch.ones(2),
                       finalize=False)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_weighted_mean_matches_jax(seed):
    st, w = _stacked(seed), _weights(seed)
    got = pytree.tree_weighted_mean({k: torch.tensor(v) for k, v in st.items()},
                                    torch.tensor(w))
    want = jpytree.tree_weighted_mean({k: jnp.asarray(v) for k, v in st.items()},
                                      jnp.asarray(w))
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sq,bound", [(0.0, 1.0), (4.0, 1.0), (0.25, 1.0),
                                      (1e-30, 5.0)])
def test_clip_scale_matches_jax(sq, bound):
    got = float(pytree.clip_scale(sq, bound))
    want = float(jpytree.clip_scale(sq, bound))
    assert got == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("pred", [True, False])
def test_tree_select_matches_jax(pred):
    a, b = _stacked(5, 2), _stacked(6, 2)
    got = pytree.tree_select(torch.tensor(pred),
                             {k: torch.tensor(v) for k, v in a.items()},
                             {k: torch.tensor(v) for k, v in b.items()})
    want = jpytree.tree_select(jnp.asarray(pred), a, b)
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_unflatten_split_backward_is_one_flat_gradient():
    """Views from unflatten_to_tree carry autograd back into the flat row."""
    spec = aggregate.spec_of({k: torch.zeros(s) for k, s in SHAPES.items()})
    flat = torch.randn(spec.padded, requires_grad=True)
    leaves = unflatten_to_tree(flat, spec)
    sum(v.sum() * (i + 1) for i, v in enumerate(leaves.values())).backward()
    want = torch.cat([torch.full((s,), float(i + 1))
                      for i, s in enumerate(spec.sizes)]
                     + [torch.zeros(spec.padded - spec.n)])
    np.testing.assert_array_equal(flat.grad.numpy(), want.numpy())
