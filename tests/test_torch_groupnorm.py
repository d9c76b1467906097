"""GroupNorm in the PyTorch port against the JAX package.

The port's ``group_norm`` runs its plain PyTorch version on CPU tensors;
the JAX side is fedml_tpu.ops.group_norm on the CPU, where it takes its
reference path and custom VJP (the Pallas kernels compile only on a TPU),
and flax ``nn.GroupNorm``.  The CUDA kernels are held against the same
plain versions on the card by chip_smoke.py.

Tolerances: f32 atol 1e-5 / rtol 1e-4 (two-pass vs one-pass variance and
summation order differ by a few ulps); bf16 atol 0.04 (one bf16 ulp of the
output is 2^-8 relative, and the two sides round the input's statistics at
different points).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.groupnorm import group_norm as jax_group_norm
from fedml_tpu_torch.ops import build
from fedml_tpu_torch.ops.groupnorm import (GroupNorm, gn_backward,
                                           gn_backward_plain, gn_forward,
                                           group_norm)


def _inputs(seed, shape=(4, 6, 6, 16)):
    rs = np.random.RandomState(seed)
    C = shape[-1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    gamma = rs.rand(C).astype(np.float32) + 0.5
    beta = rs.randn(C).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, dy


def _torch_value_and_grads(x, gamma, beta, dy, G, eps, dtype=torch.float32):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    gt = torch.tensor(gamma, requires_grad=True)
    bt = torch.tensor(beta, requires_grad=True)
    y = group_norm(xt, gt, bt, G, eps)
    y.backward(torch.tensor(dy, dtype=dtype))
    return [t.detach().float().numpy() for t in (y, xt.grad, gt.grad, bt.grad)]


def _jax_value_and_grads(fn, x, gamma, beta, dy, dtype=jnp.float32):
    y, vjp = jax.vjp(fn, jnp.asarray(x, dtype), jnp.asarray(gamma),
                     jnp.asarray(beta))
    grads = vjp(jnp.asarray(dy, dtype))
    return [np.asarray(t, np.float32) for t in (y, *grads)]


@pytest.mark.parametrize("G", [2, 4])
def test_value_and_grads_match_jax_group_norm(G):
    x, gamma, beta, dy = _inputs(G)
    want = _jax_value_and_grads(
        lambda a, g, b: jax_group_norm(a, g, b, G, 1e-5), x, gamma, beta, dy)
    got = _torch_value_and_grads(x, gamma, beta, dy, G, 1e-5)
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("G", [2, 4])
def test_value_and_grads_match_flax_groupnorm(G):
    x, gamma, beta, dy = _inputs(10 + G, shape=(3, 5, 4, 8))
    mod = nn.GroupNorm(num_groups=G, epsilon=1e-6)
    want = _jax_value_and_grads(
        lambda a, g, b: mod.apply({"params": {"scale": g, "bias": b}}, a),
        x, gamma, beta, dy)
    got = _torch_value_and_grads(x, gamma, beta, dy, G, 1e-6)
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_matches_jax_in_bf16():
    x, gamma, beta, dy = _inputs(7, shape=(4, 4, 4, 32))
    want = _jax_value_and_grads(
        lambda a, g, b: jax_group_norm(a, g, b, 2, 1e-6), x, gamma, beta, dy,
        dtype=jnp.bfloat16)
    got = _torch_value_and_grads(x, gamma, beta, dy, 2, 1e-6,
                                 dtype=torch.bfloat16)
    # y and dx are bf16 [O(1)] values; dgamma/dbeta sum 64 bf16 products
    for name, a, b, tol in zip(("y", "dx", "dgamma", "dbeta"), got, want,
                               (0.04, 0.04, 0.25, 0.25)):
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)


def test_saved_stats_are_two_pass_f32():
    """gn_forward's mean/rstd are what gn_backward consumes: [N, G] f32."""
    x, gamma, beta, dy = _inputs(3, shape=(2, 3, 3, 8))
    xt = torch.tensor(x, dtype=torch.bfloat16)
    y, mean, rstd = gn_forward(xt, torch.tensor(gamma), torch.tensor(beta),
                               4, 1e-5)
    assert y.dtype == torch.bfloat16 and y.shape == xt.shape
    assert mean.shape == rstd.shape == (2, 4) and mean.dtype == torch.float32
    xg = xt.float().reshape(2, -1, 4, 2)
    np.testing.assert_allclose(mean.numpy(), xg.mean(dim=(1, 3)).numpy(),
                               rtol=1e-6, atol=1e-6)
    dx, dg, db = gn_backward(xt, torch.tensor(dy, dtype=torch.bfloat16),
                             torch.tensor(gamma), mean, rstd, 4)
    assert dx.dtype == torch.bfloat16 and dg.dtype == db.dtype == torch.float32


def test_module_params_match_flax_names():
    mod = GroupNorm(16, num_groups=4)
    assert [n for n, _ in mod.named_parameters()] == ["scale", "bias"]
    assert mod.scale.shape == mod.bias.shape == (16,)
    flax_vars = nn.GroupNorm(num_groups=4).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 2, 2, 16)))
    assert sorted(flax_vars["params"]) == ["bias", "scale"]


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="no kernel or plain path"):
        build.on_card(torch.empty(1, device="meta"))


def test_vector_width_respects_alignment_and_run():
    assert build.vector_width(2, 32, 0, 64) == 8       # bf16, 16-byte loads
    assert build.vector_width(4, 32, 0, 64) == 4       # f32, 16-byte loads
    assert build.vector_width(2, 12, 0, 64) == 4       # 12 channels: 4 | 12
    assert build.vector_width(2, 32, 0, 6) == 1        # misaligned pointer
    assert build.vector_width(2, 3, 0) == 1


def test_plain_backward_matches_autograd_of_plain_forward():
    """The hand-derived backward equals autograd through the forward."""
    x, gamma, beta, dy = _inputs(5, shape=(2, 4, 4, 8))
    xt, gt, bt = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (x, gamma, beta))
    N, C = 2, 8
    xg = xt.reshape(N, -1, 2, 4)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(xt.shape) * gt + bt
    y.backward(torch.tensor(dy, dtype=torch.float64))
    _, m, r = gn_forward(xt.detach(), gt.detach(), bt.detach(), 2, 1e-5)
    dx, dg, db = gn_backward_plain(xt.detach(), torch.tensor(dy, dtype=torch.float64),
                                   gt.detach(), m.double(), r.double(), 2)
    for a, b in ((dx, xt.grad), (dg, gt.grad), (db, bt.grad)):
        np.testing.assert_allclose(a.double().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_kernel_argument_checks_raise():
    """What the CUDA wrappers validate before they hand pointers over."""
    import fedml_tpu_torch.ops.groupnorm as gn
    x = torch.zeros(2, 3, 3, 8)
    assert gn._check(x, 2) == (2, 9, 8)
    with pytest.raises(ValueError, match="gamma"):
        gn._check_side(x, (8,), gamma=torch.zeros(4))
    with pytest.raises(ValueError, match="mean"):
        gn._check_side(x, (2, 2), mean=torch.zeros(2, 2, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        gn._check(x.transpose(1, 2), 2)
    with pytest.raises(ValueError, match="divisible"):
        gn._check(x, 3)
    with pytest.raises(ValueError, match="differ"):
        gn._check(x, 2, torch.zeros(2, 3, 3, 4))
    with pytest.raises(TypeError):
        gn._check(x.half(), 2)
