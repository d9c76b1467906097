"""GroupNorm in the PyTorch port against the JAX package.

The port's ``group_norm`` runs its plain PyTorch version on CPU tensors;
the JAX side is fedml_tpu.ops.group_norm on the CPU, where it takes its
reference path and custom VJP (the Pallas kernels compile only on a TPU),
and flax ``nn.GroupNorm``.  The CUDA kernels are held against the same
plain versions on the card by chip_smoke.py.

Tolerances: f32 atol 1e-5 / rtol 1e-4 (two-pass vs one-pass variance and
summation order differ by a few ulps); bf16 atol 0.04 (one bf16 ulp of the
output is 2^-8 relative, and the two sides round the input's statistics at
different points); dgamma/dbeta in bf16 (they come out in gamma's dtype,
rounded once from f32 sums taken in another order): one bf16 ulp, rtol
2^-7, plus 1e-5 of the largest |value|.

The launch plan of the kernels is pure Python and is checked here: which
block and thread of the grid owns each element, the cluster size, the
shared memory and the grid at the main path's shapes.
"""
import ctypes
import math

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
                                           group_norm, launch_plan)

STAGES = ((32, 32, 32, 64), (32, 16, 16, 128), (32, 8, 8, 256),
          (32, 4, 4, 512))       # the main path's four GroupNorm shapes
H100_SMS, SMEM_LIMIT = 132, 227 * 1024


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


def _owners(plan, N, S, C, G) -> np.ndarray:
    """How many (block, thread) pairs of the plan's grid touch each element
    of [N, S, C], by the index math of csrc/groupnorm.cu: block b is rank
    b % K of cluster b // K = (n, g); rank r owns rows [r * rows, (r + 1) *
    rows) below S; thread t owns the vec channels at column t % vpr of rows
    t // vpr + k * rpp, rpp = threads // vpr."""
    Cg = C // G
    vpr = Cg // plan.vec
    rpp = plan.threads // vpr
    b = np.arange(plan.blocks)[:, None, None]
    t = np.arange(plan.threads)[None, :, None]
    k = np.arange(-(-plan.rows // rpp))[None, None, :]
    n, g, rank = b // plan.K // G, b // plan.K % G, b % plan.K
    r = rank * plan.rows + t // vpr + k * rpp
    ok = (t < rpp * vpr) & (r < np.minimum(S, (rank + 1) * plan.rows))
    first = ((n * S + r) * C + g * Cg + t % vpr * plan.vec)
    first = np.broadcast_to(first, ok.shape)[ok]
    idx = (first[:, None] + np.arange(plan.vec)[None, :]).ravel()
    return np.bincount(idx, minlength=N * S * C)


PLAN_CASES = ([(shape, 2, dt, bw) for shape in STAGES
               for dt in (torch.bfloat16, torch.float32)
               for bw in (False, True)]
              + [((4, 6, 6, 16), G, torch.float32, bw) for G in (2, 4)
                 for bw in (False, True)]
              + [((2, 7, 7, 24), 2, torch.bfloat16, bw) for bw in (False, True)]
              + [((1, 64, 64, 64), 1, torch.float32, True)])


@pytest.mark.parametrize("shape,G,dtype,backward", PLAN_CASES)
def test_launch_plan_owns_every_element_once(shape, G, dtype, backward):
    N, C = shape[0], shape[-1]
    S = math.prod(shape[1:-1])
    plan = launch_plan(N, S, C, G, dtype, backward=backward)
    assert 1 <= plan.K <= 8 and plan.blocks % plan.K == 0
    assert plan.clusters == N * G
    assert (plan.K - 1) * plan.rows < S <= plan.K * plan.rows  # no idle block
    assert plan.threads % 32 == 0 and plan.threads <= 512
    assert plan.smem <= SMEM_LIMIT
    np.testing.assert_array_equal(_owners(plan, N, S, C, G), 1)
    if shape in STAGES:            # the main path: fills the card, on chip
        assert plan.blocks >= H100_SMS and plan.resident
    if shape == (1, 64, 64, 64):   # a slice too large even for 8 blocks
        assert not plan.resident and plan.K == 8


def test_launch_plan_sizes_shared_memory_by_variant():
    """Resident: the slice of x (and dy) in smem; the backward adds its
    per-row and per-block channel partials; streaming holds no slice."""
    fwd = launch_plan(32, 1024, 64, 2, torch.bfloat16, backward=False)
    bwd = launch_plan(32, 1024, 64, 2, torch.bfloat16, backward=True)
    assert (fwd.K, fwd.rows, fwd.vec, fwd.threads) == (4, 256, 8, 128)
    assert fwd.smem == 256 * 32 * 2
    rpp = bwd.threads // (32 // 8)
    assert bwd.smem == 2 * 256 * 32 * 2 + 2 * rpp * 32 * 4 + 2 * 32 * 4
    big = launch_plan(2, 224 * 224, 64, 2, torch.bfloat16, backward=False)
    assert not big.resident and big.smem == 0
    with pytest.raises(ValueError, match="threads"):
        launch_plan(1, 4, 8192, 1, torch.float32, backward=False)


@pytest.mark.parametrize("x_dtype,g_dtype", [
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_dgamma_dbeta_come_back_in_gammas_dtype_as_in_jax(x_dtype, g_dtype):
    """dgamma and dbeta in gamma's dtype, rounded once, as the JAX custom
    VJP returns them; y and dx in x's dtype."""
    x, gamma, beta, dy = _inputs(21, shape=(3, 4, 4, 16))
    to_jax = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    jg = jnp.asarray(gamma).astype(to_jax[g_dtype])
    jb = jnp.asarray(beta).astype(to_jax[g_dtype])
    y, vjp = jax.vjp(lambda a, g, b: jax_group_norm(a, g, b, 2, 1e-6),
                     jnp.asarray(x, to_jax[x_dtype]), jg, jb)
    want = [y, *vjp(jnp.asarray(dy, to_jax[x_dtype]))]
    xt = torch.tensor(x).to(x_dtype).requires_grad_()
    gt = torch.tensor(np.asarray(jg, np.float32)).to(g_dtype).requires_grad_()
    bt = torch.tensor(np.asarray(jb, np.float32)).to(g_dtype).requires_grad_()
    got = [group_norm(xt, gt, bt, 2, 1e-6)]
    got += list(torch.autograd.grad(got[0], (xt, gt, bt),
                                    torch.tensor(dy).to(x_dtype)))
    assert [t.dtype for t in got] == [x_dtype, x_dtype, g_dtype, g_dtype]
    assert [w.dtype for w in want[2:]] == [to_jax[g_dtype]] * 2
    out_tol = (dict(rtol=1e-4, atol=1e-5) if x_dtype == torch.float32
               else dict(rtol=0, atol=0.04))
    for name, a, b in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        a, b = a.detach().float().numpy(), np.asarray(b, np.float32)
        if name in ("y", "dx"):
            np.testing.assert_allclose(a, b, err_msg=name, **out_tol)
        elif g_dtype == torch.bfloat16:
            np.testing.assert_allclose(a, b, rtol=2 ** -7,
                                       atol=1e-5 * np.abs(b).max(), err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_param_dtype_checks_raise():
    """gamma/beta in a dtype the kernels do not take, or two dtypes."""
    import fedml_tpu_torch.ops.groupnorm as gn
    gn._check_params(torch.zeros(8, dtype=torch.bfloat16),
                     torch.zeros(8, dtype=torch.bfloat16))
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16 gamma"):
            gn._check_params(torch.zeros(8, dtype=bad))
    with pytest.raises(TypeError, match="share a dtype"):
        gn._check_params(torch.zeros(8), torch.zeros(8, dtype=torch.bfloat16))


class _FakeCard:
    """Stands in for the kernel library and CUDA's device context: records
    each C call after converting its arguments with the entry's declared
    ctypes argtypes, as ctypes does for the real library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            argtypes = build.SIGNATURES[name]
            assert len(args) == len(argtypes), (name, len(args), len(argtypes))
            self.calls.append((name, [t(a).value for t, a in zip(argtypes, args)]))
            return 0
        return call


def test_wrappers_pass_the_plan_and_param_dtype_to_the_c_entries(monkeypatch):
    """The wrappers' calls match SIGNATURES, carry gamma's own dtype code
    and the launch plan, count one launch each, and allocate dgamma/dbeta
    in gamma's dtype with no cast of gamma or beta."""
    import contextlib
    import fedml_tpu_torch.ops.groupnorm as gn
    card = _FakeCard()
    monkeypatch.setattr(gn, "on_card", lambda t: True)
    monkeypatch.setattr(build, "library", lambda: card)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(gn, "_FINISH_COUNTERS", {})
    x = torch.zeros(2, 4, 4, 16, dtype=torch.bfloat16)
    g = torch.ones(16, dtype=torch.bfloat16)
    b = torch.zeros(16, dtype=torch.bfloat16)
    f0, b0 = gn_forward.launches, gn_backward.launches
    _, mean, rstd = gn_forward(x, g, b, 2, 1e-6)
    _, dg, db = gn_backward(x, x, g, mean, rstd, 2)
    assert (gn_forward.launches - f0, gn_backward.launches - b0) == (1, 1)
    assert dg.dtype == db.dtype == torch.bfloat16
    (fname, fargs), (bname, bargs) = card.calls
    assert (fname, bname) == ("fedml_gn_fwd", "fedml_gn_bwd")
    plan_f = launch_plan(2, 16, 16, 2, torch.bfloat16, backward=False)
    plan_b = launch_plan(2, 16, 16, 2, torch.bfloat16, backward=True)
    assert fargs[6:10] == [2, 16, 16, 2] and fargs[11:13] == [1, 1]
    assert fargs[13:19] == [plan_f.vec, plan_f.K, plan_f.threads, plan_f.rows,
                            plan_f.smem, int(plan_f.resident)]
    assert fargs[1] == g.data_ptr() and fargs[2] == b.data_ptr()
    assert bargs[10:16] == [2, 16, 16, 2, 1, 1]
    assert bargs[16:22] == [plan_b.vec, plan_b.K, plan_b.threads, plan_b.rows,
                            plan_b.smem, int(plan_b.resident)]
    assert bargs[2] == g.data_ptr() and bargs[6] == dg.data_ptr()
    assert bargs[9] == gn._FINISH_COUNTERS[x.device].data_ptr()
