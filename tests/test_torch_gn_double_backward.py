"""The GroupNorm op of the PyTorch port differentiated twice.

``group_norm``'s backward is an autograd function of its own whose
forward runs the backward kernel (its plain version here, with no graph,
as the kernel records none) and whose backward is the analytic double
backward (``gn_double_backward``).  Checked here on the CPU:

* ``torch.autograd.gradgradcheck`` in f64 on the composed op at group
  widths Cg 2, 9 and 27 (the DARTS nets' odd widths among them), and
  ``gradcheck`` of the double backward alone;
* the graph exists: the grad of a first-order grad is nonzero and equals
  the second derivative of ``F.group_norm`` (PyTorch's own op, a
  yardstick independent of the port's formula) within 1e-10 in f64;
* the plain backward inside the function records no graph;
* without ``create_graph`` the backward is the first-order path as
  before, bitwise (f32 and bf16);
* the plain versions keep f64 (they computed in f32 before) and give f32
  and bf16 results bitwise as the f32 computation did.
"""
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import groupnorm as gn
from fedml_tpu_torch.ops.groupnorm import group_norm

torch.set_num_threads(2)
EPS = 1e-6


def _inputs(C, G, dtype=torch.float64, shape=(2, 3, 3), seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, C, generator=g, dtype=torch.float64) * 2 + 0.5
    gamma = torch.rand(C, generator=g, dtype=torch.float64) + 0.5
    beta = torch.randn(C, generator=g, dtype=torch.float64)
    return [t.to(dtype).requires_grad_() for t in (x, gamma, beta)]


@pytest.mark.parametrize("cg", [2, 9, 27])
def test_gradgradcheck_composed_op_f64(cg):
    G = 2
    x, gamma, beta = _inputs(cg * G, G, shape=(2, 2, 2))
    f = lambda x, g, b: group_norm(x, g, b, G, EPS)
    assert torch.autograd.gradcheck(f, (x, gamma, beta))
    assert torch.autograd.gradgradcheck(f, (x, gamma, beta))


def test_gradcheck_double_backward_alone_f64():
    """The double backward is the derivative of the backward, the mean and
    rstd taken as functions of x."""
    G, C = 3, 9
    x, gamma, _ = _inputs(C, G)
    dy = torch.randn(x.shape, dtype=torch.float64, requires_grad=True)

    def backward(x, dy, gamma):
        # compute the statistics with a graph so that finite
        # differences see them move with x
        xg = x.reshape(x.shape[0], -1, G, C // G)
        mean = xg.mean(dim=(1, 3))
        var = ((xg - mean[:, None, :, None]) ** 2).mean(dim=(1, 3))
        rstd = torch.rsqrt(var + EPS)
        return gn._GroupNormBackwardFn.apply(x, dy, gamma, mean, rstd, G)

    # the Function's own backward ignores the statistics' graph and takes
    # their x-dependence into its formula; so compare it with autograd's
    # derivative of the backward built from torch ops instead
    ref = lambda x, dy, gamma: gn_backward_ops(x, dy, gamma, G)
    outs = backward(x, dy, gamma)
    refs = ref(x, dy, gamma)
    gouts = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, (x, dy, gamma), gouts)
    want = torch.autograd.grad(refs, (x, dy, gamma), gouts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
    assert torch.autograd.gradcheck(ref, (x, dy, gamma))


def gn_backward_ops(x, dy, gamma, G):
    """GroupNorm's first-order backward written in differentiable torch
    ops, the statistics recomputed from x."""
    N, C = x.shape[0], x.shape[-1]
    xg = x.reshape(N, -1, G, C // G)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (xg - mean) * rstd
    dyg = dy.reshape(xg.shape)
    a = dyg * gamma.reshape(1, 1, G, C // G)
    dx = rstd * (a - a.mean(dim=(1, 3), keepdim=True)
                 - xhat * (a * xhat).mean(dim=(1, 3), keepdim=True))
    return (dx.reshape(x.shape), (dyg * xhat).sum(dim=(0, 1)).reshape(C),
            dyg.sum(dim=(0, 1)).reshape(C))


@pytest.mark.parametrize("C,G", [(4, 2), (18, 2), (108, 4)])
def test_second_derivative_matches_torch_group_norm(C, G):
    x, gamma, beta = _inputs(C, G)
    w = torch.randn(x.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    ref = lambda x, g, b: F.group_norm(x.permute(0, 3, 1, 2), G, g, b,
                                       EPS).permute(0, 2, 3, 1)
    results = []
    for fn in (lambda x, g, b: group_norm(x, g, b, G, EPS), ref):
        y = fn(x, gamma, beta)
        gx, gg = torch.autograd.grad((y * w).sum(), (x, gamma),
                                     create_graph=True)
        second = torch.autograd.grad(gx.sin().sum() + gg.square().sum(),
                                     (x, gamma), allow_unused=True)
        results.append(second)
    for a, b in zip(*results):
        assert float(a.abs().max()) > 0.0
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_backward_kernel_records_no_graph(monkeypatch):
    """Inside the backward function the plain version sees no grad mode,
    as the kernel would record nothing."""
    seen = []
    plain = gn.gn_backward_plain

    def spy(*args):
        seen.append(torch.is_grad_enabled())
        return plain(*args)
    monkeypatch.setattr(gn, "gn_backward_plain", spy)
    x, gamma, beta = _inputs(8, 2)
    y = group_norm(x, gamma, beta, 2, EPS)
    gx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert gx.grad_fn is not None and seen == [False]
    torch.autograd.grad(y.sum(), x)
    assert seen == [False, False]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_order_path_unchanged(dtype, monkeypatch):
    """Without create_graph the backward calls the wrapper directly, once,
    and gives bitwise the wrapper's (dx, dgamma, dbeta)."""
    applied = []
    real = gn._GroupNormBackwardFn.apply
    monkeypatch.setattr(gn._GroupNormBackwardFn, "apply",
                        lambda *a: applied.append(1) or real(*a))
    x, gamma, beta = _inputs(16, 2, dtype=dtype)
    y = group_norm(x, gamma, beta, 2, EPS)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dtype)
    got = torch.autograd.grad(y, (x, gamma, beta), dy)
    _, mean, rstd = gn.gn_forward(x.detach(), gamma.detach(), beta.detach(),
                                  2, EPS)
    want = gn.gn_backward(x.detach(), dy, gamma.detach(), mean, rstd, 2)
    assert applied == []
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_plain_versions_keep_f64_and_f32_bitwise():
    x, gamma, beta = [t.detach() for t in _inputs(12, 3)]
    y, mean, rstd = gn.gn_forward_plain(x, gamma, beta, 3, EPS)
    assert y.dtype == mean.dtype == rstd.dtype == torch.float64
    dx, dg, db = gn.gn_backward_plain(x, torch.ones_like(x), gamma, mean,
                                      rstd, 3)
    assert dx.dtype == dg.dtype == db.dtype == torch.float64
    # f32 and bf16 inputs compute in f32, as before the f64 path existed
    for dtype in (torch.float32, torch.bfloat16):
        xs, gs, bs = (t.to(dtype) for t in (x, gamma, beta))
        y, mean, rstd = gn.gn_forward_plain(xs, gs, bs, 3, EPS)
        xf = xs.float().reshape(2, -1, 3, 4)
        m = xf.mean(dim=(1, 3))
        r = torch.rsqrt(((xf - m[:, None, :, None]) ** 2).mean(dim=(1, 3))
                        + EPS)
        want = ((xf - m[:, None, :, None]) * r[:, None, :, None]).reshape(
            xs.shape) * gs.float() + bs.float()
        assert mean.dtype == torch.float32
        assert torch.equal(y, want.to(dtype)) and torch.equal(mean, m)
