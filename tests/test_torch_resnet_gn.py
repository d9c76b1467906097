"""ResNet-18-GN of the PyTorch port against the JAX package's flax model,
from the same weights (copied with fedml_tpu_torch.convert).

Full depth, narrow width (num_filters=8), at 32x32 and 16x16 inputs: the
stride-2 3x3 convs' flax "SAME" padding is (0, 1), and a (1, 1) pad would
move every logit.  Tolerance (f32): logits atol 1e-5, param grads rtol 1e-3
/ atol 1e-5 (20 conv/GN layers of f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.models import create_model, init_params
from fedml_tpu_torch.models.resnet_gn import same_padding


def _pair(hw, seed=0, bs=3, nf=8):
    rs = np.random.RandomState(seed)
    x = rs.rand(bs, hw, hw, 3).astype(np.float32)
    y = rs.randint(0, 10, bs).astype(np.int64)
    jm = JaxResNet18GN(num_classes=10, num_filters=nf)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    tm = create_model("resnet18_gn", 10, num_filters=nf)
    return x, y, jm, v, tm, flax_to_torch(v)


@pytest.mark.parametrize("hw", [32, 16])
def test_logits_match_flax(hw):
    x, _, jm, v, tm, sd = _pair(hw)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    got = functional_call(tm, sd, (torch.tensor(x),)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [32, 16])
def test_param_grads_match_flax(hw):
    x, y, jm, v, tm, sd = _pair(hw, seed=1)

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    want = jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(v))
    params = {k: t.clone().requires_grad_() for k, t in sd.items()}
    logits = functional_call(tm, params, (torch.tensor(x),))
    torch.nn.functional.cross_entropy(logits, torch.tensor(y)).backward()
    got = torch_to_flax({k: t.grad for k, t in params.items()})
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_converter_round_trips_bitwise():
    _, _, _, v, tm, sd = _pair(16)
    assert set(sd) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        assert sd[n].shape == p.shape, n
    back = torch_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(dict(v))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_full_width_counts_match_flax():
    """11,173,962 parameters in 62 leaves at num_filters=64, as flax's init."""
    tm = create_model("resnet18_gn", 10)
    shapes = jax.eval_shape(lambda: jax_create_model("resnet18_gn", 10).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    assert sum(p.numel() for p in tm.parameters()) == 11_173_962 == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert len(list(tm.parameters())) == 62 == len(jax.tree.leaves(shapes))


@pytest.mark.parametrize("size,k,s,want", [
    (32, 3, 2, (0, 1)),     # the stride-2 trap: (0, 1), not (1, 1)
    (16, 3, 1, (1, 1)),
    (32, 1, 2, (0, 0)),     # 1x1 stride-2 shortcut
    (7, 3, 2, (1, 1)),
])
def test_same_padding_matches_xla(size, k, s, want):
    assert same_padding(size, k, s) == want


def test_init_follows_flax_initializers():
    tm = create_model("resnet18_gn", 10, num_filters=8)
    p = init_params(tm, torch.Generator().manual_seed(0))
    q = init_params(tm, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert torch.equal(p["GroupNorm_0.scale"], torch.ones(8))
    assert not p["Dense_0.bias"].any()
    w = p["BasicBlockGN_7.Conv_1.weight"]   # fan_in = 64 * 9
    assert abs(float(w.std()) - (1 / 576) ** 0.5) < 0.1 * (1 / 576) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 576) ** 0.5 / 0.87962566 + 1e-6


def test_unported_names_raise():
    # every factory name is ported now ("darts" builds DartsNetwork); the
    # JAX-only fusion hint still raises by name
    assert type(create_model("darts", 10)).__name__ == "DartsNetwork"
    with pytest.raises(ValueError, match="norm_fusion_barrier"):
        create_model("resnet18_gn", 10, norm_fusion_barrier=True)


def test_activations_stay_channels_last():
    """The GN kernel reads trailing-channel memory: every GN input must be
    a channels_last NCHW tensor, so the NHWC view is contiguous."""
    tm = create_model("resnet18_gn", 10, num_filters=8)
    t = ClientTrainer(tm)
    seen = []
    import fedml_tpu_torch.ops.groupnorm as gn_mod
    orig = gn_mod.gn_forward

    def spy(x, *a):
        seen.append(x.is_contiguous())
        return orig(x, *a)

    gn_mod.gn_forward = spy
    try:
        params = t.unflatten(t.flatten(t.init(torch.Generator().manual_seed(0),
                                              "cpu")))
        functional_call(tm, params, (torch.rand(2, 16, 16, 3),))
    finally:
        gn_mod.gn_forward = orig
    assert len(seen) == 20 and all(seen)
