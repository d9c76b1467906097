"""The PyTorch port's model zoo against the JAX package's flax models.

Each family runs at a small size from flax's own init, copied with
fedml_tpu_torch.convert, on inputs made from a numpy seed: the logits in
eval mode, then the logits, the CE loss's parameter gradients and (for
the BatchNorm models) the updated running statistics in train mode.
Train mode takes dropout rate 0 where the model has a rate (MobileNetV3's
``dropout``, EfficientNet's ``drop_connect_rate``, and EfficientNet's
head rate, set to 0 in both packages' variant tables for the test);
CNNDropOut and VGG, whose rates are fixed, are compared in eval mode.

Tolerances (f32): logits within rtol 1e-4 + 1e-5 x max|logits|;
gradients and statistics per leaf within rtol 1e-3 + 1e-5 x the largest
|value| over all leaves (f32 sums in another order; an attention key
bias, whose gradient is zero in exact arithmetic, sits at the absolute
floor).  The BatchNorm families are held to JAX's result in float64
(``jax.enable_x64``): flax differentiates its fast variance
E[x^2] - E[x]^2 as written, and in f32 that gradient cancels, so JAX's
own f32 gradients stray from the exact ones by up to 5e-3 (ResNet-20 at
16x16, one seed in four), where the port's textbook BatchNorm backward
stays within 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

import fedml_tpu.models.efficientnet as jax_efficientnet
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.mobilenet_v3 import _make_divisible as jax_make_divisible
import fedml_tpu_torch.models.efficientnet as port_efficientnet
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.models import create_model, init_params
from fedml_tpu_torch.models.layers import Dropout
from fedml_tpu_torch.models.mobilenet_v3 import _make_divisible
from fedml_tpu_torch.models.norms import BatchNorm, sync_batch_norm
from fedml_tpu_torch.models.resnet_gn import same_padding
from tests.test_torch_robust import few_torch_threads  # noqa: F401 (autouse)


def _images(n, hw, c=3, seed=0):
    return np.random.RandomState(seed).rand(n, hw, hw, c).astype(np.float32)


def _tokens(n, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (n, t))


# name, output_dim, kwargs, input, train-mode comparison, BatchNorm
FAMILIES = {
    "lr": ("lr", 10, {}, _images(4, 28, 1)[..., 0], True),
    "cnn": ("cnn", 62, {}, _images(4, 28, 1), True),
    "cnn_dropout": ("cnn_dropout", 62, {}, _images(4, 28, 1), False),
    "char_lstm": ("rnn", 90, {"hidden_size": 16}, _tokens(4, 10, 90), True),
    "char_lstm_last": ("rnn", 90, {"hidden_size": 16, "last_only": True},
                       _tokens(4, 10, 90), True),
    "word_lstm": ("rnn_stackoverflow", 50,
                  {"hidden_size": 16, "embedding_dim": 8},
                  _tokens(4, 10, 50), True),
    "transformer": ("transformer", 50, {"d_model": 32, "n_layers": 2,
                                        "d_ff": 64, "max_len": 16},
                    _tokens(4, 10, 50), True),
    "resnet20": ("resnet20", 10, {}, _images(8, 16), True),
    "mobilenet": ("mobilenet", 10, {"alpha": 0.25}, _images(8, 32), True),
    "mobilenet_v3": ("mobilenet_v3", 10, {"mode": "small", "width_mult": 0.25,
                                          "dropout": 0.0},
                     _images(8, 32), True),
    "efficientnet": ("efficientnet-b0", 10, {"drop_connect_rate": 0.0},
                     _images(4, 32), True),
    "vgg": ("vgg11", 10, {}, _images(2, 32), False),
}


@pytest.fixture
def no_head_dropout(monkeypatch):
    """EfficientNet-B0's head dropout at 0 in both packages' tables."""
    for mod in (jax_efficientnet, port_efficientnet):
        monkeypatch.setitem(mod.PARAMS, "b0", (1.0, 1.0, 224, 0.0))


def _labels(name, kw, x, out):
    rs = np.random.RandomState(1)
    if name in ("rnn", "rnn_stackoverflow", "transformer") \
            and not kw.get("last_only"):
        return rs.randint(0, out, x.shape)
    return rs.randint(0, out, x.shape[0])


def _jax_reference(jm, v, x, y, train, x64):
    """(eval logits, loss, logits, new batch_stats, grads) of mean CE in
    train mode (or eval mode with `train` false), by JAX in one program."""
    def loss_fn(params, rest):
        if train and rest:
            logits, rest = jm.apply({"params": params, **rest}, x, train=True,
                                    mutable=list(rest))
        else:
            logits = jm.apply({"params": params, **rest}, x, train=train)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce, (logits, rest)

    def reference(params, rest):
        return (jm.apply({"params": params, **rest}, x),
                *jax.value_and_grad(loss_fn, has_aux=True)(params, rest))

    dtype = np.float64 if x64 else np.float32
    cast = lambda t: jax.tree.map(lambda a: np.asarray(a, dtype), t)
    with jax.enable_x64(x64):
        rest = {k: cast(w) for k, w in v.items() if k != "params"}
        evaluated, (loss, (logits, rest)), grads = jax.jit(reference)(
            cast(v["params"]), rest)
        return jax.tree.map(np.asarray, (evaluated, loss, logits, rest, grads))


def _port(tm, sd, x, y, train):
    pnames = {n for n, _ in tm.named_parameters()}
    variables = {k: t.clone().requires_grad_(k in pnames) for k, t in sd.items()}
    logits = functional_call(tm, variables, (torch.tensor(x),), {"train": train})
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), torch.tensor(y).reshape(-1))
    loss.backward()
    state = torch_to_flax({k: (t.grad if k in pnames else t.detach())
                           for k, t in variables.items()})
    return float(loss.detach()), logits.detach().numpy(), state


def assert_tree_close(got, want, rtol=1e-3, atol_frac=1e-5):
    """Leaf by leaf |got - want| <= rtol |want| + atol_frac * (the largest
    |value| of any leaf)."""
    floor = atol_frac * max(np.abs(b).max() for b in jax.tree.leaves(want))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=rtol,
                                   atol=floor,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_flax(family, no_head_dropout):
    name, out, kw, x, train = FAMILIES[family]
    jm, tm = jax_create_model(name, out, **kw), create_model(name, out, **kw)
    v = jax.tree.map(np.asarray, jax.jit(lambda a: jm.init(
        jax.random.PRNGKey(0), a, train=False))(jnp.asarray(x)))
    sd = flax_to_torch(v)
    assert set(sd) == set(dict(tm.named_parameters())) | set(
        dict(tm.named_buffers()))
    y = _labels(name, kw, x, out)
    # JAX in f64 where BatchNorm's f32 gradient cancels
    bn = "batch_stats" in v
    want, loss, logits, stats, grads = _jax_reference(jm, v, x, y, train,
                                                      x64=bn)

    # eval mode
    got = functional_call(tm, sd, (torch.tensor(x),)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())

    # train mode (eval for the fixed-rate dropout models)
    got_loss, got_logits, state = _port(tm, sd, x, y, train)
    assert got_loss == pytest.approx(float(loss), rel=1e-5)
    np.testing.assert_allclose(got_logits, logits, rtol=1e-4,
                               atol=1e-5 * np.abs(logits).max())
    assert_tree_close(state["params"], grads)
    if bn:
        assert_tree_close(state["batch_stats"], stats["batch_stats"])


# ---------------------------------------------------------------------------
# the factory, sizes and initial values
# ---------------------------------------------------------------------------

JAX_FACTORY_NAMES = ("lr", "cnn", "cnn_dropout", "rnn", "rnn_stackoverflow",
                     "transformer", "resnet18_gn", "resnet18", "resnet56",
                     "resnet20", "mobilenet", "mobilenet_v3", "efficientnet",
                     "vgg11", "vgg16") + tuple(
                         f"efficientnet-b{i}" for i in range(8))


def test_create_model_builds_every_jax_factory_name():
    for name in JAX_FACTORY_NAMES + ("segnet", "darts"):
        assert sum(p.numel() for p in create_model(name, 10).parameters()) > 0
    with pytest.raises(ValueError, match="unknown model"):
        create_model("resnet_gkt", 10)


# model, output_dim, kwargs, input shape (int tokens if 2-D), params, stats
FULL_WIDTH = [
    ("lr", 10, {}, (1, 28, 28), 7_850, 0),
    ("cnn", 62, {}, (1, 28, 28, 1), 1_690_046, 0),
    ("cnn_dropout", 62, {}, (1, 28, 28, 1), 1_206_590, 0),
    ("rnn", 90, {}, (1, 80), 820_522, 0),
    ("rnn_stackoverflow", 10004, {}, (1, 20), 4_050_748, 0),
    ("transformer", 10004, {}, (1, 20), 3_033_364, 0),
    ("resnet20", 10, {}, (1, 32, 32, 3), 272_474, 1_568),
    ("resnet56", 10, {}, (1, 32, 32, 3), 855_770, 4_256),
    ("mobilenet", 10, {}, (1, 32, 32, 3), 3_217_226, 21_888),
    ("mobilenet_v3", 100, {}, (1, 32, 32, 3), 4_330_132, 24_400),
    ("efficientnet-b0", 10, {}, (1, 32, 32, 3), 4_020_358, 42_016),
    ("vgg11", 10, {}, (1, 32, 32, 3), 9_488_266, 0),
    ("vgg16", 10, {}, (1, 32, 32, 3), 14_982_474, 0),
]


@pytest.mark.parametrize("name,out,kw,shape,n_params,n_stats", FULL_WIDTH,
                         ids=[r[0] for r in FULL_WIDTH])
def test_full_width_sizes_match_flax(name, out, kw, shape, n_params, n_stats):
    """Parameters and BatchNorm statistics at the published widths, as
    flax's init counts them (jax.eval_shape)."""
    x = jnp.zeros(shape, jnp.int32 if len(shape) == 2 else jnp.float32)
    shapes = jax.eval_shape(lambda: jax_create_model(name, out, **kw).init(
        jax.random.PRNGKey(0), x, train=False))
    count = lambda tree: sum(int(np.prod(s.shape)) for s in jax.tree.leaves(tree))
    tm = create_model(name, out, **kw)
    assert sum(p.numel() for p in tm.parameters()) == n_params == count(
        shapes["params"])
    assert sum(b.numel() for b in tm.buffers()) == n_stats == count(
        shapes.get("batch_stats", {}))


@pytest.mark.parametrize("mode", ["large", "small"])
def test_mobilenet_v3_modes_build_the_published_widths(mode):
    """Both configurations and the rounding helper match the JAX module's
    (widths at 1.0 and 0.35; parameter counts from flax's init shapes)."""
    for v in (3.5, 16 * 0.35, 72 * 0.35, 960 * 0.35, 1000.0):
        assert _make_divisible(v) == jax_make_divisible(v)
    for wm in (1.0, 0.35):
        shapes = jax.eval_shape(lambda: jax_create_model(
            "mobilenet_v3", 10, mode=mode, width_mult=wm).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
        tm = create_model("mobilenet_v3", 10, mode=mode, width_mult=wm)
        assert sum(p.numel() for p in tm.parameters()) == sum(
            int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))


def test_efficientnet_variants_scale_as_published():
    """B0-B7: the port's coefficient table and rounding are the JAX
    module's, so every variant builds the same blocks; B0's and B7's
    parameter counts equal flax's."""
    assert port_efficientnet.PARAMS == jax_efficientnet.PARAMS
    assert port_efficientnet._BASE == jax_efficientnet._BASE
    for wm, dm, _, _ in port_efficientnet.PARAMS.values():
        for f in (16, 32, 40, 112, 320, 1280):
            assert port_efficientnet._round_filters(f, wm) == \
                jax_efficientnet._round_filters(f, wm)
        for r in (1, 2, 3, 4):
            assert port_efficientnet._round_repeats(r, dm) == \
                jax_efficientnet._round_repeats(r, dm)
    for variant in ("b0", "b7"):
        shapes = jax.eval_shape(lambda: jax_create_model(
            f"efficientnet-{variant}", 10).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3))))
        tm = create_model(f"efficientnet-{variant}", 10)
        for col, tensors in (("params", tm.parameters()),
                             ("batch_stats", tm.buffers())):
            assert sum(t.numel() for t in tensors) == sum(
                int(np.prod(s.shape)) for s in jax.tree.leaves(shapes[col]))


@pytest.mark.parametrize("family", ["char_lstm", "transformer", "resnet20"])
def test_init_draws_flax_distributions(family):
    """The port's init against flax's, leaf by leaf: the same shapes, the
    constant leaves (scales, biases, running statistics) equal, and the
    random ones with the same spread (std within 10 % for leaves of 512+
    values; orthogonal recurrent kernels orthogonal)."""
    name, out, kw, x, _ = FAMILIES[family]
    v = jax.tree.map(np.asarray, jax_create_model(name, out, **kw).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    tm = create_model(name, out, **kw)
    p = init_params(tm, torch.Generator().manual_seed(0))
    q = init_params(tm, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
    want = flax_to_torch(v)
    assert set(p) == set(want)
    for k, t in p.items():
        w = want[k]
        assert t.shape == w.shape, k
        if not w.std():
            assert torch.equal(t, w), k
        elif w.numel() >= 512:
            assert float(t.std()) == pytest.approx(float(w.std()), rel=0.1), k
        if k.endswith(("hi.kernel", "hf.kernel", "hg.kernel", "ho.kernel")):
            np.testing.assert_allclose((t.T @ t).numpy(), np.eye(t.shape[0]),
                                       atol=1e-5, err_msg=k)


def test_converter_round_trips_params_and_batch_stats_bitwise():
    name, out, kw, x, _ = FAMILIES["resnet20"]
    v = jax.tree.map(np.asarray, jax_create_model(name, out, **kw).init(
        jax.random.PRNGKey(3), jnp.asarray(x), train=False))
    v["batch_stats"] = jax.tree.map(
        lambda a: a + np.random.RandomState(0).rand(*a.shape).astype(a.dtype),
        v["batch_stats"])
    back = torch_to_flax(flax_to_torch(v))
    assert jax.tree.structure(back) == jax.tree.structure(dict(v))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_batchnorm_is_flaxs_not_torchs():
    """momentum 0.9 is the share kept, the running variance takes the
    biased batch variance, and eval reads the running statistics."""
    x = torch.tensor(np.random.RandomState(0).randn(6, 3, 2, 2) * 2 + 1,
                     dtype=torch.float32)
    bn = BatchNorm(3)
    bn(x, train=True)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean, 0.1 * mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
    y = bn(x)
    torch.testing.assert_close(
        y, (x - bn.mean.view(1, -1, 1, 1))
        / torch.sqrt(bn.var.view(1, -1, 1, 1) + 1e-5), rtol=1e-5, atol=1e-5)


def test_sync_batch_norm_waits_for_slice_6():
    # the synchronized form came with slice 6c-ii: it is BatchNorm bound
    # to a mesh axis, and training outside a bound mesh raises
    assert isinstance(sync_batch_norm(4, sync=False), BatchNorm)
    assert sync_batch_norm(4, sync=False).axis_name is None
    bn = sync_batch_norm(4)
    assert isinstance(bn, BatchNorm) and bn.axis_name == "clients"
    with pytest.raises(NameError, match="unbound axis name"):
        bn(torch.zeros(2, 4, 3, 3), train=True)


def test_dropout_keeps_its_share_scaled_by_one_over_keep():
    x = torch.ones(200_000)
    drop = Dropout(0.25)
    gen = lambda: torch.Generator().manual_seed(5)
    y = drop(x, train=True, rng=gen())
    kept = y != 0
    assert float(kept.float().mean()) == pytest.approx(0.75, abs=0.005)
    assert torch.equal(y[kept], torch.full((int(kept.sum()),), 1 / 0.75))
    assert torch.equal(y, drop(x, train=True, rng=gen()))     # seeded
    assert drop(x, train=False) is x
    assert Dropout(0.0)(x, train=True) is x                   # no generator
    with pytest.raises(ValueError, match="Generator"):
        drop(x, train=True)


def test_drop_connect_drops_whole_examples():
    """EfficientNet's stochastic depth: a residual branch kept or dropped
    per example, kept ones scaled by 1/keep."""
    torch.manual_seed(0)
    block = create_model("efficientnet-b0", 10,
                         drop_connect_rate=0.5).MBConv_14
    assert block.residual and block.drop_rate == 0.5 * 14 / 16
    x = torch.randn(64, 192, 2, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        rate, block.drop_rate = block.drop_rate, 0.0
        h = block(x, True, None) - x
        block.drop_rate = rate
        hd = block(x, True, torch.Generator().manual_seed(1)) - x
    keep = 1 - rate
    ratio = (hd / h).reshape(64, -1)
    dropped = ratio.abs().amax(dim=1) < 1e-6
    assert 0 < int(dropped.sum()) < 64
    np.testing.assert_allclose(ratio[~dropped].numpy(), 1 / keep, rtol=1e-3)


@pytest.mark.parametrize("size,k,s,want", [(32, 5, 2, (1, 2)), (16, 3, 2, (0, 1)),
                                           (8, 5, 1, (2, 2)), (7, 5, 2, (2, 2))])
def test_same_padding_at_every_kernel_and_stride(size, k, s, want):
    assert same_padding(size, k, s) == want


def test_transformer_raises_past_max_len():
    tm = create_model("transformer", 50, d_model=16, n_layers=1, d_ff=32,
                      max_len=8)
    tm(torch.zeros(2, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="max_len=8"):
        tm(torch.zeros(2, 9, dtype=torch.long))


def test_lstm_weights_are_one_cudnn_buffer():
    """The cell hands cuDNN [w_ih, w_hh, b_ih = 0, b_hh] as consecutive
    views of one fresh buffer starting its storage, gates in the order
    i, f, g, o."""
    cell = create_model("rnn", 90, hidden_size=4).OptimizedLSTMCell_0
    for k, v in init_params(cell, torch.Generator().manual_seed(0)).items():
        cell.get_parameter(k).data.copy_(v)
    w_ih, w_hh, b_ih, b_hh = cell.cudnn_weights(torch.float32)
    base = w_ih.untyped_storage().data_ptr()
    assert w_ih.data_ptr() == base
    offsets = [t.data_ptr() - base for t in (w_ih, w_hh, b_ih, b_hh)]
    assert offsets == [0, 4 * 16 * 8, 4 * (16 * 8 + 16 * 4),
                       4 * (16 * 8 + 16 * 4 + 16)]
    assert not b_ih.any()
    gate = lambda k, g: cell.get_submodule(k + g)
    for i, g in enumerate("ifgo"):
        torch.testing.assert_close(w_ih[4 * i:4 * i + 4], gate("i", g).kernel.T)
        torch.testing.assert_close(w_hh[4 * i:4 * i + 4], gate("h", g).kernel.T)
        torch.testing.assert_close(b_hh[4 * i:4 * i + 4], gate("h", g).bias)
