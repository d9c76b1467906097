"""Training-time augmentation of the PyTorch port against the JAX package.

The port cannot reproduce ``jax.random``'s draws, so the draw is split
from the transform (data/augment.py):

* each transform is held bitwise to JAX's: the JAX transform runs with a
  key, the test re-draws that key's offsets, flips and centres with
  ``jax.random`` as the JAX function does, and feeds them to the port's
  transform (crop, flip and cutout only move and zero values, so f32 and
  bf16 results are equal bit for bit);
* the port's draws, on a CPU generator, are checked for range and rate;
* the trainer applies augmentation in the training step only: eval is
  bitwise the same with and without it, an identity augment leaves
  ``local_train`` bitwise unchanged, and the augmentation draws before
  dropout does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.data import augment as jaug
from fedml_tpu_torch.core.trainer import ClientTrainer, client_generator
from fedml_tpu_torch.data import augment
from fedml_tpu_torch.data.federated import (FederatedData,
                                            build_client_shards,
                                            build_eval_shard)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_robust import few_torch_threads  # noqa: F401 (autouse)

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _imgs(bs=8, h=32, w=32, c=3, seed=0):
    return (np.random.RandomState(seed).rand(bs, h, w, c).astype(np.float32)
            + 0.5)                              # strictly positive


def _pair(x, dtype):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _crop_draws(key, bs, padding):
    ry, rx = jax.random.split(key)
    return (jax.random.randint(ry, (bs,), 0, 2 * padding + 1),
            jax.random.randint(rx, (bs,), 0, 2 * padding + 1))


def _cutout_draws(key, bs, h, w):
    ry, rx = jax.random.split(key)
    return (jax.random.randint(ry, (bs, 1, 1), 0, h)[:, 0, 0],
            jax.random.randint(rx, (bs, 1, 1), 0, w)[:, 0, 0])


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# each transform, bitwise, given JAX's draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed,padding", [(0, 4), (1, 2), (2, 0)])
def test_crop_is_jaxs_random_crop_given_its_offsets(seed, padding, dtype):
    jx, tx = _pair(_imgs(bs=16, h=12, w=10, seed=seed), dtype)
    key = jax.random.PRNGKey(seed)
    ys, xs = _crop_draws(key, 16, padding)
    _same(augment.crop(tx, _t(ys), _t(xs), padding),
          jaug.random_crop(key, jx, padding))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 3])
def test_flip_is_jaxs_random_flip_given_its_flags(seed, dtype):
    jx, tx = _pair(_imgs(bs=16, seed=seed), dtype)
    key = jax.random.PRNGKey(seed)
    flags = jax.random.bernoulli(key, 0.5, (16,))
    assert 0 < int(flags.sum()) < 16
    _same(augment.flip(tx, torch.from_numpy(np.array(flags))),
          jaug.random_flip(key, jx))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed,length", [(0, 16), (1, 5), (2, 8)])
def test_cut_is_jaxs_cutout_given_its_centres(seed, length, dtype):
    jx, tx = _pair(_imgs(bs=16, h=20, w=24, seed=seed), dtype)
    key = jax.random.PRNGKey(seed)
    cy, cx = _cutout_draws(key, 16, 20, 24)
    _same(augment.cut(tx, _t(cy), _t(cx), length),
          jaug.cutout(key, jx, length))


@pytest.mark.parametrize("cfg", [(4, True, 16), (2, False, None), (0, True, 6)])
def test_composed_pipeline_is_jaxs_given_its_draws(cfg):
    padding, do_flip, length = cfg
    x = _imgs(bs=12, seed=4)
    key = jax.random.PRNGKey(7)
    want = jaug.make_augment_fn(padding, do_flip, length)(key, jnp.asarray(x))
    r1, r2, r3 = jax.random.split(key, 3)
    got = torch.from_numpy(x)
    if padding:
        got = augment.crop(got, *map(_t, _crop_draws(r1, 12, padding)), padding)
    if do_flip:
        got = augment.flip(got, torch.from_numpy(np.array(
            jax.random.bernoulli(r2, 0.5, (12,)))))
    if length:
        got = augment.cut(got, *map(_t, _cutout_draws(r3, 12, 32, 32)), length)
    _same(got, want)


# ---------------------------------------------------------------------------
# the draws: ranges and rates on a CPU generator
# ---------------------------------------------------------------------------

def test_draw_ranges_and_rates_on_a_cpu_generator(monkeypatch):
    """Crop offsets uniform over [0, 2p], flips at rate 0.5, cutout centres
    over [0, H) x [0, W), each drawn on the generator's device as one
    [bs] tensor, and handed to the transforms unchanged."""
    drawn = {}
    for name in ("crop", "flip", "cut"):
        real = getattr(augment, name)

        def capture(x, *draws, _name=name, _real=real, **kw):
            drawn[_name] = draws[:2] if _name != "flip" else draws[:1]
            return _real(x, *draws, **kw)
        monkeypatch.setattr(augment, name, capture)
    bs, h, w = 8192, 20, 24
    x = torch.ones(bs, h, w, 1)
    out = augment.make_augment_fn(4, True, 16)(
        torch.Generator().manual_seed(0), x)
    assert out.shape == x.shape
    ys, xs = drawn["crop"]
    cy, cx = drawn["cut"]
    (flags,) = drawn["flip"]
    for t, hi in ((ys, 9), (xs, 9), (cy, h), (cx, w)):
        assert t.shape == (bs,) and t.device.type == "cpu"
        counts = torch.bincount(t, minlength=hi)
        assert len(counts) == hi and counts.min() > 0      # every value occurs
        # uniform: each bucket within 5 sigma of bs / hi
        assert (counts - bs / hi).abs().max() < 5 * np.sqrt(bs / hi)
    assert flags.dtype == torch.bool and flags.shape == (bs,)
    assert abs(flags.float().mean().item() - 0.5) < 5 * 0.5 / np.sqrt(bs)
    # the pipeline zeroes only: every value is the input's or 0
    assert set(out.unique().tolist()) <= {0.0, 1.0}


def test_augment_is_deterministic_per_generator_and_keeps_dtype():
    aug = augment.make_augment_fn()
    for dtype in (torch.float32, torch.bfloat16, torch.uint8):
        x = (torch.from_numpy(_imgs(bs=6)) * 100).to(dtype)
        a = aug(torch.Generator().manual_seed(5), x)
        b = aug(torch.Generator().manual_seed(5), x)
        c = aug(torch.Generator().manual_seed(6), x)
        assert a.dtype == dtype and a.shape == x.shape
        assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the trainer hook
# ---------------------------------------------------------------------------

def _batch(bs=8, hw=28, c=1, seed=0):
    rs = np.random.RandomState(seed)
    return {"x": torch.from_numpy(rs.rand(bs, hw, hw, c).astype(np.float32)),
            "y": torch.from_numpy(rs.randint(0, 10, bs).astype(np.int64)),
            "mask": torch.ones(bs)}


def _trainers(name="cnn", augment_fn=None, **kw):
    model = create_model(name, 10)
    aug = augment_fn or augment.make_augment_fn(4, True, 16)
    return (ClientTrainer(model, lr=0.1, **kw),
            ClientTrainer(model, lr=0.1, augment=aug, **kw))


def test_eval_never_augments():
    plain, auged = _trainers()
    flat = plain.flatten(plain.init(torch.Generator().manual_seed(0), "cpu"))
    batch = _batch()
    e1, e2 = plain.eval_step(flat, batch), auged.eval_step(flat, batch)
    for k in e1:
        assert torch.equal(e1[k], e2[k]), k
    s1, s2 = plain.evaluate(flat, {k: v[None] for k, v in batch.items()}), \
        auged.evaluate(flat, {k: v[None] for k, v in batch.items()})
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    # training does see augmented inputs
    l1 = plain.train_step(flat, batch, generator=torch.Generator().manual_seed(1))[2]
    l2 = auged.train_step(flat, batch, generator=torch.Generator().manual_seed(1))[2]
    assert not torch.equal(l1, l2)


def test_identity_augment_leaves_local_train_bitwise_unchanged():
    plain, ident = _trainers("cnn_dropout", augment_fn=lambda g, x: x)
    flat = plain.flatten(plain.init(torch.Generator().manual_seed(0), "cpu"))
    shard = {k: torch.stack([v, v.flip(0)]) for k, v in _batch().items()}
    a = plain.local_train(flat, shard, 2, generator=torch.Generator().manual_seed(3))
    b = ident.local_train(flat, shard, 2, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_augmentation_draws_before_dropout():
    """An augment that takes one draw from the generator leaves dropout the
    stream that follows it: the step equals a plain step whose generator
    was advanced by that draw first."""
    def one_draw(g, x):
        torch.rand(1, generator=g)
        return x

    plain, drawing = _trainers("cnn_dropout", augment_fn=one_draw)
    flat = plain.flatten(plain.init(torch.Generator().manual_seed(0), "cpu"))
    batch = _batch()
    g = torch.Generator().manual_seed(4)
    torch.rand(1, generator=g)
    want = plain.train_step(flat, batch, generator=g)
    got = drawing.train_step(flat, batch,
                             generator=torch.Generator().manual_seed(4))
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    other = plain.train_step(flat, batch,
                             generator=torch.Generator().manual_seed(4))
    assert not torch.equal(other[0], want[0])


def test_augment_runs_on_the_float_input_before_the_bf16_cast():
    seen = []

    def record(g, x):
        seen.append(x.dtype)
        return x

    _, tr = _trainers(augment_fn=record, train_dtype=torch.bfloat16)
    flat = tr.flatten(tr.init(torch.Generator().manual_seed(0), "cpu"))
    tr.train_step(flat, _batch(), generator=torch.Generator().manual_seed(0))
    assert seen == [torch.float32]


def test_mesh_engine_trains_with_augmentation_from_client_generators():
    """A round of the chunked engine with the CIFAR pipeline on: finite,
    the model moves, and the per-client generators make it repeatable;
    a round without augmentation differs."""
    rs = np.random.RandomState(0)
    x = rs.rand(24, 16, 16, 3).astype(np.float32)
    y = rs.randint(0, 10, 24).astype(np.int64)
    idx = {i: np.arange(i * 8, (i + 1) * 8) for i in range(3)}
    ev = build_eval_shard(x[:8], y[:8], 4)
    data = FederatedData(
        train_data_num=24, test_data_num=8, train_global=ev, test_global=ev,
        client_shards=build_client_shards(x, y, idx, 4),
        client_num_samples=np.full(3, 8, np.float32),
        test_client_shards=None, class_num=10)
    cfg = FedConfig(client_num_in_total=3, client_num_per_round=3, epochs=1,
                    batch_size=4, lr=0.1)
    model = create_model("resnet18_gn", 10, num_filters=8)
    out = []
    for aug in (augment.make_augment_fn(2, True, 6),
                augment.make_augment_fn(2, True, 6), None):
        eng = MeshFedAvgEngine(ClientTrainer(model, lr=0.1, augment=aug),
                               data, cfg, chunk=2, device="cpu")
        v0 = eng.init_variables()
        v1, _, m = eng.round_fn(v0, (), *eng._round_args(0))
        assert torch.isfinite(m["train_loss"])
        assert all(torch.isfinite(v).all() for v in v1.values())
        out.append(v1)
    a, b, plain = out
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], plain[k]) for k in a)
    assert client_generator(0, 0, 1, "cpu").initial_seed() != \
        client_generator(0, 0, 2, "cpu").initial_seed()
