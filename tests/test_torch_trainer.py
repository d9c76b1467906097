"""The PyTorch port's ClientTrainer against fedml_tpu.core.trainer.

Both sides start from the same flax-initialised weights (copied with
fedml_tpu_torch.convert) and train on the same numpy-made batches: full
ResNet-18-GN depth at narrow width (num_filters=8), 16x16 images, batches
of 4.  The shard ends in a partly padded batch and an all-padding batch,
so the sample-weighted epoch loss and the empty-batch guard are both on
the path.

Tolerances: f32 local training agrees to atol 1e-4 / rtol 1e-3 per leaf
after 6 SGD steps (the f32 sums of 20 conv and GroupNorm layers run in
another order and the steps compound it).  bf16 local training, on bf16
local masters as the mesh engine runs it, is held to the distance bf16
rounding itself puts between JAX's bf16 and f32 runs (the two frameworks
round activations and gradients at different points, so no per-element
bound holds).  Eval counts are equal; eval loss sums agree to rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.core.trainer import masked_accuracy_sums as jax_acc_sums
from fedml_tpu.core.trainer import masked_cross_entropy as jax_ce
from fedml_tpu.data.federated import pad_to_batches
from fedml_tpu.models.resnet_gn import ResNet18GN as JaxResNet18GN
from fedml_tpu.parallel.engine import cast_local as jax_cast_local
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core.trainer import (ClientTrainer, make_optimizer,
                                          masked_accuracy_sums,
                                          masked_cross_entropy)
from fedml_tpu_torch.models import create_model

NF, HW, BS = 8, 16, 4


def _shard(seed=0, n=9, n_batches=4):
    """9 samples in 4 batches of 4: full, full, 1 real + 3 pad, all pad."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, HW, HW, 3).astype(np.float32)
    y = rs.randint(0, 10, n).astype(np.int64)
    sx, sy, sm = pad_to_batches(x, y, BS, n_batches=n_batches)
    return {"x": sx, "y": sy, "mask": sm}


def _pair(train_dtype=None, seed=0):
    """(JAX trainer, port trainer, flax variables as numpy)."""
    jt = JaxClientTrainer(JaxResNet18GN(num_classes=10, num_filters=NF),
                          lr=0.1, **({"train_dtype": jnp.bfloat16}
                                     if train_dtype else {}))
    tt = ClientTrainer(create_model("resnet18_gn", 10, num_filters=NF),
                       lr=0.1, **({"train_dtype": torch.bfloat16}
                                  if train_dtype else {}))
    v = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(seed),
                                         jnp.zeros((1, HW, HW, 3))))
    return jt, tt, v


def _jax_local_train(jt, variables, shard, epochs):
    fn = jax.jit(lambda v, s: jt.local_train(v, s, jax.random.PRNGKey(0),
                                             epochs))
    return jax.tree.map(np.asarray, fn(variables, shard))


def _torch_shard(shard):
    return {k: torch.tensor(v) for k, v in shard.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_loss_and_accuracy_match_jax(seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(6, 10).astype(np.float32) * 3
    labels = rs.randint(0, 10, 6).astype(np.int64)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    got = masked_cross_entropy(torch.tensor(logits), torch.tensor(labels),
                               torch.tensor(mask))
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    got_c, got_n = masked_accuracy_sums(torch.tensor(logits),
                                        torch.tensor(labels), torch.tensor(mask))
    want_c, want_n = jax_acc_sums(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(mask))
    assert (float(got_c), float(got_n)) == (float(want_c), float(want_n))


@pytest.mark.parametrize("dtype,wd", [(np.float32, 0.0), (np.float32, 1e-2),
                                      (jnp.bfloat16, 0.0), (jnp.bfloat16, 1e-2)])
def test_sgd_update_matches_optax(dtype, wd):
    """u = -lr (g + wd p), then p + u, each rounded to the params' dtype:
    optax's two roundings, equal to within one ulp of the dtype."""
    rs = np.random.RandomState(7)
    p = np.asarray(jnp.asarray(rs.randn(257).astype(np.float32), dtype))
    g = np.asarray(jnp.asarray(rs.randn(257).astype(np.float32), dtype))
    tx = optax.chain(*([optax.add_decayed_weights(wd)] if wd else []),
                     optax.sgd(0.1))
    jp, jg = jnp.asarray(p), jnp.asarray(g)
    u, _ = tx.update(jg, tx.init(jp), jp)
    want = np.asarray(optax.apply_updates(jp, u), np.float32)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tp = torch.tensor(p.astype(np.float32)).to(tdtype)
    tg = torch.tensor(g.astype(np.float32)).to(tdtype)
    opt = make_optimizer("sgd", 0.1, weight_decay=wd)
    got = tp + opt.update(tg, opt.init(tp), tp)[0]
    assert got.dtype == tdtype
    ulp = 2.0 ** -7 if tdtype == torch.bfloat16 else 2.0 ** -23
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=ulp, atol=1e-30)


@pytest.mark.parametrize("kw", [dict(name="rmsprop"), dict(name="lamb"),
                                dict(name="adagrad", momentum=0.9)])
def test_unported_optimizers_raise(kw):
    """The client optimizers are the JAX factory's (sgd, adam, adamw);
    any other name raises as there."""
    kw = {"lr": 0.1, **kw}
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(kw.pop("name"), **kw)


def test_local_train_f32_matches_jax():
    jt, tt, v = _pair()
    shard = _shard()
    jv, jloss, jn = _jax_local_train(jt, v, shard, epochs=2)
    flat, loss, n = tt.local_train(tt.flatten(flax_to_torch(v)),
                                   _torch_shard(shard), epochs=2)
    got = torch_to_flax(tt.unflatten(flat))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jv)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert float(n) == float(jn) == 9.0


def _flat_np(tree):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree.leaves(tree)])


def test_local_train_bf16_masters_match_jax_loosely():
    """bf16 local masters (the main path): JAX trains the cast_local'd
    tree, the port a bf16 flat vector; both return bf16 weights.  The
    port's weights must lie as close to JAX's bf16 run as that run lies to
    JAX's own f32 run (within 2x, L2 over the model): bf16 rounding, not
    the port, sets the distance.  The loss likewise."""
    jt, tt, v = _pair(train_dtype="bf16", seed=1)
    shard = _shard(seed=1)
    jv, jloss, _ = _jax_local_train(jt, jax_cast_local(v, jnp.bfloat16),
                                    shard, epochs=1)
    jv32, jloss32, _ = _jax_local_train(_pair(seed=1)[0], v, shard, epochs=1)
    flat, loss, _ = tt.local_train(
        tt.flatten(flax_to_torch(v), torch.bfloat16), _torch_shard(shard),
        epochs=1)
    assert flat.dtype == torch.bfloat16
    got = _flat_np(torch_to_flax(tt.unflatten(flat)))
    want, ref32, init = _flat_np(jv), _flat_np(jv32), _flat_np(v)
    noise = np.linalg.norm(want - ref32)
    assert noise < np.linalg.norm(ref32 - init)     # training outruns rounding
    assert np.linalg.norm(got - want) <= 2 * noise
    assert abs(float(loss) - float(jloss)) <= 2 * abs(float(jloss)
                                                      - float(jloss32)) + 1e-2


def test_empty_batch_leaves_weights_bitwise_and_reports_zero_loss():
    _, tt, v = _pair()
    flat = tt.flatten(flax_to_torch(v))
    shard = _torch_shard(_shard())
    batch = {k: t[3] for k, t in shard.items()}        # the all-padding batch
    assert float(batch["mask"].sum()) == 0.0
    new, _, loss = tt.train_step(flat, batch)
    assert torch.equal(new, flat) and float(loss) == 0.0


def test_eval_sums_match_jax():
    jt, tt, v = _pair(seed=2)
    shard = _shard(seed=2, n=7, n_batches=2)
    want = jax.tree.map(np.asarray, jax.jit(jt.evaluate)(v, shard))
    got = tt.evaluate(tt.flatten(flax_to_torch(v)), _torch_shard(shard))
    assert float(got["count"]) == float(want["count"]) == 7.0
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-5)


def test_flat_layout_pads_to_tile_and_round_trips():
    _, tt, v = _pair()
    sd = flax_to_torch(v)
    flat = tt.flatten(sd)
    assert flat.shape[0] % 512 == 0 and flat.shape[0] - tt.spec.n < 512
    assert not flat[tt.spec.n:].any()
    back = tt.unflatten(flat)
    assert list(back) == [n for n, _ in tt.model.named_parameters()]
    for k, t in sd.items():
        assert torch.equal(back[k], t)
