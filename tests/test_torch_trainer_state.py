"""The PyTorch port's ClientTrainer state and recipe surface against the
JAX package's: BatchNorm statistics in the flat vector, the sequence axis,
the bce and focal losses, sgd-momentum/adam/adamw, learning-rate
schedules, and the engines' fold of the statistics.

BatchNorm runs ResNet-20 at 8x8 on clients of 6, 3, 5 and 8 samples in
batches of 4 (client 1 has a partly padded batch and an all-padding one).
The JAX side is stepped with its jitted ``train_step`` per batch (ROADMAP
C.1) and, for f32, runs in float64 (``jax.enable_x64``): flax's f32
BatchNorm gradient cancels in its fast variance (tests/test_torch_zoo.py),
so JAX in f64 is the sharp reference.  Engine rounds start from JAX's
model of the round before.

Tolerances: f32 against JAX's f64, per leaf rtol 1e-3 + 1e-5 x the
largest |value| (test_torch_zoo.assert_tree_close); the LSTM and LR
cases against JAX's f32 at rtol 1e-4 / atol 1e-6; bf16 within 2x of the
distance bf16 rounding itself puts between JAX's bf16 and f32 runs (L2);
optimizer steps against optax at rtol 1e-6 in f32 and one bf16 ulp in
bf16; schedules at rtol 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgEngine as JaxFedAvgEngine
from fedml_tpu.algorithms.fedavg_robust import \
    FedAvgRobustEngine as JaxFedAvgRobustEngine
from fedml_tpu.algorithms.fednova import fednova_tau as jax_fednova_tau
from fedml_tpu.algorithms.fedopt import FedOptEngine as JaxFedOptEngine
from fedml_tpu.core import trainer as jtrainer
from fedml_tpu.core.pytree import tree_weighted_mean
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.core.trainer import TrainState
from fedml_tpu.data import federated as jfed
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fedavg_robust import FedAvgRobustEngine
from fedml_tpu_torch.algorithms.fednova import FedNovaEngine
from fedml_tpu_torch.algorithms.fedopt import FedOptEngine
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core import trainer as ttrainer
from fedml_tpu_torch.core.trainer import ClientTrainer, make_optimizer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.engine import (MeshFedAvgEngine,
                                             MeshFedNovaEngine,
                                             MeshFedOptEngine,
                                             MeshRobustEngine)
from fedml_tpu_torch.utils.config import FedConfig
from tests.test_torch_robust import few_torch_threads  # noqa: F401 (autouse)
from tests.test_torch_zoo import assert_tree_close

HW, BS, LR = 8, 4, 0.1
SIZES = (6, 3, 5, 8)


def make_data(mod):
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
    base = dict(model="resnet20", dataset="cifar10",
                client_num_in_total=len(SIZES),
                client_num_per_round=len(SIZES), comm_round=2, epochs=1,
                batch_size=BS, lr=LR, frequency_of_the_test=100,
                server_optimizer="adam", server_lr=0.01)
    return cls(**{**base, **kw})


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def flat_np(tree):
    return np.concatenate([np.asarray(a, np.float32).ravel()
                           for a in jax.tree.leaves(tree)])


@functools.lru_cache(maxsize=None)
def jax_bn(train_dtype=None):
    """(JAX trainer, jitted train_step, f32 init variables) of ResNet-20."""
    tr = JaxClientTrainer(jax_create_model("resnet20", 10), lr=LR,
                          train_dtype=train_dtype or jnp.float32)
    x = jnp.asarray(make_data(jfed).client_shards["x"][0, 0])
    v = jax.tree.map(np.asarray, jax.jit(lambda a: tr.init(
        jax.random.PRNGKey(0), a))(x))
    return tr, jax.jit(tr.train_step), v


def jax_steps(variables, shard, train_dtype=None, x64=True, stats_dtype=None):
    """The JAX trainer's train_step over a shard's batches, in f64 (x64) or
    as given; with `stats_dtype` the statistics are cast back to it after
    each step.  Returns ([state after each step], [loss of each step])."""
    tr, step, _ = jax_bn(train_dtype)
    states, losses = [], []
    with jax.enable_x64(x64):
        state = TrainState(variables=variables,
                           opt_state=tr.init_opt(variables),
                           rng=jax.random.PRNGKey(0))
        for b in range(shard["mask"].shape[0]):
            state, loss = step(state, jax.tree.map(lambda a: a[b], shard))
            if stats_dtype is not None:
                state = state.replace(variables={
                    "params": state.variables["params"],
                    "batch_stats": jax.tree.map(
                        lambda a: a.astype(stats_dtype),
                        state.variables["batch_stats"])})
            states.append(jax.tree.map(np.asarray, state.variables))
            losses.append(float(loss))
    return states, losses


def jax_cohort_round(variables, cohort):
    """Every client trained by stepping (f64): (stacked variables, losses,
    sample counts)."""
    out = []
    for i in range(cohort["mask"].shape[0]):
        shard = jax.tree.map(lambda a: np.asarray(a[i]), cohort)
        states, losses = jax_steps(variables, shard)
        counts = shard["mask"].sum(axis=1)
        out.append((states[-1], (np.asarray(losses) * counts).sum()
                    / max(counts.sum(), 1.0), shard["mask"].sum()))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[o[0] for o in out])
    return stacked, np.asarray([o[1] for o in out]), np.asarray(
        [o[2] for o in out], np.float64)


def port_bn(**kw):
    return ClientTrainer(create_model("resnet20", 10), lr=LR, **kw)


def shard_of(client, mod=tfed):
    shards = make_data(jfed).client_shards
    return {k: (torch.tensor(v[client]) if mod is tfed else v[client])
            for k, v in shards.items()}


# ---------------------------------------------------------------------------
# BatchNorm statistics in the trainer
# ---------------------------------------------------------------------------

def test_flat_layout_is_params_then_statistics():
    tt = port_bn()
    names = list(tt.spec.names)
    assert names == list(tt.param_names) + list(tt.stat_names)
    assert all(n.endswith((".mean", ".var")) for n in tt.stat_names)
    assert (tt.n_params, tt.n_stats) == (272_474, 1_568)
    assert tt.train_len == tt.n_params and tt.spec.padded % 512 == 0
    v = tt.init(torch.Generator().manual_seed(0), "cpu")
    flat = tt.flatten(v)
    assert not flat[tt.spec.n:].any()
    assert all(torch.equal(a, v[k]) for k, a in tt.unflatten(flat).items())


def test_bn_step_counts_pad_rows_and_an_empty_batch_keeps_the_stats():
    """Client 1: a batch of 3 samples + 1 padding row, then an all-padding
    batch.  The padding row enters the batch statistics (flax's BatchNorm
    sees the whole batch); the empty batch keeps params and statistics
    bitwise and reports loss 0."""
    _, _, v = jax_bn()
    shard = shard_of(1)
    assert shard["mask"].sum(dim=1).tolist() == [3.0, 0.0]
    states, losses = jax_steps(f64(v), shard_of(1, jfed))
    tt = port_bn()
    flat0 = tt.flatten(flax_to_torch(v))
    batch = lambda b: {k: t[b] for k, t in shard.items()}
    flat1, opt, loss1 = tt.train_step(flat0, batch(0))
    got = torch_to_flax(tt.unflatten(flat1))
    for col in ("params", "batch_stats"):
        assert_tree_close(got[col], states[0][col])
    assert float(loss1) == pytest.approx(losses[0], rel=1e-5)

    # the first BatchNorm's mean: 0.1 x the mean over all 4 rows of its
    # conv output (the padding row's is zero: no bias, zero input)
    conv = torch.nn.functional.conv2d(batch(0)["x"].permute(0, 3, 1, 2),
                                      flax_to_torch(v)["Conv_0.weight"],
                                      padding=1)
    assert not conv[3].any()
    np.testing.assert_allclose(got["batch_stats"]["BatchNorm_0"]["mean"],
                               0.1 * conv.mean(dim=(0, 2, 3)).detach().numpy(),
                               rtol=1e-5, atol=1e-7)

    flat2, _, loss2 = tt.train_step(flat1, batch(1), opt)
    assert torch.equal(flat2, flat1) and float(loss2) == 0.0
    for a, b in zip(jax.tree.leaves(states[1]), jax.tree.leaves(states[0])):
        np.testing.assert_array_equal(a, b)               # JAX keeps them too


def test_eval_uses_the_running_statistics():
    _, _, v = jax_bn()
    tr = jax_bn()[0]
    v = dict(v)
    v["batch_stats"] = jax.tree.map(lambda a: a + 0.5, v["batch_stats"])
    shard = make_data(jfed).test_global
    want = jax.tree.map(np.asarray, jax.jit(tr.evaluate)(v, shard))
    tt = port_bn()
    got = tt.evaluate(tt.flatten(flax_to_torch(v)),
                      {k: torch.tensor(a) for k, a in shard.items()})
    assert float(got["count"]) == float(want["count"])
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-5)


def test_bf16_compute_step_matches_jax_loosely_and_keeps_f32_stats():
    """train_dtype bf16 on f32 masters: params and x cast, the statistics
    f32; within 2x of JAX's own bf16-to-f32 distance over two steps."""
    _, _, v = jax_bn()
    shard = shard_of(0, jfed)
    want = jax_steps(v, shard, jnp.bfloat16, x64=False)[0][-1]
    ref32 = jax_steps(v, shard, x64=False)[0][-1]
    tt = port_bn(train_dtype=torch.bfloat16)
    flat = tt.flatten(flax_to_torch(v))
    flat, _, _ = tt.local_train(flat, shard_of(0), epochs=1)
    assert flat.dtype == torch.float32
    got = torch_to_flax(tt.unflatten(flat))
    noise = np.linalg.norm(flat_np(want) - flat_np(ref32))
    assert noise < np.linalg.norm(flat_np(ref32) - flat_np(v))
    assert np.linalg.norm(flat_np(got) - flat_np(want)) <= 2 * noise
    s_noise = np.linalg.norm(flat_np(want["batch_stats"])
                             - flat_np(ref32["batch_stats"]))
    assert np.linalg.norm(flat_np(got["batch_stats"])
                          - flat_np(want["batch_stats"])) <= 2 * s_noise


def test_bf16_local_masters_round_the_statistics_each_step():
    """bf16 local masters (cast_local casts every float leaf): the port's
    statistics live in the bf16 vector, each update computed in f32 from
    the bf16 values with the momentum rounded to bf16, then rounded back,
    which is JAX's train_step with the statistics cast back to bf16 after
    each step.  Within 2x of that run's distance to f32 masters."""
    _, _, v = jax_bn()
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    shard = shard_of(0, jfed)
    want = jax_steps(bf, shard, jnp.bfloat16, x64=False,
                     stats_dtype=jnp.bfloat16)[0][-1]
    ref32 = jax_steps(v, shard, x64=False)[0][-1]
    tt = port_bn(train_dtype=torch.bfloat16)
    flat = tt.flatten(flax_to_torch(v), torch.bfloat16)
    flat, _, _ = tt.local_train(flat, shard_of(0), epochs=1)
    assert flat.dtype == torch.bfloat16
    got = torch_to_flax(tt.unflatten(flat))
    for col in ("params", "batch_stats"):
        noise = np.linalg.norm(flat_np(want[col]) - flat_np(ref32[col]))
        assert np.linalg.norm(flat_np(got[col]) - flat_np(want[col])) \
            <= 2 * noise, col
    assert not np.array_equal(flat_np(got["batch_stats"]),
                              flat_np(v["batch_stats"]))


# ---------------------------------------------------------------------------
# the sequence axis, losses
# ---------------------------------------------------------------------------

VOCAB, T = 20, 6


def _lm_shard():
    """5 sequences of 6 tokens in 2 batches of 4, with <pad> = 0 runs."""
    rs = np.random.RandomState(4)
    x = rs.randint(1, VOCAB, (5, T))
    y = rs.randint(1, VOCAB, (5, T))
    y[0, 3:] = 0
    y[2, 1:] = 0
    sx, sy, sm = jfed.pad_to_batches(x, y, BS, n_batches=2)
    return {"x": sx, "y": sy, "mask": sm}


@pytest.mark.parametrize("ids", [dict(eval_ignore_id=0),
                                 dict(train_ignore_id=0)],
                         ids=["eval_ignore", "train_ignore"])
def test_time_axis_masks_match_jax(ids):
    """has_time_axis broadcasts the per-sample mask over [B, T] labels;
    eval_ignore_id drops <pad> from eval only, train_ignore_id from the
    training loss too."""
    kw = dict(hidden_size=16)
    jt = JaxClientTrainer(jax_create_model("rnn", VOCAB, vocab_size=VOCAB, **kw),
                          lr=0.5, has_time_axis=True, **ids)
    tt = ClientTrainer(create_model("rnn", VOCAB, vocab_size=VOCAB, **kw),
                       lr=0.5, has_time_axis=True, **ids)
    shard = _lm_shard()
    v = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(1),
                                         jnp.asarray(shard["x"][0])))
    jv, jloss, _ = jax.tree.map(np.asarray, jax.jit(
        lambda v, s: jt.local_train(v, s, jax.random.PRNGKey(0), 1))(v, shard))
    want = jax.tree.map(np.asarray, jax.jit(jt.evaluate)(jv, shard))
    tshard = {k: torch.tensor(a) for k, a in shard.items()}
    flat, loss, _ = tt.local_train(tt.flatten(flax_to_torch(v)), tshard, 1)
    got_v = torch_to_flax(tt.unflatten(flat))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got_v),
                            jax.tree.leaves(jv)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    got = tt.evaluate(tt.flatten(flax_to_torch(jv)), tshard)
    n_valid = int(((shard["y"] != 0) * shard["mask"][..., None]).sum())
    assert float(got["count"]) == float(want["count"]) == n_valid
    assert float(got["correct"]) == float(want["correct"])
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-5)


def test_loss_functions_match_jax():
    rs = np.random.RandomState(5)
    logits = rs.randn(6, 7).astype(np.float32) * 3
    labels = rs.randint(0, 7, 6)
    targets = (rs.rand(6, 7) < 0.3).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    t = lambda a: torch.tensor(a)
    pairs = [(ttrainer.masked_bce(t(logits), t(targets), t(mask)),
              jtrainer.masked_bce(logits, targets, mask)),
             (ttrainer.masked_focal_loss(t(logits), t(labels), t(mask)),
              jtrainer.masked_focal_loss(logits, labels, mask)),
             (ttrainer.focal_from_ce(t(np.abs(logits))),
              jtrainer.focal_from_ce(np.abs(logits)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("loss", ["bce", "focal"])
def test_bce_and_focal_training_and_eval_match_jax(loss):
    """Local training and eval sums with the bce loss (multi-hot tags and
    the top-tag hit metric) and the focal loss, on LR."""
    rs = np.random.RandomState(6)
    x = rs.rand(7, 12).astype(np.float32)
    y = ((rs.rand(7, 5) < 0.4).astype(np.float32) if loss == "bce"
         else rs.randint(0, 5, 7))
    sx, sy, sm = jfed.pad_to_batches(x, y, BS)
    shard = {"x": sx, "y": sy, "mask": sm}
    jt = JaxClientTrainer(jax_create_model("lr", 5), lr=0.5, loss=loss)
    tt = ClientTrainer(create_model("lr", 5, input_dim=12), lr=0.5, loss=loss)
    v = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(2),
                                         jnp.asarray(sx[0])))
    jv, jloss, _ = jax.tree.map(np.asarray, jax.jit(
        lambda v, s: jt.local_train(v, s, jax.random.PRNGKey(0), 2))(v, shard))
    want = jax.tree.map(np.asarray, jax.jit(jt.evaluate)(jv, shard))
    tshard = {k: torch.tensor(a) for k, a in shard.items()}
    flat, tloss, _ = tt.local_train(tt.flatten(flax_to_torch(v)), tshard, 2)
    got_v = torch_to_flax(tt.unflatten(flat))["params"]["Dense_0"]
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(got_v[k], jv["params"]["Dense_0"][k],
                                   rtol=1e-4, atol=1e-6)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    got = tt.evaluate(tt.flatten(flax_to_torch(jv)), tshard)
    for k in ("count", "correct"):
        assert float(got[k]) == float(want[k]), k
    assert float(got["loss_sum"]) == pytest.approx(float(want["loss_sum"]),
                                                   rel=1e-5)


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------

OPTIMIZERS = [dict(name="sgd", momentum=0.9), dict(name="sgd", momentum=0.9,
                                                   weight_decay=1e-2),
              dict(name="adam"), dict(name="adam", weight_decay=1e-2),
              dict(name="adamw", weight_decay=1e-2)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", OPTIMIZERS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_optimizer_steps_match_optax(kw, dtype):
    """Four steps from the same params and gradients, state carried on
    each side: f32 within rtol 1e-6, bf16 within one ulp."""
    kw = dict(kw)
    name = kw.pop("name")
    ref = jtrainer.make_optimizer(name, 0.05, **kw)
    ours = make_optimizer(name, 0.05, **kw)
    rs = np.random.RandomState(7)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p0 = rs.randn(300).astype(np.float32)
    jp, tp = jnp.asarray(p0, jdt), torch.tensor(p0).to(tdt)
    js, ts = ref.init(jp), ours.init(tp)
    for step in range(4):
        g = rs.randn(300).astype(np.float32) * 10.0 ** (step - 2)
        ju, js = ref.update(jnp.asarray(g, jdt), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ours.update(torch.tensor(g).to(tdt), ts, tp)
        tp = tp + tu
        assert tp.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_allclose(tp.float().numpy(),
                                       np.asarray(jp, np.float32),
                                       rtol=2.0 ** -7, atol=1e-30)


SCHEDULES = [dict(mode="poly", total_steps=10),
             dict(mode="cos", total_steps=10, warmup_steps=3),
             dict(mode="step", total_steps=10, iters_per_epoch=3,
                  lr_step_epochs=2),
             dict(mode="cos", total_steps=0)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["mode"])
def test_lr_schedules_match_jax(kw):
    ref = jtrainer.make_lr_schedule(base_lr=0.1, **kw)
    ours = ttrainer.make_lr_schedule(base_lr=0.1, **kw)
    for count in range(14):
        got = ours(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(ref(jnp.int32(count))),
                                           rel=1e-6, abs=1e-9)
    with pytest.raises(ValueError, match="unknown lr schedule"):
        ttrainer.make_lr_schedule("linear", 0.1, 10)


@pytest.mark.parametrize("name,momentum,sched", [
    ("sgd", 0.9, dict(mode="cos", total_steps=6)),
    ("adam", 0.0, dict(mode="poly", total_steps=6, warmup_steps=2)),
    ("adamw", 0.0, None)], ids=["sgd-cos", "adam-poly-warmup", "adamw"])
def test_stateful_optimizers_over_a_ragged_shard_match_jax(name, momentum,
                                                            sched):
    """local_train with an all-padding batch in the middle: the optimizer
    state freezes there but a schedule's step count still advances
    (tree_merge_counts), so the next real batch takes step 2's rate."""
    rs = np.random.RandomState(8)
    x = rs.rand(3, BS, 12).astype(np.float32)
    y = rs.randint(0, 5, (3, BS))
    mask = np.ones((3, BS), np.float32)
    mask[1] = 0.0
    mask[2, 3] = 0.0
    shard = {"x": x, "y": y, "mask": mask}
    lr = lambda mod: mod.make_lr_schedule(base_lr=0.2, **sched) if sched else 0.2
    kw = dict(optimizer=name, momentum=momentum,
              weight_decay=1e-2 if name == "adamw" else 0.0)
    jt = JaxClientTrainer(jax_create_model("lr", 5), lr=lr(jtrainer), **kw)
    tt = ClientTrainer(create_model("lr", 5, input_dim=12), lr=lr(ttrainer),
                       **kw)
    v = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(3),
                                         jnp.asarray(x[0])))
    jv, jloss, _ = jax.tree.map(np.asarray, jax.jit(
        lambda v, s: jt.local_train(v, s, jax.random.PRNGKey(0), 2))(v, shard))
    flat, loss, _ = tt.local_train(tt.flatten(flax_to_torch(v)),
                                   {k: torch.tensor(a) for k, a in shard.items()},
                                   2)
    got = torch_to_flax(tt.unflatten(flat))["params"]["Dense_0"]
    for k in ("kernel", "bias"):
        np.testing.assert_allclose(got[k], jv["params"]["Dense_0"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def test_trainer_raises_for_what_later_slices_bring():
    model = create_model("lr", 5, input_dim=12)
    # augmentation came with slice 3b (tests/test_torch_augment.py)
    aug = lambda generator, x: x
    assert ClientTrainer(model, augment=aug).augment is aug
    with pytest.raises(NotImplementedError, match="slice 6"):
        ClientTrainer(model, batch_axes=("batch",))
    with pytest.raises(ValueError, match="unknown loss"):
        ClientTrainer(model, loss="hinge")


# ---------------------------------------------------------------------------
# the engines fold the statistics
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_fedavg_chain():
    """Two JAX FedAvg rounds (f64): stepped training, then the engine's
    own aggregate, a sample-weighted mean over params and statistics."""
    eng = JaxFedAvgEngine(jax_bn()[0], make_data(jfed), make_cfg(JaxFedConfig),
                          donate=False)
    cohort = make_data(jfed).client_shards
    v, out = f64(jax_bn()[2]), []
    for r in range(2):
        stacked, losses, ns = jax_cohort_round(v, cohort)
        with jax.enable_x64(True):
            v, _ = eng.aggregate(stacked, jnp.asarray(ns), v, (),
                                 jax.random.PRNGKey(r))
            v = jax.tree.map(np.asarray, v)
        out.append((v, float((losses * ns).sum() / ns.sum())))
    return out


def test_mesh_fedavg_two_rounds_fold_the_statistics():
    """MeshFedAvgEngine, two chunks of 2 clients, ResNet-20: each round
    from JAX's model of the round before; params and statistics against
    JAX's round."""
    eng = MeshFedAvgEngine(port_bn(), make_data(tfed), make_cfg(FedConfig),
                           chunk=2, device="cpu")
    v = flax_to_torch(jax_bn()[2])
    for r, (want, want_loss) in enumerate(jax_fedavg_chain()):
        got, _, m = eng.round_fn(v, (), *eng._round_args(r))
        got = torch_to_flax(got)
        for col in ("params", "batch_stats"):
            assert_tree_close(got[col], want[col])
        assert float(m["train_loss"]) == pytest.approx(want_loss, rel=1e-5)
        v = flax_to_torch(f32(want))


@functools.lru_cache(maxsize=None)
def jax_one_round():
    """One round's trained cohort from JAX's init (f64)."""
    return jax_cohort_round(f64(jax_bn()[2]), make_data(jfed).client_shards)


def _update_norms(stacked, v):
    return np.sqrt(sum(((a - b[None]) ** 2).reshape(len(a), -1).sum(1)
                       for a, b in zip(jax.tree.leaves(stacked["params"]),
                                       jax.tree.leaves(v["params"]))))


def _expected(rule, stacked, ns, v, bound):
    """The JAX engines' aggregate for one round (f64)."""
    cfg = make_cfg(JaxFedConfig, norm_bound=bound)
    data, tr = make_data(jfed), jax_bn()[0]
    with jax.enable_x64(True):
        w = jnp.asarray(ns)
        if rule == "fedopt":
            eng = JaxFedOptEngine(tr, data, cfg, donate=False)
            new, _ = eng.aggregate(stacked, w, v, eng.server_init(v),
                                   jax.random.PRNGKey(0))
        elif rule in ("norm_clip", "median"):
            eng = JaxFedAvgRobustEngine(tr, data, cfg, defense=rule,
                                        donate=False)
            new, _ = eng.aggregate(stacked, w, v, (), jax.random.PRNGKey(0))
        else:                                         # fednova
            taus = np.asarray([float(jax_fednova_tau(
                {"mask": jnp.asarray(m)}, 1)) for m in data.client_shards["mask"]])
            p = ns / ns.sum()
            tau_eff = (p * taus).sum()
            nova = lambda g, s: g - tau_eff * np.einsum(
                "k,k...->...", p / np.maximum(taus, 1.0), g[None] - s)
            new = {"params": jax.tree.map(nova, v["params"], stacked["params"]),
                   "batch_stats": tree_weighted_mean(stacked["batch_stats"], w)}
        return jax.tree.map(np.asarray, new)


ENGINES = {"MeshFedOptEngine": ("fedopt", MeshFedOptEngine, {"chunk": 2}),
           "FedOptEngine": ("fedopt", FedOptEngine, {}),
           "MeshRobustEngine-norm_clip": ("norm_clip", MeshRobustEngine,
                                          {"chunk": 2, "defense": "norm_clip"}),
           "FedAvgRobustEngine-norm_clip": ("norm_clip", FedAvgRobustEngine,
                                            {"defense": "norm_clip"}),
           "MeshRobustEngine-median": ("median", MeshRobustEngine,
                                       {"chunk": 2, "defense": "median"}),
           "MeshFedNovaEngine": ("fednova", MeshFedNovaEngine, {"chunk": 2}),
           "FedNovaEngine": ("fednova", FedNovaEngine, {})}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_rules_apply_to_params_and_statistics_take_the_plain_mean(engine):
    """FedOpt (adam), norm clip (a bound that clips some clients and not
    others), median and FedNova apply their rule to the parameters only;
    the statistics come out as the plain sample-weighted mean of the
    clients' statistics, as in the JAX engines."""
    rule, cls, kw = ENGINES[engine]
    v = f64(jax_bn()[2])
    stacked, _, ns = jax_one_round()
    norms = _update_norms(stacked, v)
    bound = float(np.median(norms))
    assert (norms > bound).any() and (norms < bound).any()
    want = _expected(rule, stacked, ns, v, bound)
    plain_mean = jax.tree.map(lambda s: np.einsum("k,k...->...", ns / ns.sum(),
                                                  s), stacked["batch_stats"])
    for a, b in zip(jax.tree.leaves(want["batch_stats"]),
                    jax.tree.leaves(plain_mean)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    eng = cls(port_bn(), make_data(tfed), make_cfg(FedConfig, norm_bound=bound),
              device="cpu", **kw)
    v0 = flax_to_torch(jax_bn()[2])
    got, _, _ = eng.round_fn(v0, eng.server_init(v0), *eng._round_args(0))
    got = torch_to_flax(got)
    assert_tree_close(got["batch_stats"], plain_mean)
    assert_tree_close(got["params"], want["params"])
