"""FedSeg in the PyTorch port against the JAX package: the confusion
matrix and the four metrics, the metrics keeper, the segmentation net
with its transposed convolutions (and the converter's mapping of them),
and one round of the engine with its evaluation.

Sizes: SegEncoderDecoder(width=8) on 16x16 images, 3 classes plus VOC's
void label 255, 4 clients of 1-2 batches of 4.  Tolerances: the confusion
matrix bitwise on the same predictions; the metrics within 1e-6 on the
same matrix; model outputs within rtol 1e-4 / atol 1e-5; trained f32
leaves within atol 1e-4 / rtol 1e-3 and the train loss within rel 1e-4
(as tests/test_torch_fedavg.py).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedseg import FedSegEngine as JaxFedSeg
from fedml_tpu.core import seg_metrics as jsm
from fedml_tpu.core.trainer import ClientTrainer as JaxClientTrainer
from fedml_tpu.data import federated as jfed
from fedml_tpu.models.segnet import SegEncoderDecoder as JaxSegNet
from fedml_tpu.utils.config import FedConfig as JaxFedConfig
from fedml_tpu_torch.algorithms.fedseg import FedSegEngine
from fedml_tpu_torch.convert import flax_to_torch, torch_to_flax
from fedml_tpu_torch.core import seg_metrics as sm
from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.segnet import ConvTranspose, SegEncoderDecoder
from fedml_tpu_torch.utils.config import FedConfig

torch.set_num_threads(2)
C, HW, BS, NCLS, VOID = 4, 16, 4, 3, 255
METRICS = ("pixel_accuracy", "pixel_accuracy_class", "mean_iou",
           "frequency_weighted_iou")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_matrix_bitwise_on_the_same_predictions(seed):
    rs = np.random.RandomState(seed)
    pred = rs.randint(0, NCLS, (6, HW, HW))
    label = rs.randint(0, NCLS, (6, HW, HW))
    label[rs.rand(6, HW, HW) < 0.1] = VOID
    label[0, 0, :3] = -1                          # out of range below too
    mask = np.broadcast_to((np.arange(6) < 5).astype(np.float32)[:, None, None],
                           label.shape)
    want = np.asarray(jsm.confusion_matrix(jnp.asarray(pred),
                                           jnp.asarray(label),
                                           jnp.asarray(mask), NCLS))
    got = sm.confusion_matrix(torch.tensor(pred), torch.tensor(label),
                              torch.tensor(mask), NCLS)
    assert got.dtype == torch.int64 and got.shape == (NCLS, NCLS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((label >= 0) & (label < NCLS)
                                  & (mask > 0)).sum())


@pytest.mark.parametrize("cm", [
    [[50, 2, 3], [4, 40, 6], [1, 0, 30]],
    [[10, 0, 0], [0, 0, 0], [5, 0, 2]],          # an absent class
    [[0, 0], [0, 0]],                            # empty
    [[1234567, 89], [3, 7654321]],
])
def test_metrics_match_jax_on_a_fixed_matrix(cm):
    cm = np.asarray(cm, np.float64)
    for name in METRICS:
        got = getattr(sm, name)(cm)
        want = getattr(jsm, name)(cm.astype(np.float32))
        assert isinstance(got, float)
        assert got == pytest.approx(want, abs=1e-6), name


def test_metrics_keeper_matches_jax():
    ours, ref = sm.EvaluationMetricsKeeper(), jsm.EvaluationMetricsKeeper()
    for r, m in enumerate([{"acc": 0.5, "mIoU": 0.2, "name": "x"},
                           {"acc": 0.4, "mIoU": 0.3},
                           {"acc": 0.7, "mIoU": 0.1}]):
        ours.update(r, m)
        ref.update(r, m)
    assert ours.best == ref.best and ours.history == ref.history
    assert ours.summary() == ref.summary()


# ---------------------------------------------------------------------------
# the model and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,cin,cout", [(2, 4, 3), (2, 8, 8), (3, 2, 5)])
def test_one_conv_transpose_layer_matches_flax(k, cin, cout):
    """flax applies its ConvTranspose kernel unflipped, PyTorch flipped:
    the converter flips both spatial axes and lays it out (in, out, kh, kw)."""
    x = np.random.RandomState(k).rand(2, 5, 6, cin).astype(np.float32)
    layer = nn.ConvTranspose(cout, (k, k), strides=(k, k))
    v = jax.tree.map(np.asarray, layer.init(jax.random.PRNGKey(k), x))
    want = np.asarray(layer.apply(v, x))
    ours = ConvTranspose(cin, cout, k)
    state = {n.split(".", 1)[1]: t for n, t in flax_to_torch(
        {"ConvTranspose_0": v["params"]}).items()}
    assert state["weight"].shape == (cin, cout, k, k)
    got = torch.func.functional_call(ours, state, (torch.tensor(
        x).permute(0, 3, 1, 2),)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    unflipped = torch.func.functional_call(ours, {
        "weight": torch.tensor(v["params"]["kernel"]).permute(2, 3, 0, 1),
        "bias": state["bias"]}, (torch.tensor(x).permute(0, 3, 1, 2),))
    assert not np.allclose(unflipped.permute(0, 2, 3, 1).detach().numpy(), want,
                           atol=1e-3)


@pytest.fixture(scope="module")
def segnet_vars():
    x = np.random.RandomState(0).rand(2, HW, HW, 3).astype(np.float32)
    model = JaxSegNet(num_classes=NCLS, width=8)
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), x)), x


def test_segnet_matches_flax_and_round_trips(segnet_vars):
    model, v, x = segnet_vars
    state = flax_to_torch(v)
    assert state["ConvTranspose_0.weight"].shape == (32, 16, 2, 2)
    ours = SegEncoderDecoder(NCLS, width=8)
    assert {k: tuple(t.shape) for k, t in state.items()} == {
        k: tuple(t.shape) for k, t in ours.named_parameters()}
    got = torch.func.functional_call(ours, state, (torch.tensor(x),))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(model.apply(v, x)),
                               rtol=1e-4, atol=1e-5)
    back = torch_to_flax(state)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_segnet_gradients_match_flax(segnet_vars):
    model, v, x = segnet_vars
    y = np.random.RandomState(1).randint(0, NCLS, (2, HW, HW))

    def loss(p):
        logits = model.apply({"params": p}, x)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                             y[..., None], -1))
    want = flax_to_torch(jax.tree.map(np.asarray,
                                      jax.jit(jax.grad(loss))(v["params"])))
    ours = SegEncoderDecoder(NCLS, width=8)
    state = {k: t.requires_grad_() for k, t in flax_to_torch(v).items()}
    logits = torch.func.functional_call(ours, state, (torch.tensor(x),))
    torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2),
                                      torch.tensor(y)).backward()
    for k, t in state.items():
        np.testing.assert_allclose(t.grad.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_create_model_builds_segnet():
    m = create_model("segnet", 21)
    assert isinstance(m, SegEncoderDecoder)
    assert sum(p.numel() for p in m.parameters()) == 181_813
    assert [g.num_groups for g in (m.GroupNorm_0, m.GroupNorm_4)] == [4, 4]
    # "darts" builds too now, with its algorithm (fednas) ported
    assert type(create_model("darts", 10)).__name__ == "DartsNetwork"


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _data(mod):
    rs = np.random.RandomState(0)
    sizes = (8, 5, 4, 7)
    n = sum(sizes)
    x = rs.rand(n, HW, HW, 3).astype(np.float32)
    y = np.minimum((x > 0.5).sum(-1), NCLS - 1).astype(np.int64)
    y[rs.rand(n, HW, HW) < 0.05] = VOID
    ends = np.cumsum(sizes)
    idx = {i: np.arange(e - s, e) for i, (s, e) in enumerate(zip(sizes, ends))}
    ev = mod.build_eval_shard(x[:10], y[:10], BS)
    return mod.FederatedData(
        train_data_num=n, test_data_num=10, train_global=ev, test_global=ev,
        client_shards=mod.build_client_shards(x, y, idx, BS),
        client_num_samples=np.asarray(sizes, np.float32),
        test_client_shards=None, class_num=NCLS)


def _cfg(cls):
    return cls(client_num_in_total=C, client_num_per_round=3, comm_round=1,
               epochs=1, batch_size=BS, lr=0.05, frequency_of_the_test=100)


def test_fedseg_round_and_metrics_match_jax():
    jtr = JaxClientTrainer(JaxSegNet(num_classes=NCLS, width=8), lr=0.05,
                           has_time_axis=True, train_ignore_id=VOID)
    jeng = JaxFedSeg(jtr, _data(jfed), _cfg(JaxFedConfig), donate=False)
    v0 = jax.tree.map(np.asarray, jeng.init_variables())
    want = jax.tree.map(np.asarray, jeng.run(
        variables=jax.tree.map(jnp.asarray, v0), rounds=1))
    trainer = ClientTrainer(SegEncoderDecoder(NCLS, width=8), lr=0.05,
                            has_time_axis=True, train_ignore_id=VOID)
    eng = FedSegEngine(trainer, _data(tfed), _cfg(FedConfig), device="cpu")
    got = eng.run(variables=flax_to_torch(v0), rounds=1)
    g_tree, w_tree = dict(jax.tree_util.tree_leaves_with_path(torch_to_flax(got))), \
        dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(g_tree) == set(w_tree)
    for path, a in w_tree.items():
        np.testing.assert_allclose(g_tree[path], a, rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    g, w = eng.metrics_history[-1], jeng.metrics_history[-1]
    assert g["train_loss"] == pytest.approx(w["train_loss"], rel=1e-4)
    # the evaluation of the same weights: every metric of both splits
    got_m, want_m = eng.evaluate(flax_to_torch(want)), jeng.evaluate(want)
    assert set(got_m) == set(want_m) == {
        f"{s}_{m}" for s in ("train", "test")
        for m in ("acc", "acc_class", "mIoU", "FWIoU")}
    for k in want_m:
        assert got_m[k] == pytest.approx(want_m[k], abs=1e-6), k
    assert eng.metrics_keeper.best["test_acc"] >= got_m["test_acc"] - 1e-9
    assert len(eng.metrics_keeper.history) == 2
