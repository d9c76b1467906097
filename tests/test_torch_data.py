"""The data layer of the PyTorch port against the JAX package, bitwise.

Both packages' data layers are host-side numpy, so every array the port
builds must equal the JAX package's byte for byte (dtype and shape
included): partitions, topologies, synthetic stand-ins, quantized stacks,
token ids, poisoned shards, and every array of the ``FederatedData`` that
``load_data`` returns, on the stand-ins (at a small ``synthetic_scale`` and
few clients: the StackOverflow default of 342,477 clients is never built
here) and on tiny files the tests write in each real on-disk format (LEAF
JSON, TFF h5 through h5py, CIFAR pickles, image folders through PIL, CSV).
The cases mirror the JAX oracles ``tests/test_readers.py``,
``test_data_extended.py`` and ``test_edge_poison.py``.
"""
import ast
import csv
import json
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fedml_tpu.data as jdata
from fedml_tpu.core import partition as jpartition
from fedml_tpu.core import topology as jtopology
from fedml_tpu.data import loaders as jloaders
from fedml_tpu.data import mobile as jmobile
from fedml_tpu.data import poison as jpoison
from fedml_tpu.data import quant as jquant
from fedml_tpu.data import readers as jreaders
from fedml_tpu.data import synthetic as jsynthetic
from fedml_tpu.data import text as jtext
import fedml_tpu_torch.data as tdata
from fedml_tpu_torch.core import partition, topology
from fedml_tpu_torch.data import (loaders, mobile, poison, quant, readers,
                                  synthetic, text)
from tests.test_torch_robust import few_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def same(a, b, what=""):
    """Bitwise equality of two numpy arrays (or nested dicts, lists and
    tuples of them, and scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), what
        for k in a:
            same(a[k], b[k], f"{what}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (what, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def same_data(got, want):
    """Every field of two FederatedData objects, bitwise."""
    assert type(got).__module__.startswith("fedml_tpu_torch")
    for f in ("train_data_num", "test_data_num", "class_num", "synthetic",
              "train_global", "test_global", "client_shards",
              "client_num_samples", "test_client_shards"):
        same(getattr(got, f), getattr(want, f), f)
    if want.x_dequant is None:
        assert got.x_dequant is None
    else:
        same(got.x_dequant.scale, want.x_dequant.scale, "scale")
        same(got.x_dequant.offset, want.x_dequant.offset, "offset")
    same(got.as_8tuple(), want.as_8tuple(), "as_8tuple")


# ---------------------------------------------------------------------------
# the package boundary
# ---------------------------------------------------------------------------

def test_data_package_exports_what_the_jax_one_does():
    assert tdata.__all__ == jdata.__all__
    assert all(callable(getattr(tdata, n)) for n in tdata.__all__)


def _module_top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_h5py_and_pil_are_imported_lazily():
    """A machine without h5py or PIL must still load data: importing them
    at module top would break load_data (and chip_smoke.py) there."""
    for f in (REPO / "fedml_tpu_torch" / "data").glob("*.py"):
        assert not {"h5py", "PIL"} & _module_top_imports(f), f.name


@pytest.mark.parametrize("call", [
    lambda d: readers.read_tff_h5(os.path.join(d, "none.h5"), ("x",)),
    lambda d: readers.read_imagenet_h5(os.path.join(d, "none.hdf5")),
    lambda d: readers.read_image_folder(d),
    lambda d: readers.read_voc_pairs(d),
    lambda d: readers.read_landmarks_csv(d, "none.csv"),
], ids=["tff_h5", "imagenet_h5", "image_folder", "voc", "landmarks"])
def test_absent_files_fall_back_without_h5py_or_pil(call, tmp_path,
                                                     monkeypatch):
    """A missing file raises FileNotFoundError (the stand-in's trigger)
    before h5py or PIL is imported, so it holds where neither exists."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(FileNotFoundError):
        call(str(tmp_path))
    d = loaders.load_data("femnist", data_dir=str(tmp_path),
                          client_num_in_total=3, batch_size=4,
                          synthetic_scale=0.001)
    assert d.synthetic


def test_load_data_returns_host_numpy():
    d = loaders.load_data("cifar10", client_num_in_total=2, batch_size=4,
                          synthetic_scale=0.001)
    for shard in (d.client_shards, d.train_global, d.test_global):
        assert all(isinstance(v, np.ndarray) for v in shard.values())
    assert d._device_cache == {}


# ---------------------------------------------------------------------------
# core/partition.py and core/topology.py
# ---------------------------------------------------------------------------

def _labels(n, classes, seed):
    return np.random.RandomState(seed).randint(0, classes, n)


@pytest.mark.parametrize("seed,n,clients", [(0, 100, 4), (3, 257, 9),
                                            (7, 30, 12)])
def test_partition_homo_and_power_law_bitwise(seed, n, clients):
    same(partition.partition_homo(n, clients, seed),
         jpartition.partition_homo(n, clients, seed))
    y = _labels(n, 10, seed)
    if n >= 10 * clients:
        same(partition.partition_power_law(y, clients, seed),
             jpartition.partition_power_law(y, clients, seed))
    same(partition.partition_power_law(y, clients, seed, min_per_client=1),
         jpartition.partition_power_law(y, clients, seed, min_per_client=1))


@pytest.mark.parametrize("seed,alpha,clients,n", [
    (0, 0.5, 4, 200), (1, 0.1, 8, 300), (2, 5.0, 3, 90), (4, 0.05, 10, 60)])
def test_partition_dirichlet_and_stats_bitwise(seed, alpha, clients, n):
    y = _labels(n, 10, seed + 10)
    got = partition.partition_dirichlet(y, clients, alpha, seed=seed)
    want = jpartition.partition_dirichlet(y, clients, alpha, seed=seed)
    same(got, want)
    assert partition.record_data_stats(y, got) == \
        jpartition.record_data_stats(y, want)


@pytest.mark.parametrize("n,k,seed", [(2, 2, 0), (6, 2, 1), (9, 4, 2),
                                      (12, 5, 3)])
def test_topologies_bitwise(n, k, seed):
    for ours, ref in (
            (topology.SymmetricTopologyManager(n, k, seed),
             jtopology.SymmetricTopologyManager(n, k, seed)),
            (topology.AsymmetricTopologyManager(n, k + 1, 0.4, seed),
             jtopology.AsymmetricTopologyManager(n, k + 1, 0.4, seed))):
        same(ours.mixing_matrix(), ref.mixing_matrix())
        for i in range(n):
            assert ours.get_in_neighbor_idx_list(i) == \
                ref.get_in_neighbor_idx_list(i)
            assert ours.get_out_neighbor_idx_list(i) == \
                ref.get_out_neighbor_idx_list(i)
            same(ours.get_in_neighbor_weights(i), ref.get_in_neighbor_weights(i))
            same(ours.get_out_neighbor_weights(i),
                 ref.get_out_neighbor_weights(i))
        np.testing.assert_allclose(ours.topology.sum(1), 1.0)


# ---------------------------------------------------------------------------
# data/synthetic.py and data/quant.py
# ---------------------------------------------------------------------------

SYNTHETIC = {
    "fedprox": ("synthetic_fedprox", (0.5, 0.5), {"n_clients": 4, "dim": 12}),
    "fedprox_1_1": ("synthetic_fedprox", (1.0, 1.0), {"n_clients": 3}),
    "images": ("synthetic_classification_images", (40, (8, 6), 3, 5), {}),
    "images_flat": ("synthetic_classification_images", (30, (7, 7), 1, 4),
                    {"flat": True}),
    "segmentation": ("synthetic_segmentation", (6, (8, 8), 21), {}),
    "sequences": ("synthetic_sequences", (50, 9, 31), {}),
    "sequences_classed": ("synthetic_sequences_classed", (60, 7, 503),
                          {"n_classes": 64}),
    "multilabel": ("synthetic_multilabel", (40, 50, 7), {}),
    "tabular": ("synthetic_tabular", (60, 5), {"n_classes": 3}),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_generators_bitwise(name, seed):
    fn, args, kw = SYNTHETIC[name]
    same(getattr(synthetic, fn)(*args, seed=seed, **kw),
         getattr(jsynthetic, fn)(*args, seed=seed, **kw))


def test_quant_specs_and_round_trip_bitwise():
    rs = np.random.RandomState(0)
    mean, std = loaders.CIFAR10_MEAN, loaders.CIFAR10_STD
    for ours, ref in ((quant.spec_from_normalize(mean, std),
                       jquant.spec_from_normalize(mean, std)),):
        same(ours.scale, ref.scale)
        same(ours.offset, ref.offset)
    raw = rs.randint(0, 256, (5, 4, 4, 3)).astype(np.uint8)
    x = readers.normalize_image(raw.astype(np.float32) / 255.0, mean, std)
    spec = quant.spec_from_normalize(mean, std)
    same(quant.quantize_uint8(x, spec), raw)       # the raw pixels, exactly
    same(quant.dequantize(raw, spec),
         jquant.dequantize(raw, jquant.spec_from_normalize(mean, std)))
    for arr in (rs.randn(7, 3).astype(np.float32) * 3,
                np.full((4,), 2.5, np.float32), np.zeros((0,), np.float32)):
        ours, ref = quant.spec_from_minmax(arr), jquant.spec_from_minmax(arr)
        same(ours.scale, ref.scale)
        same(ours.offset, ref.offset)
        same(quant.quantize_uint8(arr, ours), jquant.quantize_uint8(arr, ref))
        same(quant.dequantize(quant.quantize_uint8(arr, ours), ours),
             jquant.dequantize(jquant.quantize_uint8(arr, ref), ref))
    with pytest.raises(ValueError, match="non-finite"):
        quant.spec_from_minmax(np.asarray([0.0, np.inf], np.float32))


# ---------------------------------------------------------------------------
# data/text.py
# ---------------------------------------------------------------------------

def test_char_luts_and_shakespeare_arrays_bitwise():
    s = ["The quick.\nBROWN fox?~", "ab", "é\r"]
    same(text.chars_to_ids(s), jtext.chars_to_ids(s))
    same(text.chars_to_ids(s, width=5), jtext.chars_to_ids(s, width=5))
    same(text.chars_to_ids(s, text._TFF_LUT), jtext.chars_to_ids(s, jtext._TFF_LUT))
    window = ("the cat sat on the mat ~ é " * 4)[:80]
    ud = {f"u{i}": {"x": [window, window[::-1]], "y": ["a", "~"]}
          for i in range(3)}
    same(text.leaf_shakespeare_to_arrays(list(ud), ud),
         jtext.leaf_shakespeare_to_arrays(list(ud), ud))
    for snippets in (["a" * 100, "to be or not", ""], []):
        same(text.tff_snippets_to_sequences(snippets),
             jtext.tff_snippets_to_sequences(snippets))
        same(text.tff_snippets_to_sequences(snippets, 9),
             jtext.tff_snippets_to_sequences(snippets, 9))


def test_stackoverflow_vocabularies_and_arrays_bitwise(tmp_path):
    _write_so_vocab(tmp_path)
    _write_tag_count(tmp_path)
    for mod in (text, jtext):
        with pytest.raises(FileNotFoundError):
            mod.read_word_count_vocab(str(tmp_path / "none"))
    words = text.read_word_count_vocab(str(tmp_path / "stackoverflow.word_count"), 3)
    assert words == jtext.read_word_count_vocab(
        str(tmp_path / "stackoverflow.word_count"), 3)
    tags = text.read_tag_count_vocab(str(tmp_path / "stackoverflow.tag_count"), 2)
    assert tags == jtext.read_tag_count_vocab(
        str(tmp_path / "stackoverflow.tag_count"), 2)
    wv, jwv = text.WordVocab(words), jtext.WordVocab(words)
    assert (wv.pad_id, wv.bos_id, wv.eos_id, wv.oov_id, wv.vocab_len) == \
        (jwv.pad_id, jwv.bos_id, jwv.eos_id, jwv.oov_id, jwv.vocab_len)
    sents = ["the zebra of", "a b a b a b a b the the", ""]
    same(wv.sentences_to_xy(sents, 5), jwv.sentences_to_xy(sents, 5))
    bw, jbw = text.BagOfWordsVocab(words), jtext.BagOfWordsVocab(words)
    same(bw.sentences_to_features(sents), jbw.sentences_to_features(sents))
    same(bw.sentences_to_features([]), jbw.sentences_to_features([]))
    tv, jtv = text.TagVocab(tags), jtext.TagVocab(tags)
    same(tv.tags_to_targets(["jax|python|cuda", "tpu"]),
         jtv.tags_to_targets(["jax|python|cuda", "tpu"]))
    cl = {f"so{i}": {"tokens": np.array([b"the code of and", b"and the"]),
                     "title": np.array([b"and", b"code"]),
                     "tags": np.array([b"python|tpu", b"jax"])}
          for i in (2, 0, 1)}
    same(text.stackoverflow_nwp_arrays(cl, wv, 6, max_clients=2),
         jtext.stackoverflow_nwp_arrays(cl, jwv, 6, max_clients=2))
    same(text.stackoverflow_lr_arrays(cl, bw, tv),
         jtext.stackoverflow_lr_arrays(cl, jbw, jtv))


# ---------------------------------------------------------------------------
# tiny files in the real on-disk formats
# ---------------------------------------------------------------------------

def _write_leaf(dirname, user_data, name="all_data.json"):
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, name), "w") as f:
        json.dump({"users": list(user_data), "user_data": user_data}, f)


def _write_h5(path, clients):
    import h5py
    with h5py.File(path, "w") as f:
        ex = f.create_group("examples")
        for cid, feats in clients.items():
            g = ex.create_group(cid)
            for k, v in feats.items():
                g.create_dataset(k, data=v)


def _write_so_vocab(tmp_path, words=("the", "of", "and", "code")):
    with open(str(tmp_path / "stackoverflow.word_count"), "w") as f:
        for i, w in enumerate(words):
            f.write(f"{w} {1000 - i}\n")


def _write_tag_count(tmp_path):
    with open(str(tmp_path / "stackoverflow.tag_count"), "w") as f:
        json.dump({"python": 900, "jax": 800, "tpu": 700}, f)


def _write_cifar(root, sub, names, n, label_key=b"labels", classes=10,
                 seed=0):
    rng = np.random.RandomState(seed)
    d = root / sub
    os.makedirs(str(d), exist_ok=True)
    for name in names:
        blob = {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                label_key: rng.randint(0, classes, n).tolist()}
        with open(str(d / name), "wb") as f:
            pickle.dump(blob, f)


CIFAR10_FILES = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]


def _write_image_folder(root, splits=("train", "test"), classes=("cat", "dog"),
                        per=3, hw=(32, 32)):
    from PIL import Image
    rng = np.random.RandomState(1)
    for split in splits:
        for cname in classes:
            d = root / split / cname
            os.makedirs(str(d), exist_ok=True)
            for j in range(per):
                Image.fromarray(rng.randint(0, 256, hw + (3,)).astype(
                    np.uint8)).save(str(d / f"{j}.png"))


def _mnist_files(tmp_path):
    rng = np.random.RandomState(0)
    ud = {f"u{i}": {"x": rng.rand(5 + i, 784).tolist(),
                    "y": rng.randint(0, 10, 5 + i).tolist()} for i in range(4)}
    _write_leaf(str(tmp_path / "train"), ud)
    _write_leaf(str(tmp_path / "test"), ud)


def _synthetic_leaf_files(tmp_path):
    rng = np.random.RandomState(0)
    ud = {f"f_{i:05d}": {"x": rng.randn(5, 60).tolist(),
                         "y": rng.randint(0, 10, 5).astype(float).tolist()}
          for i in range(4)}
    _write_leaf(str(tmp_path / "train"), ud, "mytrain.json")
    _write_leaf(str(tmp_path / "test"), ud, "mytest.json")


def _shakespeare_files(tmp_path):
    snip = "the cat sat on the mat and then the dog sat on the log again now"
    window = (snip * 3)[:80]
    ud = {f"u{i}": {"x": [window, window[::-1], window], "y": ["a", "b", "~"]}
          for i in range(2)}
    _write_leaf(str(tmp_path / "train"), ud)
    _write_leaf(str(tmp_path / "test"), ud)


def _femnist_files(tmp_path):
    rng = np.random.RandomState(0)
    cl = {f"f_{i:05d}": {"pixels": rng.rand(5 + i, 28, 28).astype(np.float32),
                         "label": rng.randint(0, 62, 5 + i)} for i in range(3)}
    _write_h5(str(tmp_path / "fed_emnist_train.h5"), cl)
    _write_h5(str(tmp_path / "fed_emnist_test.h5"), cl)


def _fed_cifar100_files(tmp_path):
    rng = np.random.RandomState(0)
    cl = {f"c{i}": {"image": rng.randint(0, 256, (4, 32, 32, 3)).astype(
        np.uint8), "label": rng.randint(0, 100, 4)} for i in range(3)}
    _write_h5(str(tmp_path / "fed_cifar100_train.h5"), cl)
    _write_h5(str(tmp_path / "fed_cifar100_test.h5"), cl)


def _fed_shakespeare_files(tmp_path):
    cl = {f"s{i}": {"snippets": np.array([b"to be or not to be " * (4 + i),
                                          b"that is ~ the question"])}
          for i in range(2)}
    _write_h5(str(tmp_path / "shakespeare_train.h5"), cl)
    _write_h5(str(tmp_path / "shakespeare_test.h5"), cl)


def _stackoverflow_files(tmp_path):
    _write_so_vocab(tmp_path)
    _write_tag_count(tmp_path)
    cl = {f"so{i}": {"tokens": np.array([b"the code of and", b"and the zebra"]),
                     "title": np.array([b"and", b"code"]),
                     "tags": np.array([b"python|tpu", b"jax"])}
          for i in range(3)}
    _write_h5(str(tmp_path / "stackoverflow_train.h5"), cl)
    _write_h5(str(tmp_path / "stackoverflow_test.h5"), cl)


def _cifar10_files(tmp_path):
    _write_cifar(tmp_path, "cifar-10-batches-py", CIFAR10_FILES, 10)


def _cifar100_files(tmp_path):
    _write_cifar(tmp_path, "cifar-100-python", ["train", "test"], 24,
                 b"fine_labels", 100)


def _imagenet_files(tmp_path):
    import h5py
    rng = np.random.RandomState(0)
    with h5py.File(str(tmp_path / "imagenet.hdf5"), "w") as f:
        f.create_dataset("train_img", data=rng.randint(
            0, 256, (12, 16, 16, 3)).astype(np.uint8))
        f.create_dataset("train_labels", data=rng.randint(0, 5, 12))
        f.create_dataset("val_img", data=rng.randint(
            0, 256, (4, 16, 16, 3)).astype(np.uint8))
        f.create_dataset("val_labels", data=rng.randint(0, 5, 4))


def _landmarks_files(tmp_path, train_csv="mini_gld_train_split.csv",
                     test_csv="mini_gld_test.csv"):
    from PIL import Image
    rng = np.random.RandomState(0)
    os.makedirs(str(tmp_path / "images"), exist_ok=True)
    rows = [("userA", "img0", 0), ("userA", "img1", 1), ("userB", "img2", 0),
            ("userC", "img3", 2)]
    for name in (train_csv, test_csv):
        with open(str(tmp_path / name), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["user_id", "image_id", "class"])
            w.writerows(rows)
    for _, iid, _ in rows:
        Image.fromarray(rng.randint(0, 256, (80, 70, 3)).astype(
            np.uint8)).save(str(tmp_path / "images" / f"{iid}.jpg"))


def _susy_files(tmp_path):
    rng = np.random.RandomState(0)
    arr = np.hstack([rng.randint(0, 2, (40, 1)), rng.rand(40, 18)])
    np.savetxt(str(tmp_path / "SUSY.csv"), arr, delimiter=",")


def _room_files(tmp_path):
    rng = np.random.RandomState(0)
    with open(str(tmp_path / "datatraining.txt"), "w") as f:
        f.write('"id","date","T","H","Light","CO2","HR","Occupancy"\n')
        for i in range(40):
            vals = rng.rand(5) * 100
            f.write(f'"{i}","2015-02-04",' + ",".join(f"{v:.4f}" for v in vals)
                    + f",{rng.randint(0, 2)}\n")


def _voc_files(tmp_path):
    from PIL import Image
    os.makedirs(str(tmp_path / "JPEGImages"))
    os.makedirs(str(tmp_path / "SegmentationClass"))
    rng = np.random.RandomState(0)
    for i in range(12):
        Image.fromarray(rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)).save(
            str(tmp_path / "JPEGImages" / f"i{i}.jpg"))
        lab = rng.randint(0, 21, (40, 48)).astype(np.uint8)
        lab[:2] = 255
        Image.fromarray(lab, mode="L").save(
            str(tmp_path / "SegmentationClass" / f"i{i}.png"))


# dataset: (writer, load_data kwargs)
FILES = {
    "mnist": (_mnist_files, {"client_num_in_total": 4, "batch_size": 4}),
    "femnist": (_femnist_files, {"client_num_in_total": 3, "batch_size": 4}),
    "fed_cifar100": (_fed_cifar100_files, {"client_num_in_total": 2,
                                           "batch_size": 4}),
    "shakespeare": (_shakespeare_files, {"client_num_in_total": 2,
                                         "batch_size": 2}),
    "fed_shakespeare": (_fed_shakespeare_files, {"client_num_in_total": 2,
                                                 "batch_size": 2}),
    "stackoverflow_nwp": (_stackoverflow_files, {"client_num_in_total": 2,
                                                 "batch_size": 2}),
    "stackoverflow_lr": (_stackoverflow_files, {"client_num_in_total": 2,
                                                "batch_size": 2}),
    "cifar10": (_cifar10_files, {"client_num_in_total": 3, "batch_size": 5,
                                 "partition_method": "homo"}),
    "cifar100": (_cifar100_files, {"client_num_in_total": 2, "batch_size": 5,
                                   "partition_method": "hetero"}),
    "cinic10": (_write_image_folder, {"client_num_in_total": 2,
                                      "batch_size": 2,
                                      "partition_method": "homo"}),
    "imagenet": (_imagenet_files, {"client_num_in_total": 2, "batch_size": 4,
                                   "partition_method": "homo"}),
    "gld23k": (_landmarks_files, {"client_num_in_total": 3, "batch_size": 2}),
    "gld160k": (lambda p: _landmarks_files(p, "federated_train.csv",
                                           "test.csv"),
                {"client_num_in_total": 3, "batch_size": 2}),
    "susy": (_susy_files, {"client_num_in_total": 2, "batch_size": 5}),
    "room_occupancy": (_room_files, {"client_num_in_total": 2,
                                     "batch_size": 5}),
    "pascal_voc": (_voc_files, {"client_num_in_total": 2, "batch_size": 2,
                                "partition_method": "homo"}),
    "synthetic_1_1": (_synthetic_leaf_files, {"client_num_in_total": 4,
                                              "batch_size": 5}),
}


def test_every_dataset_has_a_file_case():
    assert set(loaders.SPECS) == set(jloaders.SPECS)
    assert loaders.SPECS == {k: loaders.DatasetSpec(**vars(v))
                             for k, v in jloaders.SPECS.items()}
    assert set(FILES) >= set(loaders.SPECS) - {"synthetic_0_0",
                                               "synthetic_0.5_0.5"}


@pytest.mark.parametrize("store_uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_load_data_on_written_files_bitwise(name, store_uint8, tmp_path):
    write, kw = FILES[name]
    write(tmp_path)
    got = loaders.load_data(name, data_dir=str(tmp_path),
                            store_uint8=store_uint8, **kw)
    want = jloaders.load_data(name, data_dir=str(tmp_path),
                              store_uint8=store_uint8, **kw)
    assert not got.synthetic
    same_data(got, want)


def test_cifar10_uint8_stack_is_the_raw_pixels(tmp_path):
    """store_uint8 on the CIFAR pickles stores the written pixels
    themselves (the exact spec_from_normalize round trip), with
    max_batches capping each client."""
    _write_cifar(tmp_path, "cifar-10-batches-py", CIFAR10_FILES, 40)
    kw = dict(data_dir=str(tmp_path), client_num_in_total=4, batch_size=8,
              partition_method="homo", max_batches_per_client=4, seed=3)
    d8 = loaders.load_data("cifar10", store_uint8=True, **kw)
    d32 = loaders.load_data("cifar10", **kw)
    x_raw, _, _, _ = readers.read_cifar_pickles(str(tmp_path / "cifar-10-batches-py"))
    raw = np.rint(x_raw * 255.0).astype(np.uint8)
    # the stack's rows are training images: pad rows are zero
    mask = d8.client_shards["mask"] > 0
    rows = d8.client_shards["x"][mask].reshape(len(mask[mask]), -1)
    pool = {r.tobytes() for r in raw.reshape(len(raw), -1)}
    assert all(r.tobytes() in pool for r in rows)
    np.testing.assert_allclose(quant.dequantize(d8.client_shards["x"],
                                                d8.x_dequant),
                               d32.client_shards["x"], rtol=0, atol=2e-6)
    same_data(d8, jloaders.load_data("cifar10", store_uint8=True, **kw))


# stand-ins: the synthetic path of every dataset, few clients, small scale
STANDINS = sorted(set(loaders.SPECS))


@pytest.mark.parametrize("store_uint8", [False, True], ids=["f32", "uint8"])
@pytest.mark.parametrize("name", STANDINS)
def test_load_data_standins_bitwise(name, store_uint8, tmp_path):
    scale = 0.003 if name.startswith(("stackoverflow", "gld160k")) else 0.01
    kw = dict(data_dir=str(tmp_path), client_num_in_total=5, batch_size=4,
              synthetic_scale=scale, seed=2, max_batches_per_client=3,
              store_uint8=store_uint8)
    got, want = loaders.load_data(name, **kw), jloaders.load_data(name, **kw)
    assert got.synthetic == (not name.startswith("synthetic_"))
    same_data(got, want)


@pytest.mark.parametrize("method", ["homo", "hetero", "power_law"])
def test_partition_methods_through_load_data_bitwise(method):
    kw = dict(client_num_in_total=4, batch_size=8, synthetic_scale=0.004,
              partition_method=method, partition_alpha=0.3, seed=1)
    same_data(loaders.load_data("cifar10", **kw),
              jloaders.load_data("cifar10", **kw))


def test_hetero_fix_map_fallback_and_client_check(tmp_path, caplog):
    _cifar10_files(tmp_path)
    kw = dict(data_dir=str(tmp_path), client_num_in_total=2, batch_size=10,
              partition_method="hetero-fix")
    # absent map: the Dirichlet partition, with a warning
    same_data(loaders.load_data("cifar10", **kw),
              jloaders.load_data("cifar10", **kw))
    assert "hetero-fix requested" in caplog.text
    with open(str(tmp_path / "net_dataidx_map.txt"), "w") as f:
        f.write("{\n0: [\n" + ", ".join(map(str, range(30))) + "]\n"
                "1: [\n" + ", ".join(map(str, range(30, 50))) + "]\n}\n")
    got = loaders.load_data("cifar10", **kw)
    same_data(got, jloaders.load_data("cifar10", **kw))
    assert got.client_num_samples.tolist() == [30.0, 20.0]
    with pytest.raises(ValueError, match="client_num_in_total=3"):
        loaders.load_data("cifar10", **{**kw, "client_num_in_total": 3})
    with pytest.raises(ValueError, match="unknown partition"):
        loaders.load_data("cifar10", **{**kw, "partition_method": "nope"})
    with pytest.raises(ValueError, match="unknown dataset"):
        loaders.load_data("cifar11")


def test_partition_map_and_distribution_readers_bitwise(tmp_path):
    with open(str(tmp_path / "map.txt"), "w") as f:
        f.write("{\n0: [\n1, 2, 3]\n1: [\n4, 5]\n}\n")
    with open(str(tmp_path / "dist.txt"), "w") as f:
        f.write("{\n0: {\n1: 10,\n2: 20\n}\n1: {\n0: 5\n}\n}\n")
    same(readers.read_net_dataidx_map(str(tmp_path / "map.txt")),
         jreaders.read_net_dataidx_map(str(tmp_path / "map.txt")))
    assert readers.read_data_distribution(str(tmp_path / "dist.txt")) == \
        jreaders.read_data_distribution(str(tmp_path / "dist.txt"))


def test_readers_on_written_files_bitwise(tmp_path):
    _write_image_folder(tmp_path / "folder")
    same(readers.read_image_folder(str(tmp_path / "folder")),
         jreaders.read_image_folder(str(tmp_path / "folder")))
    same(readers.read_image_folder(str(tmp_path / "folder"), max_per_class=2),
         jreaders.read_image_folder(str(tmp_path / "folder"), max_per_class=2))
    os.makedirs(str(tmp_path / "voc"))
    _voc_files(tmp_path / "voc")
    same(readers.read_voc_pairs(str(tmp_path / "voc"), hw=16, max_images=5),
         jreaders.read_voc_pairs(str(tmp_path / "voc"), hw=16, max_images=5))
    _landmarks_files(tmp_path)
    same(readers.read_landmarks_csv(str(tmp_path), "mini_gld_test.csv", hw=8),
         jreaders.read_landmarks_csv(str(tmp_path), "mini_gld_test.csv", hw=8))
    os.remove(str(tmp_path / "images" / "img3.jpg"))
    with pytest.raises(RuntimeError, match="partially downloaded"):
        readers.read_landmarks_csv(str(tmp_path), "mini_gld_test.csv")
    _write_h5(str(tmp_path / "x.h5"), {"a": {"f": np.arange(3)},
                                       "b": {"f": np.arange(2) * 2.5}})
    same(readers.read_tff_h5(str(tmp_path / "x.h5"), ("f",)),
         jreaders.read_tff_h5(str(tmp_path / "x.h5"), ("f",)))
    _susy_files(tmp_path)
    same(readers.read_csv_tabular(str(tmp_path / "SUSY.csv"), 0,
                                  skip_header=False, max_rows=30),
         jreaders.read_csv_tabular(str(tmp_path / "SUSY.csv"), 0,
                                   skip_header=False, max_rows=30))


# ---------------------------------------------------------------------------
# load_vfl_data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["nus_wide", "lending_club"])
def test_load_vfl_data_bitwise(name, tmp_path):
    same(loaders.load_vfl_data(name, n_samples=50, seed=3),
         jloaders.load_vfl_data(name, n_samples=50, seed=3))
    fname = {"nus_wide": "nus_wide_features.csv",
             "lending_club": "loan_processed.csv"}[name]
    rng = np.random.RandomState(4)
    arr = np.hstack([rng.rand(30, 6), rng.randint(0, 3, (30, 1))])
    np.savetxt(str(tmp_path / fname), arr, delimiter=",",
               header="a,b,c,d,e,f,y", comments="")
    same(loaders.load_vfl_data(name, data_dir=str(tmp_path)),
         jloaders.load_vfl_data(name, data_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown VFL"):
        loaders.load_vfl_data("nope")


# ---------------------------------------------------------------------------
# data/federated.py, data/poison.py, data/mobile.py
# ---------------------------------------------------------------------------

def test_as_8tuple_with_test_client_shards(tmp_path):
    _mnist_files(tmp_path)
    got = loaders.load_data("mnist", data_dir=str(tmp_path),
                            client_num_in_total=4, batch_size=4)
    assert got.test_client_shards is not None
    t = got.as_8tuple()
    assert t[4] == {i: int(got.client_num_samples[i]) for i in range(4)}
    same(t[5][2], {k: v[2] for k, v in got.client_shards.items()})
    same_data(got, jloaders.load_data("mnist", data_dir=str(tmp_path),
                                      client_num_in_total=4, batch_size=4))


def test_pixel_trigger_bitwise():
    rs = np.random.RandomState(0)
    for x in (rs.rand(2, 8, 8, 3).astype(np.float32),
              rs.rand(2, 3, 20).astype(np.float32),
              rs.rand(4, 5).astype(np.float32),
              rs.randint(0, 255, (2, 6, 6, 1)).astype(np.uint8)):
        same(poison.pixel_trigger(x), jpoison.pixel_trigger(x))
        same(poison.pixel_trigger(x, 1.5), jpoison.pixel_trigger(x, 1.5))


@pytest.mark.parametrize("trigger", [True, False], ids=["trigger", "flip"])
def test_poisoned_shards_bitwise(trigger):
    kw = dict(client_num_in_total=4, batch_size=4, synthetic_scale=0.002,
              seed=0)
    d, jd = loaders.load_data("cifar10", **kw), jloaders.load_data("cifar10", **kw)
    fn = (poison.pixel_trigger, jpoison.pixel_trigger) if trigger else (None, None)
    got = poison.poison_federated_data(d, [0, 2], 9, 0.5, fn[0], seed=1)
    want = jpoison.poison_federated_data(jd, [0, 2], 9, 0.5, fn[1], seed=1)
    same_data(got, want)
    assert got._device_cache == {} and got._device_cache is not d._device_cache
    assert not np.array_equal(got.client_shards["y"][0], d.client_shards["y"][0])
    same(poison.backdoor_test_shard(d, 9), jpoison.backdoor_test_shard(jd, 9))
    pool_tr, pool_te = poison.load_edge_case_pool(None, "southwest")
    same(poison.poison_edge_case(d, [1], 3, pool_tr, 0.6, seed=2).client_shards,
         jpoison.poison_edge_case(jd, [1], 3, pool_tr, 0.6, seed=2).client_shards)
    same(poison.edge_case_test_shard(pool_te, 3, 16),
         jpoison.edge_case_test_shard(pool_te, 3, 16))


@pytest.mark.parametrize("kind", ["southwest", "ardis", "greencar",
                                  "greencar-neo", "howto"])
def test_edge_case_fallback_pools_bitwise(kind):
    args = (None, kind, (28, 28, 1), 40, 3)
    same(poison.load_edge_case_pool(*args), jpoison.load_edge_case_pool(*args))


class _DS:
    """Stands in for the torch Dataset object inside the ARDIS packs."""

    def __init__(self, data):
        self.data = data


def test_edge_case_real_packs_bitwise(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    sw = tmp_path / "southwest_cifar10"
    os.makedirs(str(sw))
    imgs = rng.randint(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    for name, arr in (("southwest_images_new_train.pkl", imgs),
                      ("southwest_images_new_test.pkl", imgs[:2])):
        with open(str(sw / name), "wb") as f:
            pickle.dump(arr, f)
    same(poison.load_edge_case_pool(str(tmp_path), "southwest"),
         jpoison.load_edge_case_pool(str(tmp_path), "southwest"))
    ar = tmp_path / "ARDIS"
    os.makedirs(str(ar))
    for name, n in (("ardis_train_dataset.pt", 5), ("ardis_test_dataset.pt", 2)):
        torch.save(_DS(torch.from_numpy(
            rng.randint(0, 256, (n, 28, 28)).astype(np.uint8))), str(ar / name))
    got = poison.load_edge_case_pool(str(tmp_path), "ardis")
    assert got[0].shape == (5, 28, 28, 1)
    same(got, jpoison.load_edge_case_pool(str(tmp_path), "ardis"))
    # greencar: the published train indices into CIFAR-10's train set,
    # mapped into a small written set (the constants themselves are equal)
    assert poison.GREEN_CAR_TRAIN_IDX == jpoison.GREEN_CAR_TRAIN_IDX
    assert poison.GREEN_CAR_TEST_IDX == jpoison.GREEN_CAR_TEST_IDX
    _write_cifar(tmp_path, "cifar-10-batches-py", CIFAR10_FILES, 12)
    small_tr = [i % 60 for i in poison.GREEN_CAR_TRAIN_IDX]
    small_te = [i % 60 for i in poison.GREEN_CAR_TEST_IDX]
    for mod in (poison, jpoison):
        monkeypatch.setattr(mod, "GREEN_CAR_TRAIN_IDX", small_tr)
        monkeypatch.setattr(mod, "GREEN_CAR_TEST_IDX", small_te)
    same(poison.load_edge_case_pool(str(tmp_path), "greencar"),
         jpoison.load_edge_case_pool(str(tmp_path), "greencar"))
    g = tmp_path / "greencar_cifar10"
    os.makedirs(str(g))
    with open(str(g / "green_car_transformed_test.pkl"), "wb") as f:
        pickle.dump(rng.normal(0, 1, (3, 3, 32, 32)).astype(np.float32), f)
    got = poison.load_edge_case_pool(str(tmp_path), "greencar")
    assert got[1].shape == (3, 32, 32, 3)
    same(got, jpoison.load_edge_case_pool(str(tmp_path), "greencar"))
    with pytest.raises(ValueError, match="unknown edge-case"):
        poison.load_edge_case_pool(None, "nope")


def test_mobile_split_writes_the_jax_packages_json(tmp_path):
    rng = np.random.RandomState(0)
    ud = {f"u{i:03d}": {"x": rng.rand(3, 5).tolist(),
                        "y": rng.randint(0, 10, 3).tolist()} for i in range(7)}
    _write_leaf(str(tmp_path / "train"), ud)
    # a user missing from the test split gets an empty record
    _write_leaf(str(tmp_path / "test"),
                {k: v for k, v in ud.items() if k != "u002"})
    out = {}
    for name, fn in (("port", mobile.split_mobile_devices),
                     ("jax", jmobile.split_mobile_devices)):
        out[name] = fn(str(tmp_path), str(tmp_path / name),
                       client_num_per_round=3, comm_round=4,
                       client_num_in_total=6)
    assert len(out["port"]) == len(out["jax"]) == 3
    for p, j in zip(out["port"], out["jax"]):
        for split in ("train", "test"):
            rel = os.path.join(split, f"{split}.json")
            with open(os.path.join(p, rel), "rb") as a, \
                    open(os.path.join(j, rel), "rb") as b:
                assert a.read() == b.read(), (p, rel)
