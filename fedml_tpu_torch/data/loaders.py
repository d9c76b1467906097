"""Dataset registry + `load_data` dispatch (port of fedml_tpu/data/loaders.py;
host-side numpy, every array bitwise equal to the JAX package's).

Mirrors the reference's per-entry-point dataset dispatch
(fedml_experiments/distributed/fedavg/main_fedavg.py:138-356) as one
function.  Every loader returns a `FederatedData` whose client shards are
stacked padded arrays (see data/federated.py).  When the real files are
absent (zero-egress image), a deterministic synthetic stand-in with the same
shapes/vocab/client counts is generated and `synthetic=True` is recorded.

The returned arrays stay numpy on the host; tensors are made only on the
device a caller names (`FederatedData.device_shards`, the engines' cohort
upload).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from fedml_tpu_torch.core.partition import (partition_dirichlet,
                                            partition_homo,
                                            partition_power_law)
from fedml_tpu_torch.data import quant, readers, synthetic, text
from fedml_tpu_torch.data.federated import (FederatedData,
                                            build_client_shards,
                                            build_eval_shard)

CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2470, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4866, 0.4409)
CIFAR100_STD = (0.2673, 0.2564, 0.2762)


@dataclass
class DatasetSpec:
    n_clients_default: int
    class_num: int
    batch_size_default: int


SPECS = {
    "mnist": DatasetSpec(1000, 10, 10),
    "femnist": DatasetSpec(3400, 62, 20),
    "fed_cifar100": DatasetSpec(500, 100, 20),
    "shakespeare": DatasetSpec(715, 90, 4),
    "fed_shakespeare": DatasetSpec(715, 90, 4),
    # 342,477 = the full TFF StackOverflow user base, the reference's
    # benchmark client count (benchmark/README.md:57); pass
    # client_num_in_total for smaller slices
    "stackoverflow_nwp": DatasetSpec(342_477, 10004, 16),
    "stackoverflow_lr": DatasetSpec(342_477, 500, 16),
    "cifar10": DatasetSpec(10, 10, 64),
    "cifar100": DatasetSpec(10, 100, 64),
    "cinic10": DatasetSpec(10, 10, 64),
    "synthetic_0_0": DatasetSpec(30, 10, 10),
    "synthetic_0.5_0.5": DatasetSpec(30, 10, 10),
    "synthetic_1_1": DatasetSpec(30, 10, 10),
    "imagenet": DatasetSpec(100, 1000, 32),
    "gld23k": DatasetSpec(233, 203, 32),
    "gld160k": DatasetSpec(1262, 2028, 32),
    "susy": DatasetSpec(30, 2, 32),
    "room_occupancy": DatasetSpec(30, 2, 32),
    # segmentation (fedseg; 21 = VOC classes incl. background, void=255)
    "pascal_voc": DatasetSpec(4, 21, 8),
}

# feature dims for the tabular/streaming UCI tasks (reference
# UCI/data_loader_for_susy_and_ro.py)
_TABULAR_DIMS = {"susy": 18, "room_occupancy": 5}


def _partition(labels, n_clients, method, alpha, seed, data_dir=""):
    if method == "homo":
        return partition_homo(len(labels), n_clients, seed)
    if method == "hetero":
        return partition_dirichlet(labels, n_clients, alpha, seed=seed)
    if method == "power_law":
        return partition_power_law(labels, n_clients, seed)
    if method == "hetero-fix":
        # precomputed map (reference cifar10/data_loader.py:150-156);
        # falls back to hetero when the txt is absent
        try:
            m = readers.read_net_dataidx_map(
                os.path.join(data_dir or "", "net_dataidx_map.txt"))
        except FileNotFoundError:
            import logging
            logging.getLogger(__name__).warning(
                "hetero-fix requested but %s/net_dataidx_map.txt is absent; "
                "falling back to a Dirichlet(alpha=%s) partition — this is "
                "NOT the precomputed reference split", data_dir, alpha)
            return partition_dirichlet(labels, n_clients, alpha, seed=seed)
        if sorted(m) != list(range(n_clients)):
            raise ValueError(
                f"net_dataidx_map.txt holds clients {sorted(m)[:5]}..."
                f"(n={len(m)}), but client_num_in_total={n_clients}; the "
                "sampler would train the wrong cohort")
        return m
    raise ValueError(f"unknown partition {method!r}")


def _make(x_tr, y_tr, x_te, y_te, idx_map, batch_size, class_num,
          max_batches=None, test_idx_map=None, seed=0, synthetic=False):
    if synthetic and len(idx_map) > 100_000:
        # reference-contract client counts (stackoverflow: 342,477) make
        # the synthetic stand-in a multi-minute, multi-GB host build —
        # worth a heads-up when it was reached by DEFAULT
        import logging
        logging.getLogger(__name__).warning(
            "building a synthetic stand-in for %d clients (measured: "
            "18 s / 2.6 GB RSS at 342,477); pass client_num_in_total "
            "for a smaller slice", len(idx_map))
    shards = build_client_shards(x_tr, y_tr, idx_map, batch_size,
                                 max_batches=max_batches, shuffle_seed=seed)
    sizes = np.array([min(len(idx_map[i]),
                          shards["mask"].shape[1] * shards["mask"].shape[2])
                      for i in range(len(idx_map))], np.float32)
    test_shards = None
    if test_idx_map is not None:
        test_shards = build_client_shards(x_te, y_te, test_idx_map, batch_size,
                                          max_batches=max_batches)
    return FederatedData(
        train_data_num=int(len(y_tr)),
        test_data_num=int(len(y_te)),
        train_global=build_eval_shard(x_tr, y_tr, max(batch_size, 64)),
        test_global=build_eval_shard(x_te, y_te, max(batch_size, 64)),
        client_shards=shards,
        client_num_samples=sizes,
        test_client_shards=test_shards,
        class_num=class_num,
        synthetic=synthetic,
    )


def load_data(dataset: str,
              data_dir: Optional[str] = None,
              client_num_in_total: Optional[int] = None,
              batch_size: Optional[int] = None,
              partition_method: str = "hetero",
              partition_alpha: float = 0.5,
              max_batches_per_client: Optional[int] = None,
              seed: int = 0,
              synthetic_scale: float = 1.0,
              store_uint8: bool = False) -> FederatedData:
    """Load (or synthesize) a federated dataset.

    `synthetic_scale` < 1 shrinks synthetic stand-ins for fast tests.

    `store_uint8` keeps the TRAIN client stack's input leaf in uint8
    with a `DequantSpec` on `FederatedData.x_dequant` (data/quant.py):
    the storage that MeshFedAvgEngine and its subclasses dequantize on
    the device, one chunk at a time, with or without their
    `stack_dtype=torch.uint8`: 4x fewer host RAM and upload bytes than
    f32 stacks.  For the normalize_image datasets (cifar10/100,
    cinic10) the stored bytes ARE the raw pixels (exact round trip);
    elsewhere a per-tensor min/max affine is used.  Eval shards
    (train_global/test_global/test_client_shards) always stay float —
    only the cohort path pays transfer at scale.
    """
    fd = _load_data(dataset, data_dir, client_num_in_total, batch_size,
                    partition_method, partition_alpha,
                    max_batches_per_client, seed, synthetic_scale)
    if store_uint8:
        spec = None
        if not fd.synthetic:
            # normalize_image datasets: dequant spec derived from the
            # normalization constants, so the uint8 storage is exactly
            # the raw pixels (lossless round trip)
            if dataset in ("cifar10", "cinic10"):
                spec = quant.spec_from_normalize(CIFAR10_MEAN, CIFAR10_STD)
            elif dataset == "cifar100":
                spec = quant.spec_from_normalize(CIFAR100_MEAN,
                                                 CIFAR100_STD)
        x = fd.client_shards.get("x")
        if x is not None and np.issubdtype(np.asarray(x).dtype,
                                           np.floating):
            spec = spec or quant.spec_from_minmax(x)
            fd.client_shards["x"] = quant.quantize_uint8(x, spec)
            fd.x_dequant = spec
        else:
            import logging
            logging.getLogger(__name__).warning(
                "store_uint8 ignored for %s: the input leaf is %s "
                "(integer token ids must not be quantized)", dataset,
                None if x is None else np.asarray(x).dtype)
    return fd


def _load_data(dataset: str,
               data_dir: Optional[str] = None,
               client_num_in_total: Optional[int] = None,
               batch_size: Optional[int] = None,
               partition_method: str = "hetero",
               partition_alpha: float = 0.5,
               max_batches_per_client: Optional[int] = None,
               seed: int = 0,
               synthetic_scale: float = 1.0) -> FederatedData:
    if dataset not in SPECS:
        raise ValueError(f"unknown dataset {dataset!r}; known: {sorted(SPECS)}")
    spec = SPECS[dataset]
    data_dir = data_dir or ""
    C = client_num_in_total or spec.n_clients_default
    bs = batch_size or spec.batch_size_default
    sc = lambda n: max(C * 2, int(n * synthetic_scale))

    if dataset == "mnist":
        try:
            users, user_data = readers.read_leaf_dir(os.path.join(data_dir or "", "train"))
            users_te, user_data_te = readers.read_leaf_dir(os.path.join(data_dir, "test"))
            x_tr, y_tr, idx_map = readers.leaf_to_arrays(users[:C], user_data)
            x_te, y_te, te_map = readers.leaf_to_arrays(users_te[:C], user_data_te)
            x_tr = x_tr.reshape(-1, 28 * 28); x_te = x_te.reshape(-1, 28 * 28)
            synth = False
        except FileNotFoundError:
            synth = True
            x, y = synthetic.synthetic_classification_images(
                sc(60000), (28, 28), 1, 10, seed=seed, flat=True)
            n_te = max(C, sc(60000) // 6)
            x_tr, y_tr, x_te, y_te = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = _partition(y_tr, C, "power_law", partition_alpha, seed)
            te_map = None
        return _make(x_tr, y_tr, x_te, y_te, idx_map, bs, 10,
                     max_batches_per_client, te_map, seed, synthetic=synth)

    if dataset == "femnist":
        try:
            h5 = readers.read_tff_h5(os.path.join(data_dir or "", "fed_emnist_train.h5"),
                                     ("pixels", "label"))
            h5t = readers.read_tff_h5(os.path.join(data_dir, "fed_emnist_test.h5"),
                                      ("pixels", "label"))
            cids = sorted(h5.keys())[:C]
            xs, ys, idx_map, off = [], [], {}, 0
            for i, cid in enumerate(cids):
                px = h5[cid]["pixels"].astype(np.float32)[..., None]
                lb = h5[cid]["label"].astype(np.int64)
                xs.append(px); ys.append(lb)
                idx_map[i] = np.arange(off, off + len(lb)); off += len(lb)
            x_tr, y_tr = np.concatenate(xs), np.concatenate(ys)
            xt = np.concatenate([h5t[c]["pixels"].astype(np.float32)[..., None]
                                 for c in sorted(h5t.keys())[:C]])
            yt = np.concatenate([h5t[c]["label"].astype(np.int64)
                                 for c in sorted(h5t.keys())[:C]])
            te_map = None
            synth = False
        except FileNotFoundError:
            synth = True
            x, y = synthetic.synthetic_classification_images(
                sc(80000), (28, 28), 1, 62, seed=seed)
            n_te = sc(80000) // 8
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = _partition(y_tr, C, "power_law", partition_alpha, seed)
            te_map = None
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, 62,
                     max_batches_per_client, te_map, seed, synthetic=synth)

    if dataset == "fed_cifar100":
        try:
            h5 = readers.read_tff_h5(os.path.join(data_dir or "", "fed_cifar100_train.h5"),
                                     ("image", "label"))
            cids = sorted(h5.keys())[:C]
            xs, ys, idx_map, off = [], [], {}, 0
            for i, cid in enumerate(cids):
                im = h5[cid]["image"].astype(np.float32) / 255.0
                lb = h5[cid]["label"].astype(np.int64)
                xs.append(im); ys.append(lb)
                idx_map[i] = np.arange(off, off + len(lb)); off += len(lb)
            x_tr, y_tr = np.concatenate(xs), np.concatenate(ys)
            h5t = readers.read_tff_h5(os.path.join(data_dir, "fed_cifar100_test.h5"),
                                      ("image", "label"))
            xt = np.concatenate([h5t[c]["image"].astype(np.float32) / 255.0
                                 for c in sorted(h5t.keys())])
            yt = np.concatenate([h5t[c]["label"].astype(np.int64)
                                 for c in sorted(h5t.keys())])
            synth = False
        except FileNotFoundError:
            synth = True
            x, y = synthetic.synthetic_classification_images(
                sc(50000), (32, 32), 3, 100, seed=seed)
            n_te = sc(50000) // 5
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = _partition(y_tr, C, "hetero", partition_alpha, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, 100,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset == "shakespeare":
        # LEAF JSON text: 80-char windows -> next char (reference
        # shakespeare/data_loader.py:11-87, language_utils.py:31-55)
        seq_len, vocab = text.SHAKESPEARE_SEQ_LEN, text.SHAKESPEARE_VOCAB_SIZE
        try:
            users, user_data = readers.read_leaf_dir(
                os.path.join(data_dir or "", "train"))
            users_te, user_data_te = readers.read_leaf_dir(
                os.path.join(data_dir, "test"))
            x_tr, y_tr, idx_map = text.leaf_shakespeare_to_arrays(
                users[:C], user_data)
            xt, yt, te_map = text.leaf_shakespeare_to_arrays(
                users_te[:C], user_data_te)
            synth = False
        except FileNotFoundError:
            synth, te_map = True, None
            x, y = synthetic.synthetic_sequences(sc(16000), seq_len, vocab,
                                                 seed=seed)
            n_te = sc(16000) // 8
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            # next-char task: label = last-position next token
            y_tr, yt = y_tr[:, -1], yt[:, -1]
            idx_map = partition_homo(len(y_tr), C, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, vocab,
                     max_batches_per_client, te_map, seed, synthetic=synth)

    if dataset == "fed_shakespeare":
        # TFF h5 snippets -> 80-token shifted sequences (reference
        # fed_shakespeare/utils.py:53-82, data_loader.py:24-69)
        seq_len, vocab = text.SHAKESPEARE_SEQ_LEN, text.SHAKESPEARE_VOCAB_SIZE
        try:
            h5 = readers.read_tff_h5(
                os.path.join(data_dir or "", "shakespeare_train.h5"),
                ("snippets",))
            h5t = readers.read_tff_h5(
                os.path.join(data_dir, "shakespeare_test.h5"), ("snippets",))
            xs, ys, idx_map, off = [], [], {}, 0
            for i, cid in enumerate(sorted(h5)[:C]):
                sx, sy = text.tff_snippets_to_sequences(
                    text._decode(h5[cid]["snippets"]), seq_len)
                xs.append(sx); ys.append(sy)
                idx_map[i] = np.arange(off, off + len(sy)); off += len(sy)
            x_tr, y_tr = np.concatenate(xs), np.concatenate(ys)
            parts = [text.tff_snippets_to_sequences(
                text._decode(h5t[c]["snippets"]), seq_len) for c in sorted(h5t)]
            xt = np.concatenate([p[0] for p in parts])
            yt = np.concatenate([p[1] for p in parts])
            synth = False
        except FileNotFoundError:
            synth = True
            x, y = synthetic.synthetic_sequences(sc(16000), seq_len, vocab,
                                                 seed=seed)
            n_te = sc(16000) // 8
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = partition_homo(len(y_tr), C, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, vocab,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset == "stackoverflow_nwp":
        # TFF h5 word streams + stackoverflow.word_count vocabulary
        # (reference stackoverflow_nwp/utils.py:27-86, dataset.py:45-51)
        seq_len, vocab_len = 20, 10004
        try:
            words = text.read_word_count_vocab(
                os.path.join(data_dir or "", "stackoverflow.word_count"))
            wv = text.WordVocab(words)
            h5 = readers.read_tff_h5(
                os.path.join(data_dir, "stackoverflow_train.h5"), ("tokens",))
            h5t = readers.read_tff_h5(
                os.path.join(data_dir, "stackoverflow_test.h5"), ("tokens",))
            x_tr, y_tr, idx_map = text.stackoverflow_nwp_arrays(
                h5, wv, seq_len, max_clients=C)
            xt, yt, te_map = text.stackoverflow_nwp_arrays(
                h5t, wv, seq_len, max_clients=C)
            vocab_len = wv.vocab_len
            synth = False
        except FileNotFoundError:
            synth, te_map = True, None
            # classed (rank-64) chain, NOT synthetic_sequences: a
            # full-rank random [V, V] chain at vocab 10,004 is
            # unlearnable by embedding models AND near-noise even for
            # an oracle (measured oracle_top1 = 0.0102 — see
            # synthetic_sequences_classed's docstring), which broke the
            # "learnable stand-in" contract this module documents.
            # Also ~150x lighter to generate (64 rows vs a [V, V]
            # matrix).
            x, y, _ = synthetic.synthetic_sequences_classed(
                sc(20000), seq_len, vocab_len, seed=seed)
            n_te = sc(20000) // 8
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = partition_homo(len(y_tr), C, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, vocab_len,
                     max_batches_per_client, te_map, seed, synthetic=synth)

    if dataset == "stackoverflow_lr":
        # bag-of-words -> multi-hot tags, vocab/tag files + h5
        # (reference stackoverflow_lr/utils.py:33-131, dataset.py:54-62)
        dim, n_tags = 10000, 500
        try:
            words = text.BagOfWordsVocab(text.read_word_count_vocab(
                os.path.join(data_dir or "", "stackoverflow.word_count"), dim))
            tags = text.TagVocab(text.read_tag_count_vocab(
                os.path.join(data_dir, "stackoverflow.tag_count"), n_tags))
            h5 = readers.read_tff_h5(
                os.path.join(data_dir, "stackoverflow_train.h5"),
                ("tokens", "title", "tags"))
            h5t = readers.read_tff_h5(
                os.path.join(data_dir, "stackoverflow_test.h5"),
                ("tokens", "title", "tags"))
            x_tr, y_tr, idx_map = text.stackoverflow_lr_arrays(
                h5, words, tags, max_clients=C)
            xt, yt, te_map = text.stackoverflow_lr_arrays(
                h5t, words, tags, max_clients=C)
            dim, n_tags = words.dim, tags.dim
            synth = False
        except FileNotFoundError:
            synth, te_map = True, None
            x, y = synthetic.synthetic_multilabel(sc(20000), dim, n_tags,
                                                  seed=seed)
            n_te = sc(20000) // 8
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = partition_homo(len(y_tr), C, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, n_tags,
                     max_batches_per_client, te_map, seed, synthetic=synth)

    if dataset in ("cifar10", "cifar100", "cinic10"):
        n_classes = 100 if dataset == "cifar100" else 10
        mean, std = ((CIFAR100_MEAN, CIFAR100_STD) if dataset == "cifar100"
                     else (CIFAR10_MEAN, CIFAR10_STD))
        try:
            if dataset == "cinic10":
                x_tr, y_tr, xt, yt = readers.read_image_folder(data_dir)
            else:
                sub = {"cifar10": "cifar-10-batches-py",
                       "cifar100": "cifar-100-python"}[dataset]
                x_tr, y_tr, xt, yt = readers.read_cifar_pickles(
                    os.path.join(data_dir, sub),
                    cifar100=(dataset == "cifar100"))
            x_tr = readers.normalize_image(x_tr, mean, std)
            xt = readers.normalize_image(xt, mean, std)
            synth = False
        except FileNotFoundError:
            synth = True
            n = sc(50000 if dataset != "cinic10" else 90000)
            x, y = synthetic.synthetic_classification_images(
                n, (32, 32), 3, n_classes, seed=seed)
            n_te = n // 5
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
        idx_map = _partition(y_tr, C, partition_method, partition_alpha,
                             seed, data_dir)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, n_classes,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset == "imagenet":
        # reference ImageNet/data_loader.py:1-300 (per-client index maps over
        # ILSVRC2012; hdf5 pack variant datasets_hdf5.py:13-40).  Synthetic
        # stand-in uses 64×64 (memory-sane shape proxy; the loader path and
        # partition semantics are identical).
        try:
            h5p = os.path.join(data_dir or "", "imagenet.hdf5")
            if os.path.isfile(h5p):
                x_tr, y_tr, xt, yt = readers.read_imagenet_h5(h5p)
            else:
                x_tr, y_tr, xt, yt = readers.read_image_folder(data_dir)
            synth = False
            idx_map = _partition(y_tr, C, partition_method, partition_alpha,
                                 seed, data_dir)
        except FileNotFoundError:
            synth = True
            n = sc(4000)
            x, y = synthetic.synthetic_classification_images(
                n, (64, 64), 3, 1000, seed=seed)
            n_te = n // 5
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = _partition(y_tr, C, "homo", partition_alpha, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, 1000,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset in ("gld23k", "gld160k"):
        # Google Landmarks federated split (Landmarks/data_loader.py:1-285):
        # natural per-user partition from the CSV mapping.
        n_classes = spec.class_num
        try:
            split_csv = ("mini_gld_train_split.csv" if dataset == "gld23k"
                         else "federated_train.csv")
            x_tr, y_tr, idx_map = readers.read_landmarks_csv(
                data_dir, split_csv)
            test_csv = ("mini_gld_test.csv" if dataset == "gld23k"
                        else "test.csv")
            xt, yt, _ = readers.read_landmarks_csv(data_dir, test_csv)
            synth = False
        except FileNotFoundError:
            synth = True
            n = sc(23080 if dataset == "gld23k" else 164172)
            x, y = synthetic.synthetic_classification_images(
                n, (64, 64), 3, n_classes, seed=seed)
            n_te = n // 8
            x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
            idx_map = _partition(y_tr, C, "power_law", partition_alpha, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, n_classes,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset in _TABULAR_DIMS:
        # UCI SUSY / Room-Occupancy streaming tabular tasks for the
        # decentralized online learners (UCI/data_loader_for_susy_and_ro.py).
        dim = _TABULAR_DIMS[dataset]
        fname = {"susy": "SUSY.csv",
                 "room_occupancy": "datatraining.txt"}[dataset]
        try:
            if dataset == "susy":
                label_col, feat_cols, hdr = 0, None, False
            else:   # datatraining.txt: "id","date",T,H,Light,CO2,HR,Occupancy
                label_col, feat_cols, hdr = -1, [2, 3, 4, 5, 6], True
            x, y = readers.read_csv_tabular(
                os.path.join(data_dir or "", fname), label_col=label_col,
                feature_cols=feat_cols, skip_header=hdr)
            synth = False
        except FileNotFoundError:
            synth = True
            x, y = synthetic.synthetic_tabular(sc(20000), dim, seed=seed)
        n_te = len(y) // 8
        x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
        # standardize with TRAIN statistics only (no test leakage)
        mu, sd = x_tr.mean(axis=0), x_tr.std(axis=0) + 1e-8
        x_tr, xt = (x_tr - mu) / sd, (xt - mu) / sd
        idx_map = _partition(y_tr, C, "homo", partition_alpha, seed)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, 2,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset == "pascal_voc":
        # fedseg's segmentation data: VOC-layout folders when present,
        # synthetic threshold-mask task otherwise.  Labels are [H, W] int
        # maps with void=255 (the trainer's train_ignore_id).  The
        # fallback triggers ONLY on a missing SegmentationClass dir; a
        # present-but-broken dataset (e.g. a label png without its jpg)
        # raises instead of silently training on synthetic data.
        if os.path.isdir(os.path.join(data_dir or "", "SegmentationClass")):
            x, y = readers.read_voc_pairs(data_dir)
            synth = False
        else:
            x, y = synthetic.synthetic_segmentation(
                sc(512), (32, 32), spec.class_num, seed=seed)
            synth = True
        n_te = max(C, len(y) // 8)
        x_tr, y_tr, xt, yt = x[n_te:], y[n_te:], x[:n_te], y[:n_te]
        # partition on the images' DOMINANT class (LDA needs one label
        # per sample; reference fedseg partitions image lists the same way)
        dom = np.array([np.bincount(
            m[m != 255].ravel(), minlength=spec.class_num).argmax()
            if (m != 255).any() else 0 for m in y_tr])
        idx_map = _partition(dom, C, partition_method, partition_alpha,
                             seed, data_dir)
        return _make(x_tr, y_tr, xt, yt, idx_map, bs, spec.class_num,
                     max_batches_per_client, None, seed, synthetic=synth)

    if dataset.startswith("synthetic_"):
        ab = dataset.split("_")[1:]
        alpha, beta = float(ab[0]), float(ab[1])
        # real path: the reference SHIPS these datasets as pre-generated
        # LEAF JSONs (data/synthetic_1_1/{train/mytrain,test/mytest}.json;
        # fedml_api/data_preprocessing/synthetic_1_1/data_loader.py:14-15).
        # Only probed when data_dir is EXPLICIT: unlike the named-dataset
        # loaders, synthetic_* encodes generation parameters in its name,
        # and stray ./train ./test dirs must not shadow the generator.
        if data_dir:
            try:
                u_tr, ud_tr = readers.read_leaf_dir(
                    os.path.join(data_dir, "train"))
                u_te, ud_te = readers.read_leaf_dir(
                    os.path.join(data_dir, "test"))
                x_tr, y_tr, tr_map = readers.leaf_to_arrays(u_tr[:C], ud_tr)
                xt, yt, _ = readers.leaf_to_arrays(u_te[:C], ud_te)
                return _make(x_tr, y_tr, xt, yt, tr_map, bs, 10,
                             max_batches_per_client, None, seed,
                             synthetic=False)
            except FileNotFoundError:
                pass
        x, y, idx_map = synthetic.synthetic_fedprox(alpha, beta, C, seed=seed)
        n = len(y)
        # 90/10 train/test split inside each client, reference-style
        tr_map, te_idx = {}, []
        for k, idx in idx_map.items():
            cut = max(1, int(0.9 * len(idx)))
            tr_map[k] = idx[:cut]; te_idx.append(idx[cut:])
        te_idx = np.concatenate(te_idx)
        return _make(x, y, x[te_idx], y[te_idx], tr_map, bs, 10,
                     max_batches_per_client, None, seed)

    raise ValueError(f"unknown dataset {dataset!r}")


# ---------------------------------------------------------------------------
# Vertical-FL datasets: party-split features over shared samples
# ---------------------------------------------------------------------------

# (total feature dim, default per-party split) — reference NUS_WIDE
# (634 image features + 1000 text tags, nus_wide_dataset.py:1-260) and
# lending_club (lending_club_loan/, guest/host feature columns)
_VFL_SPECS = {
    "nus_wide": (1634, (634, 1000)),
    "lending_club": (60, (30, 30)),
}


def load_vfl_data(dataset: str, data_dir: Optional[str] = None,
                  n_samples: int = 4000, seed: int = 0):
    """Load a vertical-FL task: returns (x [n, D], y [n] binary,
    feature_splits) where feature_splits[p] is party p's slice width
    (guest = party 0).  Real CSVs when present, synthetic stand-in
    otherwise — the VFLEngine consumes either identically."""
    if dataset not in _VFL_SPECS:
        raise ValueError(f"unknown VFL dataset {dataset!r}; "
                         f"known: {sorted(_VFL_SPECS)}")
    dim, splits = _VFL_SPECS[dataset]
    try:
        fname = {"nus_wide": "nus_wide_features.csv",
                 "lending_club": "loan_processed.csv"}[dataset]
        x, y = readers.read_csv_tabular(
            os.path.join(data_dir or "", fname), label_col=-1)
        y = (y > 0).astype(np.int64)
    except FileNotFoundError:
        x, y = synthetic.synthetic_tabular(n_samples, dim, seed=seed)
    mu, sd = x.mean(axis=0), x.std(axis=0) + 1e-8
    x = (x - mu) / sd
    return x.astype(np.float32), y, list(splits)
