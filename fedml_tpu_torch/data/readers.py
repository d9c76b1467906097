"""On-disk format readers for the real federated datasets (port of
fedml_tpu/data/readers.py; host-side numpy, bitwise equal to the JAX package's).

Parity with reference fedml_api/data_preprocessing/*:
  - LEAF JSON  (MNIST/data_loader.py:9-49, shakespeare): dirs of
    ``{"users": [...], "user_data": {uid: {"x": ..., "y": ...}}}``
  - TFF HDF5   (FederatedEMNIST, fed_cifar100, fed_shakespeare,
    stackoverflow_*): ``examples/<client_id>/<feature>`` groups
  - CIFAR python pickles (cifar10/100); CINIC-10 image folders
    (read_image_folder, requires PIL only when files are present).

All readers return host numpy; partitioning metadata comes from the file's
natural per-user split. Missing files raise FileNotFoundError — the loader
layer catches it and substitutes the synthetic stand-in.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Callable, Optional

import numpy as np


def read_leaf_dir(data_dir: str) -> tuple[list[str], dict]:
    """Read every *.json in a LEAF split dir; returns (users, user_data)."""
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(data_dir)
    users, user_data = [], {}
    files = sorted(f for f in os.listdir(data_dir) if f.endswith(".json"))
    if not files:
        raise FileNotFoundError(f"no LEAF json in {data_dir}")
    for f in files:
        with open(os.path.join(data_dir, f)) as fh:
            blob = json.load(fh)
        users.extend(blob["users"])
        user_data.update(blob["user_data"])
    return users, user_data


def leaf_to_arrays(users: list[str], user_data: dict,
                   xform: Optional[Callable] = None):
    """Flatten LEAF per-user data to (x, y, idx_map)."""
    xs, ys, idx_map, off = [], [], {}, 0
    for i, u in enumerate(users):
        ux = np.asarray(user_data[u]["x"], np.float32)
        uy = np.asarray(user_data[u]["y"], np.int64)
        if xform is not None:
            ux, uy = xform(ux, uy)
        xs.append(ux); ys.append(uy)
        idx_map[i] = np.arange(off, off + len(uy))
        off += len(uy)
    return np.concatenate(xs), np.concatenate(ys), idx_map


def read_tff_h5(path: str, feature_keys: tuple[str, ...]):
    """Read a TFF-style h5: returns {client_id: {key: np.ndarray}}."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    import h5py  # after the existence check: absent file must fall back
                 # to synthetic even when h5py isn't installed
    out = {}
    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for cid in ex.keys():
            out[cid] = {k: np.asarray(ex[cid][k]) for k in feature_keys}
    return out


def read_cifar_pickles(data_dir: str, cifar100: bool = False):
    """CIFAR-10/100 python-version pickles -> (x_train, y_train, x_test,
    y_test) in NHWC float32 [0,1]."""
    if cifar100:
        tf, sf, lk = ["train"], "test", b"fine_labels"
    else:
        tf = [f"data_batch_{i}" for i in range(1, 6)]
        sf, lk = "test_batch", b"labels"
    def _load(name):
        p = os.path.join(data_dir, name)
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
        with open(p, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.asarray(d[lk], np.int64)
    parts = [_load(n) for n in tf]
    x_tr = np.concatenate([p[0] for p in parts])
    y_tr = np.concatenate([p[1] for p in parts])
    x_te, y_te = _load(sf)
    return x_tr, y_tr, x_te, y_te


def normalize_image(x: np.ndarray, mean, std) -> np.ndarray:
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def read_image_folder(data_dir: str, splits=("train", "test"),
                      max_per_class: Optional[int] = None):
    """CINIC-10-style image folders: <split>/<class_name>/*.png.
    Returns (x_train, y_train, x_test, y_test) NHWC float32 in [0,1]."""
    if not os.path.isdir(os.path.join(data_dir, splits[0])):
        raise FileNotFoundError(os.path.join(data_dir, splits[0]))
    from PIL import Image  # after existence check (same fallback contract
                           # as read_tff_h5)
    out = []
    for split in splits:
        root = os.path.join(data_dir, split)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        xs, ys = [], []
        for ci, cname in enumerate(classes):
            files = sorted(os.listdir(os.path.join(root, cname)))
            if max_per_class:
                files = files[:max_per_class]
            for f in files:
                with Image.open(os.path.join(root, cname, f)) as im:
                    xs.append(np.asarray(im.convert("RGB"), np.float32) / 255.0)
                ys.append(ci)
        out += [np.stack(xs), np.asarray(ys, np.int64)]
    return tuple(out)


def read_voc_pairs(data_dir: str, hw: int = 32,
                   max_images: Optional[int] = None):
    """Pascal-VOC-layout segmentation pairs: JPEGImages/<id>.jpg +
    SegmentationClass/<id>.png (palette PNG whose pixel VALUES are class
    ids, 255 = void).  Returns (x [N,hw,hw,3] f32, y [N,hw,hw] i64) with
    nearest-neighbor label resize (never interpolate class ids)."""
    img_dir = os.path.join(data_dir, "JPEGImages")
    lbl_dir = os.path.join(data_dir, "SegmentationClass")
    if not os.path.isdir(lbl_dir):
        raise FileNotFoundError(lbl_dir)
    from PIL import Image
    ids = sorted(os.path.splitext(f)[0] for f in os.listdir(lbl_dir)
                 if f.endswith(".png"))
    if not ids:
        raise FileNotFoundError(f"no label pngs in {lbl_dir}")
    if max_images:
        ids = ids[:max_images]
    xs, ys = [], []
    for i in ids:
        jpg = os.path.join(img_dir, i + ".jpg")
        if not os.path.isfile(jpg):
            jpg = os.path.join(img_dir, i + ".png")   # tolerate png images
        with Image.open(jpg) as im:
            im = im.convert("RGB").resize((hw, hw), Image.BILINEAR)
            xs.append(np.asarray(im, np.float32) / 255.0)
        with Image.open(os.path.join(lbl_dir, i + ".png")) as lm:
            lm = lm.resize((hw, hw), Image.NEAREST)
            ys.append(np.asarray(lm, np.int64))
    return np.stack(xs), np.stack(ys)


def read_landmarks_csv(data_dir: str, split_csv: str, image_dir: str = "images",
                       hw: int = 64):
    """Google Landmarks federated CSV split (reference
    Landmarks/data_loader.py:1-285): rows of (user_id, image_id, class).
    Returns (x, y, net_dataidx_map) with images resized to hw×hw."""
    import csv
    path = os.path.join(data_dir, split_csv)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    from PIL import Image
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append((row["user_id"], row["image_id"], int(row["class"])))
    xs, ys, idx_map = [], [], {}
    users = sorted({u for u, _, _ in rows})
    uid_of = {u: i for i, u in enumerate(users)}
    for u, image_id, cls in rows:
        p = os.path.join(data_dir, image_dir, f"{image_id}.jpg")
        try:
            with Image.open(p) as im:
                im = im.convert("RGB").resize((hw, hw))
                xs.append(np.asarray(im, np.float32) / 255.0)
        except FileNotFoundError as e:
            # the split CSV exists, so the dataset IS present — a missing
            # image is a partial download, not "fall back to synthetic"
            raise RuntimeError(
                f"landmarks dataset is partially downloaded: {p}") from e
        idx_map.setdefault(uid_of[u], []).append(len(ys))
        ys.append(cls)
    return (np.stack(xs), np.asarray(ys, np.int64),
            {k: np.asarray(v) for k, v in idx_map.items()})


def read_net_dataidx_map(path: str) -> dict[int, "np.ndarray"]:
    """Precomputed non-IID partition map ('hetero-fix'), reference
    cifar10/data_loader.py:32-43: a pretty-printed python-dict txt of
    {client: [idx, ...]}."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    out, key = {}, None
    with open(path) as f:
        for line in f:
            if not line.strip() or line[0] in "{}]":
                continue
            head = line.split(":")
            if head[-1].strip() == "[":
                key = int(head[0])
                out[key] = []
            else:
                out[key].extend(int(t.strip().rstrip("]"))
                                for t in line.split(",") if t.strip("] \n"))
    return {k: np.asarray(v, np.int64) for k, v in out.items()}


def read_data_distribution(path: str) -> dict[int, dict[int, int]]:
    """Companion per-client class-count file (cifar10/data_loader.py:15-29)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    out, key = {}, None
    with open(path) as f:
        for line in f:
            if not line.strip() or line[0] in "{}":
                continue
            head, tail = line.split(":", 1)
            if tail.strip() == "{":
                key = int(head)
                out[key] = {}
            else:
                out[key][int(head)] = int(tail.strip().rstrip(","))
    return out


def read_imagenet_h5(path: str):
    """ImageNet hdf5 pack (reference ImageNet/datasets_hdf5.py:13-40):
    datasets train_img/train_labels/val_img/val_labels.  Returns
    (x_tr, y_tr, x_te, y_te) NHWC float32 in [0,1]."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    import h5py

    def _img(ds):
        # decide /255 from the STORED dtype (O(1)) and scale during the
        # float32 conversion — not a full-array max() after a 4x f32 blow-up
        arr = np.asarray(ds)
        if np.issubdtype(arr.dtype, np.integer):
            return arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)

    with h5py.File(path, "r") as f:
        x_tr = _img(f["train_img"])
        y_tr = np.asarray(f["train_labels"], np.int64)
        x_te = _img(f["val_img"])
        y_te = np.asarray(f["val_labels"], np.int64)
    return x_tr, y_tr, x_te, y_te


def read_csv_tabular(path: str, label_col: int, feature_cols=None,
                     skip_header: bool = True, max_rows: Optional[int] = None):
    """Plain-CSV tabular reader (UCI SUSY / Room-Occupancy / lending-club,
    reference UCI/data_loader_for_susy_and_ro.py:1-143).  Returns
    (x float32 [n,d], y int64 [n])."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    data = np.genfromtxt(path, delimiter=",",
                         skip_header=1 if skip_header else 0,
                         max_rows=max_rows)
    y = data[:, label_col].astype(np.int64)
    if feature_cols is None:
        feature_cols = [c for c in range(data.shape[1]) if c != label_col]
    x = data[:, feature_cols].astype(np.float32)
    x = np.nan_to_num(x)
    return x, y
