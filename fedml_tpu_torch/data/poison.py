"""Backdoor-poisoned federated datasets for robust-FL evaluation (port of
fedml_tpu/data/poison.py; host-side numpy, bitwise equal to the JAX
package's).

Parity: reference fedml_api/data_preprocessing/edge_case_examples/
(data_loader.py:283+, `load_poisoned_dataset`) — attacker clients train on
samples relabeled to an attacker-chosen target; the defense is scored on
(a) clean accuracy and (b) backdoor success rate on a poisoned test set.
The reference ships fixed poisoned image packs (southwest/ardis/greencar);
this build poisons any loaded dataset structurally instead: a pixel
trigger (classic BadNets-style corner patch) or label-flip ("edge case"
without trigger), applied to the stacked client shards — so the pipeline
works on real files and synthetic stand-ins alike.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.data.loaders import CIFAR10_MEAN, CIFAR10_STD
from fedml_tpu_torch.data.readers import read_cifar_pickles

# the "How To Backdoor FL" green-car CIFAR-10 train indices (reference
# data_loader.py:158-161 / 563-566 — published constants of the attack):
# 27 in-train pool images + 3 held out as the fallback test pool
GREEN_CAR_TRAIN_IDX = [
    874, 49163, 34287, 21422, 48003, 47001, 48030, 22984, 37533, 41336,
    3678, 37365, 19165, 34385, 41861, 39824, 561, 49588, 4528, 3378,
    38658, 38735, 19500, 9744, 47026, 1605, 389]
GREEN_CAR_TEST_IDX = [32941, 36005, 40138]


def pixel_trigger(x: np.ndarray, strength: float = 3.0) -> np.ndarray:
    """Stamp a high-contrast 3×3 checkerboard in the bottom-right corner.
    Works for NHWC images and flat vectors (last 9 features)."""
    x = x.copy()
    pat = strength * (np.indices((3, 3)).sum(axis=0) % 2 * 2 - 1)
    # image iff the trailing axes look like (H, W, C): channel dim ≤ 4.
    # Flat feature vectors (e.g. batched MNIST [..., 784]) take the
    # last-9-features branch regardless of batch ndim.
    if x.ndim >= 3 and x.shape[-1] <= 4:
        x[..., -3:, -3:, :] = pat[..., None].astype(x.dtype)
    else:
        # narrow tabular inputs (e.g. room_occupancy's 5 features) take a
        # truncated patch instead of a broadcast error
        k = min(9, x.shape[-1])
        x[..., -k:] = pat.reshape(-1)[:k].astype(x.dtype)
    return x


def poison_federated_data(data: FederatedData,
                          attacker_ids: Sequence[int],
                          target_label: int,
                          poison_frac: float = 0.5,
                          trigger_fn: Optional[Callable] = pixel_trigger,
                          seed: int = 0) -> FederatedData:
    """Return a copy of `data` where `poison_frac` of each attacker client's
    real samples carry the trigger and the target label.

    trigger_fn=None gives a pure label-flip attack (the reference's
    edge-case semantics: naturally-plausible inputs, wrong label)."""
    rs = np.random.RandomState(seed)
    shards = {k: np.array(v, copy=True) for k, v in data.client_shards.items()}
    C, B, bs = shards["mask"].shape
    for cid in attacker_ids:
        real = np.argwhere(shards["mask"][cid].reshape(-1) > 0).reshape(-1)
        n_poison = int(len(real) * poison_frac)
        if n_poison == 0:
            continue
        chosen = rs.choice(real, n_poison, replace=False)
        bi, si = np.unravel_index(chosen, (B, bs))
        if trigger_fn is not None:
            shards["x"][cid, bi, si] = trigger_fn(shards["x"][cid, bi, si])
        shards["y"][cid, bi, si] = target_label
    # fresh _device_cache: dataclasses.replace would otherwise SHARE the
    # mutable cache dict with the source data — whichever object uploads
    # its stack first would silently serve it to BOTH (a poisoned run
    # reading clean tensors, or worse, a clean run reading poisoned ones)
    return dataclasses.replace(data, client_shards=shards, _device_cache={})


def load_edge_case_pool(data_dir: Optional[str], poison_type: str,
                        image_shape: Sequence[int] = (32, 32, 3),
                        n_fallback: int = 784, seed: int = 7):
    """Edge-case example pool (reference `load_poisoned_dataset`,
    edge_case_examples/data_loader.py:283-420): naturally-plausible inputs
    from OUTSIDE the task distribution that the attacker relabels.

    Real packs when present:
      southwest: southwest_images_new_train.pkl / southwest_images_new_test.pkl
                 (pickled uint8 [N,32,32,3] CIFAR-shaped airline images)
      ardis:     ARDIS/ardis_train_dataset.pt / ardis_test_dataset.pt
                 (torch-saved MNIST-shaped digit images)
      greencar:  the pool's TRAIN images are 27 fixed green-car images
                 drawn from CIFAR-10's own train set by index
                 (data_loader.py:563-565 sampled_indices_train; the "How
                 To Backdoor FL" set) read from
                 data_dir/cifar-10-batches-py; the TEST pool is the
                 shipped greencar_cifar10/green_car_transformed_test.pkl
                 (already normalized, :585-587), falling back to the 3
                 held-out train indices (:566).
    Fallback (zero-egress image): a tight off-distribution Gaussian cluster
    with the same shapes — edge-case semantics (plausible, consistent,
    unseen) without the real pixels.

    Returns (x_train [N,...], x_test [M,...]) float32 in the dataset's
    input scale."""
    if poison_type in ("greencar-neo", "howto"):   # reference aliases
        poison_type = "greencar"
    if poison_type not in ("southwest", "ardis", "greencar"):
        raise ValueError(f"unknown edge-case poison {poison_type!r}")
    try:
        if poison_type == "greencar":
            x_all, _, _, _ = read_cifar_pickles(
                os.path.join(data_dir or "", "cifar-10-batches-py"))
            mean = np.asarray(CIFAR10_MEAN, np.float32)
            std = np.asarray(CIFAR10_STD, np.float32)
            x_tr = (x_all[GREEN_CAR_TRAIN_IDX] - mean) / std
            te_pkl = os.path.join(data_dir or "", "greencar_cifar10",
                                  "green_car_transformed_test.pkl")
            if os.path.isfile(te_pkl):
                with open(te_pkl, "rb") as f:
                    x_te = np.asarray(pickle.load(f), np.float32)
                if x_te.ndim == 4 and x_te.shape[1] == 3:   # NCHW pack
                    x_te = x_te.transpose(0, 2, 3, 1)
            else:
                x_te = (x_all[GREEN_CAR_TEST_IDX] - mean) / std
        elif poison_type == "southwest":
            base = os.path.join(data_dir or "", "southwest_cifar10")
            with open(os.path.join(base, "southwest_images_new_train.pkl"),
                      "rb") as f:
                x_tr = pickle.load(f)
            with open(os.path.join(base, "southwest_images_new_test.pkl"),
                      "rb") as f:
                x_te = pickle.load(f)
            # same normalize transform the task data gets (reference applies
            # transform_train to the southwest pack, data_loader.py:330+) —
            # an un-normalized pool would make the backdoor a trivial
            # pixel-scale artifact
            mean = np.asarray(CIFAR10_MEAN, np.float32)
            std = np.asarray(CIFAR10_STD, np.float32)
            x_tr = (np.asarray(x_tr, np.float32) / 255.0 - mean) / std
            x_te = (np.asarray(x_te, np.float32) / 255.0 - mean) / std
        else:
            base = os.path.join(data_dir or "", "ARDIS")
            # the packs are pickled Dataset objects (arbitrary classes), so
            # weights_only loading (torch>=2.6 default) cannot apply
            tr = torch.load(os.path.join(base, "ardis_train_dataset.pt"),
                            weights_only=False)
            te = torch.load(os.path.join(base, "ardis_test_dataset.pt"),
                            weights_only=False)
            # EMNIST normalization, as the reference's transform applies
            x_tr = (np.asarray(tr.data, np.float32) / 255.0 - 0.1307) / 0.3081
            x_te = (np.asarray(te.data, np.float32) / 255.0 - 0.1307) / 0.3081
            if x_tr.ndim == 3:
                x_tr, x_te = x_tr[..., None], x_te[..., None]
        return x_tr, x_te
    except (FileNotFoundError, OSError):
        rs = np.random.RandomState(seed)
        shape = tuple(image_shape)
        # one coherent off-distribution prototype + small jitter: the
        # "edge case" property is that the examples resemble each OTHER,
        # not the training data
        proto = rs.normal(2.5, 0.3, shape).astype(np.float32)
        n_te = max(n_fallback // 4, 1)
        x = proto + rs.normal(0, 0.2, (n_fallback + n_te,) + shape)
        return (x[:n_fallback].astype(np.float32),
                x[n_fallback:].astype(np.float32))


def poison_edge_case(data: FederatedData, attacker_ids: Sequence[int],
                     target_label: int, pool: np.ndarray,
                     poison_frac: float = 0.5,
                     seed: int = 0) -> FederatedData:
    """Replace `poison_frac` of each attacker's real samples with edge-case
    pool images labeled `target_label` (data_loader.py mixing semantics:
    the attacker's shard is a clean/edge mixture)."""
    rs = np.random.RandomState(seed)
    shards = {k: np.array(v, copy=True) for k, v in data.client_shards.items()}
    C, B, bs = shards["mask"].shape
    for cid in attacker_ids:
        real = np.argwhere(shards["mask"][cid].reshape(-1) > 0).reshape(-1)
        n_poison = int(len(real) * poison_frac)
        if n_poison == 0:
            continue
        chosen = rs.choice(real, n_poison, replace=False)
        picks = rs.randint(0, len(pool), n_poison)
        bi, si = np.unravel_index(chosen, (B, bs))
        shards["x"][cid, bi, si] = pool[picks].astype(shards["x"].dtype)
        shards["y"][cid, bi, si] = target_label
    # fresh _device_cache — same shared-cache hazard as poison_federated_data
    return dataclasses.replace(data, client_shards=shards, _device_cache={})


def edge_case_test_shard(pool_test: np.ndarray, target_label: int,
                         batch_size: int = 64) -> dict:
    """Backdoor-success eval shard: every edge-case test image, labeled with
    the attacker's target (targetted_task_test_loader parity)."""
    n = len(pool_test)
    B = (n + batch_size - 1) // batch_size
    pad = B * batch_size - n
    x = np.concatenate([pool_test,
                        np.zeros((pad,) + pool_test.shape[1:],
                                 pool_test.dtype)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    y = np.full(B * batch_size, target_label, np.int64)
    return {"x": x.reshape((B, batch_size) + pool_test.shape[1:]),
            "y": y.reshape(B, batch_size),
            "mask": mask.reshape(B, batch_size)}


def backdoor_test_shard(data: FederatedData, target_label: int,
                        trigger_fn: Callable = pixel_trigger) -> dict:
    """Poisoned test set for the backdoor-success metric: every non-target
    test sample gets the trigger and the target label; originally-target
    samples are masked out (they would inflate the success rate)."""
    shard = {k: np.array(v, copy=True) for k, v in data.test_global.items()}
    shard["x"] = trigger_fn(shard["x"])
    not_target = (shard["y"] != target_label).astype(shard["mask"].dtype)
    shard["mask"] = shard["mask"] * not_target
    shard["y"] = np.full_like(shard["y"], target_label)
    return shard
