"""FedSeg — federated semantic segmentation (port of
fedml_tpu/algorithms/fedseg.py, single-device engine).

Parity: fedml_api/distributed/fedseg/ (FedSegAggregator.py:1-240,
MyModelTrainer.py, utils.py Evaluator): the FedAvg skeleton with
pixel-wise CE and IoU/accuracy evaluation from a confusion matrix.

Training and aggregation are ``FedAvgEngine``'s (the server mean is the
fold kernel's finalize form on the card); only evaluation differs: the
confusion matrix of each eval shard is summed on the device
(``core/seg_metrics.py``), moved to the host once, and read into pixel
accuracy, per-class accuracy, mIoU and FWIoU, tracked by an
``EvaluationMetricsKeeper``.  The trainer must be built with
``has_time_axis=True`` (the per-sample mask broadcasts over H, W), and
with ``train_ignore_id=255`` for VOC's void label.  The mesh variant
(``make_mesh_fedseg_engine``) is ``SegEvalMixin`` over
``MeshFedAvgEngine`` (fedseg.py:74-87): the round is the mesh engine's,
over a client mesh of ranks or a batch axis alike, and the mesh's first
rank evaluates through the same int64 confusion matrix.
"""
from __future__ import annotations

import logging

import torch
from torch.func import functional_call

from fedml_tpu_torch.algorithms.fedavg import FedAvgEngine
from fedml_tpu_torch.core.seg_metrics import (EvaluationMetricsKeeper,
                                              confusion_matrix,
                                              frequency_weighted_iou, mean_iou,
                                              pixel_accuracy,
                                              pixel_accuracy_class)
from fedml_tpu_torch.core.trainer import broadcast_mask

log = logging.getLogger(__name__)


class SegEvalMixin:
    """Segmentation eval (confusion-matrix IoU/accuracy and the metrics
    keeper) in place of the classification `evaluate` of the FedAvg engine
    it is mixed over."""

    def _init_seg_eval(self):
        self.metrics_keeper = EvaluationMetricsKeeper()

    @torch.no_grad()
    def _shard_confusion(self, variables: dict, shard: dict) -> torch.Tensor:
        """The [C, C] int64 confusion matrix of a padded eval shard, summed
        over its batches on the device."""
        C = self.data.class_num
        cm = torch.zeros(C, C, dtype=torch.int64, device=self.device)
        for b in range(shard["mask"].shape[0]):
            x, y = shard["x"][b], shard["y"][b]
            if x.is_floating_point():
                x = x.to(next(iter(variables.values())).dtype)
            logits = functional_call(self.trainer.model, variables, (x,))
            cm += confusion_matrix(logits.argmax(dim=-1), y,
                                   broadcast_mask(shard["mask"][b], y), C)
        return cm

    def evaluate(self, variables: dict) -> dict:
        out = {}
        for split, shard in self._eval_shards.items():
            cm = self._shard_confusion(variables, shard).cpu().double().numpy()
            out[f"{split}_acc"] = pixel_accuracy(cm)
            out[f"{split}_acc_class"] = pixel_accuracy_class(cm)
            out[f"{split}_mIoU"] = mean_iou(cm)
            out[f"{split}_FWIoU"] = frequency_weighted_iou(cm)
        self.metrics_keeper.update(len(self.metrics_history), out)
        return out


class FedSegEngine(SegEvalMixin, FedAvgEngine):
    """FedAvg with segmentation eval."""

    program_family = "fedseg_resident"

    def __init__(self, trainer, data, cfg, device=None):
        super().__init__(trainer, data, cfg, device=device)
        self._init_seg_eval()


def make_mesh_fedseg_engine(trainer, data, cfg, mesh=None, **kw):
    """Mesh FedSeg: the training round IS MeshFedAvgEngine's (the fedseg
    aggregation is FedAvg, FedSegAggregator.py:1-240); only evaluation
    differs, supplied by SegEvalMixin.  A factory keeps parallel/ out of
    this module's imports for one-device users."""
    from fedml_tpu_torch.parallel.engine import MeshFedAvgEngine

    class MeshFedSegEngine(SegEvalMixin, MeshFedAvgEngine):
        def __init__(self, trainer, data, cfg, **kw2):
            super().__init__(trainer, data, cfg, **kw2)
            self._init_seg_eval()

    return MeshFedSegEngine(trainer, data, cfg, mesh=mesh, **kw)
