"""FedAvg-paper CNNs (port of fedml_tpu/models/cnn.py; reference
fedml_api/model/cv/cnn.py).

CNNOriginalFedAvg: 2 x (5x5 SAME conv + 2x2 max pool) + fc512 + head, the
1.69M-parameter FEMNIST model of McMahan et al.; CNNDropOut: two 3x3 VALID
convs, one pool, dropout 0.25 and 0.5 around fc128.  Images come in NHWC
([N, H, W] is read as one channel); the features are flattened in NHWC
order, as flax flattens them, before the first Dense, whose width flax
infers from the first batch and which here is FEMNIST's 28x28 images'.
flax's ``max_pool`` is VALID and floors odd sizes, as ``F.max_pool2d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import (Dense, Dropout, flatten_nhwc,
                                           nhwc_to_nchw)
from fedml_tpu_torch.models.resnet_gn import SameConv2d


def _images(x: torch.Tensor) -> torch.Tensor:
    return nhwc_to_nchw(x[..., None] if x.dim() == 3 else x)


class CNNOriginalFedAvg(nn.Module):
    def __init__(self, num_classes: int = 62, only_digits: bool = False):
        super().__init__()
        self.Conv_0 = SameConv2d(1, 32, 5, bias=True)
        self.Conv_1 = SameConv2d(32, 64, 5, bias=True)
        self.Dense_0 = Dense(7 * 7 * 64, 512)        # 28 -> 14 -> 7
        self.Dense_1 = Dense(512, 10 if only_digits else num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = F.max_pool2d(F.relu(self.Conv_0(_images(x))), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        return self.Dense_1(F.relu(self.Dense_0(flatten_nhwc(x))))


class CNNDropOut(nn.Module):
    def __init__(self, num_classes: int = 62, only_digits: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(1, 32, 3)
        self.Conv_1 = nn.Conv2d(32, 64, 3)
        self.Dropout_0 = Dropout(0.25)
        self.Dense_0 = Dense(12 * 12 * 64, 128)      # 28 -> 26 -> 24 -> 12
        self.Dropout_1 = Dropout(0.5)
        self.Dense_1 = Dense(128, 10 if only_digits else num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(_images(x)))))
        x = self.Dropout_0(F.max_pool2d(x, 2), train, rng)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(self.Dropout_1(x, train, rng))
