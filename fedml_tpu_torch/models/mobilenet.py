"""MobileNetV1 (port of fedml_tpu/models/mobilenet.py; reference
fedml_api/model/cv/mobilenet.py).

Depthwise-separable stacks (a 3x3 depthwise conv, ``groups`` = channels,
then a 1x1 pointwise conv, each followed by BatchNorm and ReLU) on the
CIFAR-sized stride-1 stem; `alpha` scales every width (at least 8).  NHWC
images in; "SAME" padding by flax's rule at every kernel and stride.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, nhwc_to_nchw
from fedml_tpu_torch.models.norms import BatchNorm
from fedml_tpu_torch.models.resnet_gn import SameConv2d

_CFG = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1)]


class DepthwiseSeparable(nn.Module):
    def __init__(self, c_in: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(c_in, c_in, 3, strides, groups=c_in)
        self.BatchNorm_0 = BatchNorm(c_in)
        self.Conv_1 = SameConv2d(c_in, filters, 1)
        self.BatchNorm_1 = BatchNorm(filters)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        return F.relu(self.BatchNorm_1(self.Conv_1(x), train))


class MobileNetV1(nn.Module):
    def __init__(self, num_classes: int = 10, alpha: float = 1.0):
        super().__init__()
        c = lambda f: max(8, int(f * alpha))
        self.Conv_0 = SameConv2d(3, c(32), 3)
        self.BatchNorm_0 = BatchNorm(c(32))
        self.blocks, ch = [], c(32)
        for i, (filters, strides) in enumerate(_CFG):
            self.add_module(f"DepthwiseSeparable_{i}",
                            DepthwiseSeparable(ch, c(filters), strides))
            self.blocks.append(f"DepthwiseSeparable_{i}")
            ch = c(filters)
        self.Dense_0 = Dense(ch, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(nhwc_to_nchw(x)), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))
