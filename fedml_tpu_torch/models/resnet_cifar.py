"""CIFAR ResNets 20/32/44/56 with BatchNorm (port of
fedml_tpu/models/resnet_cifar.py; reference fedml_api/model/cv/resnet.py).

Three stages of n BasicBlocks at 16/32/64 channels (ResNet-56 is n = 9,
the model of FedML's cross-silo benchmark).  BatchNorm is flax's
(models/norms.py, momentum 0.9 kept, epsilon 1e-5); its running
statistics are buffers, which the trainer carries after the parameters in
the flat vector and FedAvg averages with them.  NHWC images in; convs pad
as flax's "SAME" and have no bias.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, nhwc_to_nchw
from fedml_tpu_torch.models.norms import BatchNorm
from fedml_tpu_torch.models.resnet_gn import SameConv2d


class BasicBlock(nn.Module):
    def __init__(self, in_filters: int, filters: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_filters, filters, 3, strides)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = SameConv2d(filters, filters, 3)
        self.BatchNorm_1 = BatchNorm(filters)
        self.has_shortcut = strides != 1 or in_filters != filters
        if self.has_shortcut:
            self.Conv_2 = SameConv2d(in_filters, filters, 1, strides)
            self.BatchNorm_2 = BatchNorm(filters)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        residual = (self.BatchNorm_2(self.Conv_2(x), train)
                    if self.has_shortcut else x)
        return F.relu(y + residual)


class ResNetCIFAR(nn.Module):
    def __init__(self, n_per_stage: int = 9, num_classes: int = 10):
        super().__init__()
        self.Conv_0 = SameConv2d(3, 16, 3)
        self.BatchNorm_0 = BatchNorm(16)
        self.blocks, in_f = [], 16
        for i, filters in enumerate((16, 32, 64)):
            for j in range(n_per_stage):
                name = f"BasicBlock_{len(self.blocks)}"
                self.add_module(name, BasicBlock(
                    in_f, filters, 2 if i > 0 and j == 0 else 1))
                self.blocks.append(name)
                in_f = filters
        self.Dense_0 = Dense(64, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Conv_0(nhwc_to_nchw(x)), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet20(num_classes: int = 10, **kw) -> ResNetCIFAR:
    return ResNetCIFAR(n_per_stage=3, num_classes=num_classes, **kw)


def resnet32(num_classes: int = 10, **kw) -> ResNetCIFAR:
    return ResNetCIFAR(n_per_stage=5, num_classes=num_classes, **kw)


def resnet44(num_classes: int = 10, **kw) -> ResNetCIFAR:
    return ResNetCIFAR(n_per_stage=7, num_classes=num_classes, **kw)


def resnet56(num_classes: int = 10, **kw) -> ResNetCIFAR:
    return ResNetCIFAR(n_per_stage=9, num_classes=num_classes, **kw)
