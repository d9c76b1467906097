"""ResNet-18 with GroupNorm (port of fedml_tpu/models/resnet_gn.py; reference
fedml_api/model/cv/resnet_gn.py), the fed_CIFAR100 model of 'Adaptive
Federated Optimization'.

The public layout is the JAX package's: images come in as NHWC.  Inside,
activations are NCHW tensors in ``torch.channels_last`` memory format, so
cuDNN's convolutions and the GroupNorm kernel (which takes trailing-channel
memory) read the same bytes with no transposes: ``x.permute(0, 3, 1, 2)``
of an NHWC tensor is already such a tensor.

Convolutions pad like flax's ``padding="SAME"``: a stride-2 3x3 conv on an
even input pads (0, 1), not (1, 1).  GroupNorm uses flax's epsilon, 1e-6.
The head is a spatial mean and a Dense layer with bias; convs have no bias.
Submodules carry flax's names (``Conv_0``, ``GroupNorm_0``,
``BasicBlockGN_k``, ``Dense_0``), as in the rest of the zoo.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, nhwc_to_nchw
from fedml_tpu_torch.ops.groupnorm import GroupNorm

FLAX_GN_EPS = 1e-6     # flax nn.GroupNorm's default epsilon


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of flax/XLA "SAME" along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv with flax "SAME" padding (asymmetric where XLA's is); no bias
    unless asked, `groups` for depthwise convs, `dilation` for dilated
    ones (padded for the dilated kernel's extent)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, dilation: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, groups=groups,
                         bias=bias, dilation=dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _), (d, _) = self.kernel_size, self.stride, self.dilation
        conv = lambda t, **kw: F.conv2d(t, self.weight, self.bias,
                                        groups=self.groups, dilation=d, **kw)
        if k == 1:
            # a 1x1 stride-s conv reads every s-th pixel and pads nothing;
            # slicing first is the same function, and keeps clear of
            # oneDNN's strided 1x1 channels_last backward, whose weight
            # gradient is wrong on the CPU for narrow inputs
            return conv(x[:, :, ::s, ::s])
        k = d * (k - 1) + 1
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        if top == bottom and left == right:
            return conv(x, stride=self.stride, padding=(top, left))
        return conv(F.pad(x, (left, right, top, bottom)), stride=self.stride)


def _norm(gn: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm of an NCHW activation through its NHWC view (a no-copy
    permute when x is channels_last, as conv outputs here are)."""
    x = x.contiguous(memory_format=torch.channels_last)
    return gn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class BasicBlockGN(nn.Module):
    def __init__(self, in_filters: int, filters: int, strides: int = 1,
                 groups: int = 2):
        super().__init__()
        self.Conv_0 = SameConv2d(in_filters, filters, 3, strides)
        self.GroupNorm_0 = GroupNorm(filters, groups, FLAX_GN_EPS)
        self.Conv_1 = SameConv2d(filters, filters, 3)
        self.GroupNorm_1 = GroupNorm(filters, groups, FLAX_GN_EPS)
        self.has_shortcut = strides != 1 or in_filters != filters
        if self.has_shortcut:
            self.Conv_2 = SameConv2d(in_filters, filters, 1, strides)
            self.GroupNorm_2 = GroupNorm(filters, groups, FLAX_GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_norm(self.GroupNorm_0, self.Conv_0(x)))
        y = _norm(self.GroupNorm_1, self.Conv_1(y))
        residual = (_norm(self.GroupNorm_2, self.Conv_2(x))
                    if self.has_shortcut else x)
        return F.relu(y + residual)


class ResNet18GN(nn.Module):
    def __init__(self, num_classes: int = 100,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_filters: int = 64, groups: int = 2, in_channels: int = 3,
                 norm_fusion_barrier: bool = False):
        super().__init__()
        if norm_fusion_barrier:
            raise ValueError(
                "norm_fusion_barrier is an XLA fusion hint of the JAX package "
                "(lax.optimization_barrier) and has no PyTorch counterpart")
        self.Conv_0 = SameConv2d(in_channels, num_filters, 3)
        self.GroupNorm_0 = GroupNorm(num_filters, groups, FLAX_GN_EPS)
        self.blocks, in_f = [], num_filters
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                name = f"BasicBlockGN_{len(self.blocks)}"
                self.add_module(name, BasicBlockGN(in_f, num_filters * 2 ** i,
                                                   strides, groups))
                self.blocks.append(name)
                in_f = num_filters * 2 ** i
        self.Dense_0 = Dense(in_f, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """x: [N, H, W, C] images -> [N, num_classes] logits (no state and
        no randomness: `train` and `rng` are taken and unused)."""
        x = nhwc_to_nchw(x)
        x = F.relu(_norm(self.GroupNorm_0, self.Conv_0(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
