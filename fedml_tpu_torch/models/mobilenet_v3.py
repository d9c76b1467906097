"""MobileNetV3 (port of fedml_tpu/models/mobilenet_v3.py; reference
fedml_api/model/cv/mobilenet_v3.py).

Inverted residuals (1x1 expand, kxk depthwise, optional squeeze-excite,
1x1 project) with hard-swish, in the published Large and Small
configurations; widths rounded by ``_make_divisible``.  CIFAR-sized
stride-1 stem unless `imagenet_stem`.  ``hard_sigmoid`` is
relu6(x + 3) / 6.  NHWC images in; every conv pads as flax's "SAME" (a
5x5 stride-2 conv on an even input pads (1, 2)).  `dropout` is the rate
before the head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, Dropout, nhwc_to_nchw
from fedml_tpu_torch.models.norms import BatchNorm
from fedml_tpu_torch.models.resnet_gn import SameConv2d


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduce_ch: int):
        super().__init__()
        self.Dense_0 = Dense(channels, _make_divisible(reduce_ch))
        self.Dense_1 = Dense(_make_divisible(reduce_ch), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        s = hard_sigmoid(self.Dense_1(s))
        return x * s[:, :, None, None]


class InvertedResidual(nn.Module):
    """expand (1x1) -> depthwise (kxk, stride) -> [SE] -> project (1x1)."""

    def __init__(self, inp: int, kernel: int, exp_ch: int, out_ch: int,
                 use_se: bool, use_hs: bool, stride: int):
        super().__init__()
        self.act = hard_swish if use_hs else F.relu
        self.expand = exp_ch != inp
        self.residual = stride == 1 and inp == out_ch
        convs = ([SameConv2d(inp, exp_ch, 1)] if self.expand else []) + [
            SameConv2d(exp_ch, exp_ch, kernel, stride, groups=exp_ch),
            SameConv2d(exp_ch, out_ch, 1)]
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}", BatchNorm(conv.out_channels))
        self.n_convs = len(convs)
        self.SqueezeExcite_0 = SqueezeExcite(exp_ch, exp_ch // 4) if use_se else None

    def _conv_bn(self, i: int, h: torch.Tensor, train: bool) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(h),
                                               train)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h, i = x, 0
        if self.expand:
            h, i = self.act(self._conv_bn(0, h, train)), 1
        h = self.act(self._conv_bn(i, h, train))
        if self.SqueezeExcite_0 is not None:
            h = self.SqueezeExcite_0(h)
        h = self._conv_bn(i + 1, h, train)
        return h + x if self.residual else h


# (kernel, exp, out, SE, HS, stride): the published V3 configurations
_LARGE = [
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1),
]
_SMALL = [
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
]


class MobileNetV3(nn.Module):
    def __init__(self, num_classes: int = 10, mode: str = "large",
                 width_mult: float = 1.0, dropout: float = 0.2,
                 imagenet_stem: bool = False):
        super().__init__()
        cfg = _LARGE if mode == "large" else _SMALL
        wm = width_mult
        ch = _make_divisible(16 * wm)
        self.Conv_0 = SameConv2d(3, ch, 3, 2 if imagenet_stem else 1)
        self.BatchNorm_0 = BatchNorm(ch)
        self.blocks = []
        for i, (k, exp, out, se, hs, s) in enumerate(cfg):
            out = _make_divisible(out * wm)
            self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                ch, k, _make_divisible(exp * wm), out, se, hs, s))
            self.blocks.append(f"InvertedResidual_{i}")
            ch = out
        last = _make_divisible((960 if mode == "large" else 576) * wm)
        self.Conv_1 = SameConv2d(ch, last, 1)
        self.BatchNorm_1 = BatchNorm(last)
        hidden = 1280 if mode == "large" else 1024
        self.Dense_0 = Dense(last, hidden)
        self.Dropout_0 = Dropout(dropout)
        self.Dense_1 = Dense(hidden, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = hard_swish(self.BatchNorm_0(self.Conv_0(nhwc_to_nchw(x)), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train)
        x = hard_swish(self.BatchNorm_1(self.Conv_1(x), train))
        x = hard_swish(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(self.Dropout_0(x, train, rng))
