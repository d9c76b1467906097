"""EfficientNet B0-B7 (port of fedml_tpu/models/efficientnet.py; reference
fedml_api/model/cv/efficientnet.py).

MBConv blocks (1x1 expand, kxk depthwise, squeeze-excite to a quarter of
the block's INPUT channels, 1x1 project) with swish, under the published
width/depth compound-scaling coefficients; BatchNorm epsilon 1e-3.
Stochastic depth ("drop-connect") drops a whole residual branch per
example in training, at a rate rising linearly to `drop_connect_rate`,
and scales the kept ones by 1/keep.  The head dropout takes the
variant's published rate.  CIFAR-sized stride-1 stem unless
`imagenet_stem`.  NHWC images in; "SAME" padding by flax's rule.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import (Dense, Dropout, bernoulli,
                                           nhwc_to_nchw)
from fedml_tpu_torch.models.norms import BatchNorm
from fedml_tpu_torch.models.resnet_gn import SameConv2d

# (width_mult, depth_mult, resolution, dropout): published B0-B7 scaling
PARAMS = {
    "b0": (1.0, 1.0, 224, 0.2), "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3), "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4), "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5), "b7": (2.0, 3.1, 600, 0.5),
}

# (expand, channels, repeats, stride, kernel): the B0 base architecture
_BASE = [
    (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_BN_EPS = 1e-3


def _round_filters(f: int, wm: float, divisor: int = 8) -> int:
    f = f * wm
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def _round_repeats(r: int, dm: float) -> int:
    return int(math.ceil(dm * r))


class MBConv(nn.Module):
    def __init__(self, inp: int, expand: int, out_ch: int, stride: int,
                 kernel: int, drop_rate: float = 0.0):
        super().__init__()
        mid = inp * expand
        self.expand = expand != 1
        self.residual = stride == 1 and inp == out_ch
        self.drop_rate = drop_rate
        convs = ([SameConv2d(inp, mid, 1)] if self.expand else []) + [
            SameConv2d(mid, mid, kernel, stride, groups=mid),
            SameConv2d(mid, out_ch, 1)]
        for i, conv in enumerate(convs):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}",
                            BatchNorm(conv.out_channels, eps=_BN_EPS))
        self.Dense_0 = Dense(mid, max(1, inp // 4))
        self.Dense_1 = Dense(max(1, inp // 4), mid)

    def _conv_bn(self, i: int, h: torch.Tensor, train: bool) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(h),
                                               train)

    def forward(self, x: torch.Tensor, train: bool,
                rng: torch.Generator | None) -> torch.Tensor:
        h, i = x, 0
        if self.expand:
            h, i = F.silu(self._conv_bn(0, h, train)), 1
        h = F.silu(self._conv_bn(i, h, train))
        s = F.silu(self.Dense_0(h.mean(dim=(2, 3))))
        h = h * torch.sigmoid(self.Dense_1(s))[:, :, None, None]
        h = self._conv_bn(i + 1, h, train)
        if not self.residual:
            return h
        if train and self.drop_rate > 0.0:          # drop-connect
            keep = 1.0 - self.drop_rate
            mask = bernoulli(keep, (h.shape[0], 1, 1, 1), h.device, rng)
            h = h * mask.to(h.dtype) / keep
        return h + x


class EfficientNet(nn.Module):
    def __init__(self, num_classes: int = 10, variant: str = "b0",
                 drop_connect_rate: float = 0.2, imagenet_stem: bool = False):
        super().__init__()
        wm, dm, _res, dropout = PARAMS[variant]
        ch = _round_filters(32, wm)
        self.Conv_0 = SameConv2d(3, ch, 3, 2 if imagenet_stem else 1)
        self.BatchNorm_0 = BatchNorm(ch, eps=_BN_EPS)
        blocks = [(e, _round_filters(c, wm), _round_repeats(r, dm), s, k)
                  for e, c, r, s, k in _BASE]
        total = sum(r for _, _, r, _, _ in blocks)
        self.blocks = []
        for expand, out, repeats, stride, kernel in blocks:
            for i in range(repeats):
                name = f"MBConv_{len(self.blocks)}"
                self.add_module(name, MBConv(
                    ch, expand, out, stride if i == 0 else 1, kernel,
                    drop_connect_rate * len(self.blocks) / total))
                self.blocks.append(name)
                ch = out
        last = _round_filters(1280, wm)
        self.Conv_1 = SameConv2d(ch, last, 1)
        self.BatchNorm_1 = BatchNorm(last, eps=_BN_EPS)
        self.Dropout_0 = Dropout(dropout)
        self.Dense_0 = Dense(last, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = F.silu(self.BatchNorm_0(self.Conv_0(nhwc_to_nchw(x)), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train, rng)
        x = F.silu(self.BatchNorm_1(self.Conv_1(x), train))
        return self.Dense_0(self.Dropout_0(x.mean(dim=(2, 3)), train, rng))
