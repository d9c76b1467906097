"""Compact encoder-decoder segmentation net (port of
fedml_tpu/models/segnet.py, the stand-in for the reference's
DeepLabV3+/MobileNet fedseg backbones).

Images come in NHWC; the output is per-pixel class logits [B, H, W, C].
Inside, activations are NCHW in ``channels_last`` memory, as in
ResNet-18-GN, so the GroupNorm kernel reads them with no copy.  Every conv
has a bias (flax's default), 3x3 SAME or the 1x1 head; GroupNorm runs in
4 groups with flax's epsilon 1e-6.

``ConvTranspose`` is flax's ``nn.ConvTranspose`` with kernel = stride and
"SAME" padding (the output is exactly stride x the input).  flax does not
flip its kernel (``transpose_kernel=False``), PyTorch's transposed conv
does: the flax HWIO kernel K is this layer's weight flipped in both
spatial axes and laid out as (in, out, kh, kw) (``convert.py`` maps it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import lecun_normal, nhwc_to_nchw
from fedml_tpu_torch.models.resnet_gn import FLAX_GN_EPS, SameConv2d, _norm
from fedml_tpu_torch.ops.groupnorm import GroupNorm


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(out, (k, k), strides=(k, k))`` with a bias:
    weight (in, out, k, k), each input pixel writing one k x k tile."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 2):
        super().__init__()
        self.stride = kernel
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def flax_init(self, name: str, shape, generator) -> torch.Tensor:
        if name == "bias":
            return torch.zeros(shape)
        # lecun-normal over flax's (kh, kw, in, out) kernel: fan-in in*kh*kw
        return lecun_normal(shape, shape[0] * math.prod(shape[2:]), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=self.stride)


class SegEncoderDecoder(nn.Module):
    def __init__(self, num_classes: int = 21, width: int = 32,
                 in_channels: int = 3):
        super().__init__()
        w = width
        gn = lambda c: GroupNorm(c, 4, FLAX_GN_EPS)
        self.Conv_0, self.GroupNorm_0 = SameConv2d(in_channels, w, 3, bias=True), gn(w)
        self.Conv_1, self.GroupNorm_1 = SameConv2d(w, 2 * w, 3, bias=True), gn(2 * w)
        self.Conv_2, self.GroupNorm_2 = SameConv2d(2 * w, 4 * w, 3, bias=True), gn(4 * w)
        self.ConvTranspose_0 = ConvTranspose(4 * w, 2 * w)
        self.Conv_3, self.GroupNorm_3 = SameConv2d(2 * w, 2 * w, 3, bias=True), gn(2 * w)
        self.ConvTranspose_1 = ConvTranspose(2 * w, w)
        self.Conv_4, self.GroupNorm_4 = SameConv2d(w, w, 3, bias=True), gn(w)
        self.Conv_5 = SameConv2d(w, num_classes, 1, bias=True)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """x: [B, H, W, C] images -> [B, H, W, num_classes] logits (no state
        and no randomness: `train` and `rng` are taken and unused)."""
        block = lambda conv, gn, t: F.relu(_norm(gn, conv(t)))
        e1 = block(self.Conv_0, self.GroupNorm_0, nhwc_to_nchw(x))
        e2 = block(self.Conv_1, self.GroupNorm_1, F.max_pool2d(e1, 2))
        b = block(self.Conv_2, self.GroupNorm_2, F.max_pool2d(e2, 2))
        u1 = block(self.Conv_3, self.GroupNorm_3, self.ConvTranspose_0(b) + e2)
        u2 = block(self.Conv_4, self.GroupNorm_4, self.ConvTranspose_1(u1) + e1)
        return self.Conv_5(u2).permute(0, 2, 3, 1)
