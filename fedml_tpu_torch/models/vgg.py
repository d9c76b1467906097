"""VGG-11 and VGG-16 (port of fedml_tpu/models/vgg.py; reference
fedml_api/model/cv/vgg.py): 3x3 SAME convs with bias and ReLU, 2x2 max
pools, a spatial mean, fc512, dropout 0.5 and the head.  NHWC images in.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, Dropout, nhwc_to_nchw
from fedml_tpu_torch.models.resnet_gn import SameConv2d

_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, cfg_name: str = "vgg11", num_classes: int = 10):
        super().__init__()
        self.layers, ch = [], 3
        for v in _CFGS[cfg_name]:
            if v != "M":
                name = f"Conv_{sum(l != 'M' for l in self.layers)}"
                self.add_module(name, SameConv2d(ch, v, 3, bias=True))
                v, ch = name, v
            self.layers.append(v)
        self.Dense_0 = Dense(ch, 512)
        self.Dropout_0 = Dropout(0.5)
        self.Dense_1 = Dense(512, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = nhwc_to_nchw(x)
        for layer in self.layers:
            x = (F.max_pool2d(x, 2) if layer == "M"
                 else F.relu(getattr(self, layer)(x)))
        x = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        return self.Dense_1(self.Dropout_0(x, train, rng))


def VGG11(num_classes: int = 10, **kw) -> VGG:
    return VGG(cfg_name="vgg11", num_classes=num_classes, **kw)


def VGG16(num_classes: int = 10, **kw) -> VGG:
    return VGG(cfg_name="vgg16", num_classes=num_classes, **kw)
