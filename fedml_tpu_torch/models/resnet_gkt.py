"""GKT split ResNet pair (port of fedml_tpu/models/resnet_gkt.py; reference
fedml_api/model/cv/resnet56_gkt/{resnet_client,resnet_server}.py): an
8-layer client net producing 16-channel feature maps and local logits,
and a 55-layer server net consuming them.

GroupNorm (2 groups, flax's epsilon 1e-6) replaces BatchNorm, as in the
JAX package: the server trains on uploaded features, so batch statistics
would be a hazard.  The blocks are ResNet-18-GN's ``BasicBlockGN`` (the
JAX ``GNBasicBlock``'s layers under the same names, with its SAME padding
and 1x1 shortcut when the shape changes).  Feature maps travel NHWC
([B, H, W, 16]), as the JAX package uploads them: the client's
channels_last activation seen through a no-copy permute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, nhwc_to_nchw
from fedml_tpu_torch.models.resnet_gn import (FLAX_GN_EPS, BasicBlockGN,
                                              SameConv2d, _norm)
from fedml_tpu_torch.ops.groupnorm import GroupNorm

FEATURES = 16          # the client's feature channels


class ResNetClientGKT(nn.Module):
    """resnet_client.py: conv stem + `n_blocks` blocks at 16 channels;
    returns (feature maps [B, H, W, 16], logits) — the client uploads
    both."""

    def __init__(self, num_classes: int = 10, n_blocks: int = 3,
                 in_channels: int = 3):
        super().__init__()
        self.Conv_0 = SameConv2d(in_channels, FEATURES, 3)
        self.GroupNorm_0 = GroupNorm(FEATURES, 2, FLAX_GN_EPS)
        self.blocks = [f"GNBasicBlock_{i}" for i in range(n_blocks)]
        for name in self.blocks:
            self.add_module(name, BasicBlockGN(FEATURES, FEATURES))
        self.Dense_0 = Dense(FEATURES, num_classes)

    def forward(self, x: torch.Tensor):
        x = F.relu(_norm(self.GroupNorm_0, self.Conv_0(nhwc_to_nchw(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.permute(0, 2, 3, 1), self.Dense_0(x.mean(dim=(2, 3)))


class ResNetServerGKT(nn.Module):
    """resnet_server.py: the deep tail (stages at 16/32/64 channels,
    `n_per_stage` blocks each, stride 2 into stages 2 and 3) on the
    client's feature maps."""

    def __init__(self, num_classes: int = 10, n_per_stage: int = 6):
        super().__init__()
        self.blocks, in_f = [], FEATURES
        for i, filters in enumerate((16, 32, 64)):
            for j in range(n_per_stage):
                name = f"GNBasicBlock_{len(self.blocks)}"
                self.add_module(name, BasicBlockGN(
                    in_f, filters, 2 if i > 0 and j == 0 else 1))
                self.blocks.append(name)
                in_f = filters
        self.Dense_0 = Dense(in_f, num_classes)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(feats)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))
