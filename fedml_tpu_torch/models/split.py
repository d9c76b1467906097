"""Split-network pairs for SplitNN (port of fedml_tpu/models/split.py;
reference fedml_api/distributed/split_nn takes an arbitrary cut, and
fedml_experiments feeds it CIFAR CNNs).

`split_mlp` / `split_cnn` return (client_net, server_net): the client half
maps x to the activations at the cut, the server half activations to
logits (client.py:24-31 / server.py:40-55).  flax infers input widths from
the first batch; here the MLP takes `in_features` (784, MNIST's 28x28) and
the CNN `in_channels` x `image_size`^2 images (MNIST's 28x28x1), whose
pooled NHWC features the server half flattens as flax does.  flax's
``max_pool`` is VALID, as ``F.max_pool2d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense, flatten_nhwc, nhwc_to_nchw
from fedml_tpu_torch.models.resnet_gn import SameConv2d


class MLPLower(nn.Module):
    def __init__(self, hidden: int = 128, in_features: int = 784):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden)
        self.Dense_1 = Dense(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        return F.relu(self.Dense_1(x))


class MLPUpper(nn.Module):
    def __init__(self, num_classes: int = 10, hidden: int = 64,
                 in_features: int = 128):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden)
        self.Dense_1 = Dense(hidden, num_classes)

    def forward(self, acts: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(acts)))


class CNNLower(nn.Module):
    """Two 3x3 SAME convs (with bias), each followed by a 2x2 max pool;
    returns NHWC activations."""

    def __init__(self, in_channels: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_channels, 32, 3, bias=True)
        self.Conv_1 = SameConv2d(32, 64, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x[..., None] if x.dim() == 3 else x)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2)
        return x.permute(0, 2, 3, 1)


class CNNUpper(nn.Module):
    def __init__(self, num_classes: int = 10, in_features: int = 7 * 7 * 64):
        super().__init__()
        self.Dense_0 = Dense(in_features, 128)
        self.Dense_1 = Dense(128, num_classes)

    def forward(self, acts: torch.Tensor) -> torch.Tensor:
        x = acts.reshape(acts.shape[0], -1)       # NHWC order, as flax
        return self.Dense_1(F.relu(self.Dense_0(x)))


def split_mlp(num_classes: int = 10, hidden: int = 128,
              in_features: int = 784):
    return (MLPLower(hidden, in_features),
            MLPUpper(num_classes=num_classes, in_features=hidden))


def split_cnn(num_classes: int = 10, in_channels: int = 1,
              image_size: int = 28):
    pooled = image_size // 2 // 2
    return (CNNLower(in_channels),
            CNNUpper(num_classes, in_features=pooled * pooled * 64))
