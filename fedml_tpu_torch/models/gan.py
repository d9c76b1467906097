"""MNIST GAN (port of fedml_tpu/models/gan.py; reference
fedml_api/model/cv/mnist_gan.py:1-65): a dense generator z -> 784 with
tanh, and a dense discriminator 784 -> 1 with leaky ReLU (slope 0.2), for
FedGAN.  flax infers the discriminator's input width from the first
batch; here it is `in_features` (784, MNIST's 28x28)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 64, out_dim: int = 784):
        super().__init__()
        self.Dense_0 = Dense(latent_dim, 128)
        self.Dense_1 = Dense(128, 256)
        self.Dense_2 = Dense(256, out_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(z))))
        return torch.tanh(self.Dense_2(x))


class Discriminator(nn.Module):
    def __init__(self, in_features: int = 784):
        super().__init__()
        self.Dense_0 = Dense(in_features, 256)
        self.Dense_1 = Dense(256, 128)
        self.Dense_2 = Dense(128, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.Dense_0(x.reshape(x.shape[0], -1)), 0.2)
        x = F.leaky_relu(self.Dense_1(x), 0.2)
        return self.Dense_2(x)[:, 0]
