"""Logistic regression (port of fedml_tpu/models/lr.py; reference
fedml_api/model/linear/lr.py).

Raw logits; the loss owns the nonlinearity.  The Dense computes in f32
(flax ``nn.Dense(dtype=jnp.float32)``): under bf16 training it multiplies
the bf16-rounded x and kernel in f32.  flax infers the input width from
the first batch; here it is `in_features` (784, MNIST's 28x28, unless
given).
"""
from __future__ import annotations

import torch
from torch import nn

from fedml_tpu_torch.models.layers import Dense


class LogisticRegression(nn.Module):
    def __init__(self, num_classes: int, flatten: bool = True,
                 in_features: int = 784):
        super().__init__()
        self.flatten = flatten
        self.Dense_0 = Dense(in_features, num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        if self.flatten:
            x = x.reshape(x.shape[0], -1)
        return self.Dense_0(x)
