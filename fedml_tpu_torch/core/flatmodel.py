"""One model's parameters as one flat vector, for the engines that train
a model outside ``ClientTrainer`` (SplitNN's two halves, FedGKT's client
and server nets, FedGAN's generator and discriminator).

The JAX engines carry such a model's params as a pytree and step it with
optax; here they travel as one f32 vector in the layout of ``spec`` (the
model's parameters in module order, unpadded), so one ``Optimizer`` of
``core/trainer.py`` steps the whole model elementwise, as optax steps every
leaf.  ``__call__`` runs the model on views of the vector.  The models
hold no buffers (no BatchNorm statistics): the vector is all of their
state.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from fedml_tpu_torch.models import init_params
from fedml_tpu_torch.ops.aggregate import spec_of, unflatten_to_tree


class FlatModel:
    def __init__(self, model: nn.Module):
        if any(True for _ in model.buffers()):
            raise ValueError(f"{type(model).__name__} holds buffers; FlatModel "
                             "carries parameters only")
        self.model = model
        self.spec = spec_of(dict(model.named_parameters()))

    def init(self, generator: torch.Generator, device) -> dict:
        """Fresh parameters (flax's default initializers, drawn on the CPU
        from `generator`) on `device`."""
        return {k: v.to(device) for k, v in
                init_params(self.model, generator).items()}

    def flatten(self, params: dict) -> torch.Tensor:
        """{name: tensor} -> one f32 vector of ``spec.n`` elements."""
        return torch.cat([params[n].reshape(-1).float() for n in self.spec.names])

    def unflatten(self, flat: torch.Tensor) -> dict:
        """The inverse of `flatten`: views of `flat`."""
        return unflatten_to_tree(flat, self.spec, flat.dtype)

    def __call__(self, flat: torch.Tensor, *args):
        return functional_call(self.model, self.unflatten(flat), args)
