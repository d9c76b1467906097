"""Model factory (port of fedml_tpu/models/__init__.py::create_model).

The port has ResNet-18-GN so far; the rest of the JAX package's model zoo
is still to be ported (ROADMAP.md, slice 3)."""
from __future__ import annotations

from fedml_tpu_torch.models.resnet_gn import ResNet18GN, init_params


def create_model(model_name: str, output_dim: int, input_dim: int | None = None,
                 **kw):
    """Model factory keyed by the reference's --model names."""
    name = model_name.lower()
    if name in ("resnet18_gn", "resnet18"):
        return ResNet18GN(num_classes=output_dim, **kw)
    raise ValueError(f"model {model_name!r} is not ported to PyTorch yet "
                     "(the model zoo is slice 3 of the port, ROADMAP.md)")


__all__ = ["ResNet18GN", "create_model", "init_params"]
