"""Model zoo (port of fedml_tpu/models/__init__.py::create_model).

Every model takes NHWC images or [B, T] integer tokens, as the JAX
package's do, and ``forward(x, train=False, rng=None)``: `train` selects
BatchNorm's batch statistics (and updates its running ones) and turns
dropout on, drawing from `rng`, a torch.Generator.  ``init_params`` gives
the initial parameters and BatchNorm statistics with flax's default
initializers.
"""
from __future__ import annotations

from itertools import chain

import torch
from torch import nn

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.darts import (DARTS_V2, DartsNetwork,
                                          DartsSearchNetwork)
from fedml_tpu_torch.models.efficientnet import EfficientNet
from fedml_tpu_torch.models.layers import default_init
from fedml_tpu_torch.models.lr import LogisticRegression
from fedml_tpu_torch.models.mobilenet import MobileNetV1
from fedml_tpu_torch.models.mobilenet_v3 import MobileNetV3
from fedml_tpu_torch.models.resnet_cifar import (resnet20, resnet32, resnet44,
                                                 resnet56)
from fedml_tpu_torch.models.resnet_gn import ResNet18GN
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.models.segnet import SegEncoderDecoder
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.models.vgg import VGG11, VGG16


def create_model(model_name: str, output_dim: int, input_dim: int | None = None,
                 **kw) -> nn.Module:
    """Model factory keyed by the reference's --model names, with the JAX
    factory's keyword defaults.  flax infers input widths from the first
    batch; here LR's is `input_dim` (default 784, MNIST's 28x28), the CNNs
    take FEMNIST's 28x28x1 images and the others 3-channel images."""
    name = model_name.lower()
    if name == "lr":
        return LogisticRegression(num_classes=output_dim, flatten=True,
                                  in_features=input_dim or 784)
    if name == "cnn":
        return CNNOriginalFedAvg(num_classes=output_dim, **kw)
    if name == "cnn_dropout":
        return CNNDropOut(num_classes=output_dim, **kw)
    if name == "rnn":
        return RNNOriginalFedAvg(vocab_size=kw.pop("vocab_size", 90), **kw)
    if name == "rnn_stackoverflow":
        return RNNStackOverflow(vocab_size=kw.pop("vocab_size", output_dim),
                                **kw)
    if name == "transformer":
        return TransformerLM(vocab_size=output_dim, **kw)
    if name in ("resnet18_gn", "resnet18"):
        return ResNet18GN(num_classes=output_dim, **kw)
    if name == "resnet56":
        return resnet56(num_classes=output_dim, **kw)
    if name == "resnet20":
        return resnet20(num_classes=output_dim, **kw)
    if name == "mobilenet":
        return MobileNetV1(num_classes=output_dim, **kw)
    if name == "mobilenet_v3":
        return MobileNetV3(num_classes=output_dim, **kw)
    if name.startswith("efficientnet"):     # efficientnet-b0 .. -b7
        variant = name.rsplit("-", 1)[-1] if "-" in name else "b0"
        return EfficientNet(num_classes=output_dim, variant=variant, **kw)
    if name == "darts":
        return DartsNetwork(num_classes=output_dim,
                            genotype=kw.pop("genotype", DARTS_V2), **kw)
    if name == "vgg11":
        return VGG11(num_classes=output_dim, **kw)
    if name == "vgg16":
        return VGG16(num_classes=output_dim, **kw)
    if name == "segnet":
        return SegEncoderDecoder(num_classes=output_dim, **kw)
    raise ValueError(f"unknown model {model_name!r}")


def init_params(model: nn.Module, generator: torch.Generator) -> dict:
    """Fresh parameters and BatchNorm statistics ({name: tensor}, f32),
    drawn on the CPU from `generator` in module order (the same seed gives
    the same weights on any device), with flax's default initializers: a
    layer's ``flax_init`` where it has one, else ``layers.default_init``."""
    out = {}
    for prefix, module in model.named_modules():
        init = getattr(module, "flax_init", default_init)
        for name, t in chain(module.named_parameters(recurse=False),
                             module.named_buffers(recurse=False)):
            out[f"{prefix}.{name}" if prefix else name] = init(
                name, tuple(t.shape), generator)
    return out


__all__ = ["CNNDropOut", "CNNOriginalFedAvg", "DartsNetwork",
           "DartsSearchNetwork", "EfficientNet",
           "LogisticRegression", "MobileNetV1", "MobileNetV3",
           "RNNOriginalFedAvg", "RNNStackOverflow", "ResNet18GN",
           "SegEncoderDecoder", "TransformerLM", "VGG11", "VGG16", "create_model", "init_params",
           "resnet20", "resnet32", "resnet44", "resnet56"]
