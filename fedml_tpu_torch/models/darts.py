"""The DARTS search space for FedNAS (port of fedml_tpu/models/darts.py;
reference fedml_api/model/cv/darts/{operations.py, genotypes.py,
model_search.py, model.py}).

A cell-based search space of 8 primitives: the supernet
(``DartsSearchNetwork``) mixes every primitive on every edge by the
softmax of the architecture weights (alphas), and ``derive_genotype``
keeps the two strongest incoming edges of each node for the retrained
network (``DartsNetwork``).  As in the JAX package, GroupNorm stands in
for BatchNorm (the bilevel search differentiates through the network
twice, and GroupNorm holds no state), the alphas are inputs of the
forward and not parameters, and every MixedOp computes all 8 branches
and mixes them with one ``tensordot``.

Layout: activations are NHWC tensors, as in the JAX package.  A conv
reads its NHWC input through the NCHW ``permute`` view (a channels_last
tensor, no copy) and hands its output back the same way; the GroupNorm
kernel takes the NHWC tensor as it is.

Where the numbers follow flax rather than PyTorch:
* GroupNorm's epsilon is flax's 1e-6; ``_gn`` takes 8, 4, 2 or 1 groups,
  the first that divides the channels;
* "SAME" padding is XLA's, asymmetric at stride 2: (0, 1) for 3x3 convs
  and pools, (1, 2) for 5x5 and for dilated 3x3 (extent 5), (3, 4) for
  dilated 5x5 (extent 9); ``SameConv2d`` pads with ``F.pad`` and
  convolves with no padding of its own;
* max pooling pads with -inf, and average pooling divides by the count of
  real (unpadded) elements under the window;
* FactorizedReduce's stride-2 1x1 convs slice first (``x[::2, ::2]`` and
  ``x[1::2, 1::2]``) and convolve at stride 1 (oneDNN's strided 1x1
  channels_last backward is wrong on the CPU); at an odd size the offset
  path is zero-padded at the end to the first's size;
* no ReLU runs in place: the second-order architect differentiates
  through every activation.

Submodules carry flax's auto names (``SearchCell_3.MixedOp_7.SepConv_1.
Conv_2``, ``FixedCell_0._FixedOp_2``, ...), so ``convert.flax_to_torch``
maps every path one to one; a depthwise conv's flax kernel (kh, kw, 1, C)
is the port's (C, 1, kh, kw), the generic HWIO -> OIHW transpose.

GDAS's straight-through Gumbel draws its uniforms from a torch.Generator
(``st_gumbel_softmax``), where JAX draws from a key; given the same
uniforms the two agree.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.layers import Dense
from fedml_tpu_torch.models.resnet_gn import (FLAX_GN_EPS, SameConv2d,
                                              same_padding)
from fedml_tpu_torch.ops.groupnorm import GroupNorm

Genotype = namedtuple("Genotype", "normal normal_concat reduce reduce_concat")

# the reference's 8-primitive vocabulary (genotypes.py:5-14)
PRIMITIVES = (
    "none",
    "max_pool_3x3",
    "avg_pool_3x3",
    "skip_connect",
    "sep_conv_3x3",
    "sep_conv_5x5",
    "dil_conv_3x3",
    "dil_conv_5x5",
)

# the published DARTS-V2 CIFAR genotype (genotypes.py)
DARTS_V2 = Genotype(
    normal=[("sep_conv_3x3", 0), ("sep_conv_3x3", 1), ("sep_conv_3x3", 0),
            ("sep_conv_3x3", 1), ("sep_conv_3x3", 1), ("skip_connect", 0),
            ("skip_connect", 0), ("dil_conv_3x3", 2)],
    normal_concat=[2, 3, 4, 5],
    reduce=[("max_pool_3x3", 0), ("max_pool_3x3", 1), ("skip_connect", 2),
            ("max_pool_3x3", 1), ("max_pool_3x3", 0), ("skip_connect", 2),
            ("skip_connect", 2), ("max_pool_3x3", 1)],
    reduce_concat=[2, 3, 4, 5],
)


def _gn(C: int) -> GroupNorm:
    for g in (8, 4, 2, 1):
        if C % g == 0:
            return GroupNorm(C, g, FLAX_GN_EPS)


def _conv(conv: SameConv2d, x: torch.Tensor) -> torch.Tensor:
    """An NCHW conv on an NHWC tensor, NHWC out."""
    y = conv(x.permute(0, 3, 1, 2))
    return y.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


class ReLUConvGN(nn.Module):
    """relu -> conv -> norm (the reference's ReLUConvBN,
    operations.py:23-35)."""

    def __init__(self, C_in: int, C_out: int, kernel: int = 1,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(C_in, C_out, kernel, stride)
        self.GroupNorm_0 = _gn(C_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(_conv(self.Conv_0, F.relu(x)))


class SepConv(nn.Module):
    """A depthwise-separable conv applied twice (operations.py:53-70)."""

    def __init__(self, C_in: int, C_out: int, kernel: int, stride: int):
        super().__init__()
        self.Conv_0 = SameConv2d(C_in, C_in, kernel, stride, groups=C_in)
        self.Conv_1 = SameConv2d(C_in, C_in, 1)
        self.GroupNorm_0 = _gn(C_in)
        self.Conv_2 = SameConv2d(C_in, C_in, kernel, 1, groups=C_in)
        self.Conv_3 = SameConv2d(C_in, C_out, 1)
        self.GroupNorm_1 = _gn(C_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv(self.Conv_1, _conv(self.Conv_0, F.relu(x)))
        x = _conv(self.Conv_3, _conv(self.Conv_2, F.relu(self.GroupNorm_0(x))))
        return self.GroupNorm_1(x)


class DilConv(nn.Module):
    """A dilated depthwise-separable conv (operations.py:38-50)."""

    def __init__(self, C_in: int, C_out: int, kernel: int, stride: int,
                 dilation: int = 2):
        super().__init__()
        self.Conv_0 = SameConv2d(C_in, C_in, kernel, stride, groups=C_in,
                                 dilation=dilation)
        self.Conv_1 = SameConv2d(C_in, C_out, 1)
        self.GroupNorm_0 = _gn(C_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.GroupNorm_0(
            _conv(self.Conv_1, _conv(self.Conv_0, F.relu(x))))


class FactorizedReduce(nn.Module):
    """Stride-2 reduction by two offset 1x1 convs (operations.py:81-97)."""

    def __init__(self, C_in: int, C_out: int):
        super().__init__()
        self.Conv_0 = SameConv2d(C_in, C_out // 2, 1, 2)
        self.Conv_1 = SameConv2d(C_in, C_out - C_out // 2, 1, 2)
        self.GroupNorm_0 = _gn(C_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        a = _conv(self.Conv_0, x)
        b = _conv(self.Conv_1, x[:, 1:, 1:, :])
        # the offset path loses a row and a column at odd sizes
        b = F.pad(b, (0, 0, 0, a.shape[2] - b.shape[2], 0, a.shape[1] - b.shape[1]))
        return self.GroupNorm_0(torch.cat([a, b], dim=-1))


def pool(x: torch.Tensor, kind: str, stride: int) -> torch.Tensor:
    """3x3 max or average pooling of NHWC x with XLA's "SAME" windows: max
    pads with -inf, average divides by the real elements under each
    window (count_include_pad=False)."""
    top, bottom = same_padding(x.shape[1], 3, stride)
    left, right = same_padding(x.shape[2], 3, stride)
    pad = (left, right, top, bottom)
    t = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(F.pad(t, pad, value=float("-inf")), 3, stride)
    else:
        ones = t.new_ones((1, 1) + tuple(t.shape[2:]))
        count = F.avg_pool2d(F.pad(ones, pad), 3, stride, divisor_override=1)
        y = F.avg_pool2d(F.pad(t, pad), 3, stride, divisor_override=1) / count
    return y.permute(0, 2, 3, 1)


class MixedOp(nn.Module):
    """All |PRIMITIVES| branches mixed by one edge's weights
    (model_search.py:10-24)."""

    def __init__(self, C: int, stride: int):
        super().__init__()
        self.stride = stride
        if stride != 1:
            self.FactorizedReduce_0 = FactorizedReduce(C, C)
        self.SepConv_0 = SepConv(C, C, 3, stride)
        self.SepConv_1 = SepConv(C, C, 5, stride)
        self.DilConv_0 = DilConv(C, C, 3, stride)
        self.DilConv_1 = DilConv(C, C, 5, stride)

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        s = self.stride
        outs = [
            torch.zeros_like(x[:, ::s, ::s, :]),                     # none
            pool(x, "max", s),                                       # max_pool_3x3
            pool(x, "avg", s),                                       # avg_pool_3x3
            x if s == 1 else self.FactorizedReduce_0(x),             # skip
            self.SepConv_0(x),
            self.SepConv_1(x),
            self.DilConv_0(x),
            self.DilConv_1(x),
        ]
        return torch.tensordot(w.to(x.dtype), torch.stack(outs), dims=([0], [0]))


class SearchCell(nn.Module):
    """One DARTS cell: `steps` intermediate nodes, each summing a MixedOp
    over all earlier states (model_search.py:26-60)."""

    def __init__(self, steps: int, multiplier: int, C_pp: int, C_p: int,
                 C: int, reduction: bool, reduction_prev: bool):
        super().__init__()
        self.steps, self.multiplier = steps, multiplier
        if reduction_prev:
            self.FactorizedReduce_0 = FactorizedReduce(C_pp, C)
            self.pre0 = "FactorizedReduce_0"
            self.ReLUConvGN_0 = ReLUConvGN(C_p, C)
            self.pre1 = "ReLUConvGN_0"
        else:
            self.ReLUConvGN_0 = ReLUConvGN(C_pp, C)
            self.ReLUConvGN_1 = ReLUConvGN(C_p, C)
            self.pre0, self.pre1 = "ReLUConvGN_0", "ReLUConvGN_1"
        k = 0
        for i in range(steps):
            for j in range(2 + i):
                stride = 2 if reduction and j < 2 else 1
                self.add_module(f"MixedOp_{k}", MixedOp(C, stride))
                k += 1

    def forward(self, s0, s1, weights: torch.Tensor) -> torch.Tensor:
        states = [getattr(self, self.pre0)(s0), getattr(self, self.pre1)(s1)]
        offset = 0
        for _ in range(self.steps):
            acc = 0.0
            for j, h in enumerate(states):
                k = offset + j
                acc = acc + getattr(self, f"MixedOp_{k}")(h, weights[k])
            offset += len(states)
            states.append(acc)
        return torch.cat(states[-self.multiplier:], dim=-1)


def gumbel_uniform(shape, generator: torch.Generator) -> torch.Tensor:
    """The uniforms of GDAS's Gumbel noise, in [1e-20, 1) (JAX's
    ``uniform(minval=1e-20, maxval=1.0)``), from `generator`."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return torch.clamp(1e-20 + (1.0 - 1e-20) * u, min=1e-20)


def st_gumbel_softmax(logits: torch.Tensor, uniform: torch.Tensor,
                      tau: float = 1.0) -> torch.Tensor:
    """Straight-through Gumbel-softmax over the op axis, given the noise's
    uniforms: the hard one-hot forward, the soft gradient (the GDAS
    single-path sampler, model_search_gdas.py; arXiv:1910.04465)."""
    g = -torch.log(-torch.log(uniform.to(logits.dtype)) + 1e-20)
    soft = torch.softmax((logits + g) / tau, dim=-1)
    hard = F.one_hot(soft.argmax(dim=-1), logits.shape[-1]).to(soft.dtype)
    return (hard - soft).detach() + soft


class DartsSearchNetwork(nn.Module):
    """The search-phase supernet (model_search.py:172-231), reduction cells
    at layers // 3 and 2 * layers // 3.  ``forward(x, alphas)`` takes
    alphas = {"normal": [k, O], "reduce": [k, O]} raw logits, or, with
    softmax_weights=False, the edges' mixing weights themselves (GDAS
    passes its straight-through samples)."""

    def __init__(self, num_classes: int, C: int = 16, layers: int = 8,
                 steps: int = 4, multiplier: int = 4,
                 stem_multiplier: int = 3, softmax_weights: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.softmax_weights = softmax_weights
        C_curr = stem_multiplier * C
        self.Conv_0 = SameConv2d(in_channels, C_curr, 3)
        self.GroupNorm_0 = _gn(C_curr)
        C_pp, C_p, C_curr = C_curr, C_curr, C
        self.reductions, reduction_prev = [], False
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                C_curr *= 2
            self.add_module(f"SearchCell_{i}", SearchCell(
                steps, multiplier, C_pp, C_p, C_curr, reduction,
                reduction_prev))
            self.reductions.append(reduction)
            C_pp, C_p = C_p, multiplier * C_curr
            reduction_prev = reduction
        self.Dense_0 = Dense(C_p, num_classes)

    def forward(self, x: torch.Tensor, alphas: dict, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [N, H, W, C] images -> [N, num_classes] logits (`train` and
        `rng` are taken and unused: no state, no dropout)."""
        if self.softmax_weights:
            w_normal = torch.softmax(alphas["normal"], dim=-1)
            w_reduce = torch.softmax(alphas["reduce"], dim=-1)
        else:
            w_normal, w_reduce = alphas["normal"], alphas["reduce"]
        s0 = s1 = self.GroupNorm_0(_conv(self.Conv_0, x))
        for i, reduction in enumerate(self.reductions):
            cell = getattr(self, f"SearchCell_{i}")
            s0, s1 = s1, cell(s0, s1, w_reduce if reduction else w_normal)
        return self.Dense_0(s1.mean(dim=(1, 2)))


def num_edges(steps: int = 4) -> int:
    return sum(2 + i for i in range(steps))


def init_alphas(generator: torch.Generator, steps: int = 4,
                device=None) -> dict:
    """1e-3 * randn of [k, O] for each cell kind, drawn on the CPU from
    `generator` (model_search.py:232-241)."""
    k = num_edges(steps)
    return {kind: (1e-3 * torch.randn(k, len(PRIMITIVES), generator=generator)
                   ).to(device or "cpu")
            for kind in ("normal", "reduce")}


def derive_genotype(alphas: dict, steps: int = 4,
                    multiplier: int = 4) -> Genotype:
    """Discretize: per node keep the 2 incoming edges whose best
    non-'none' op is strongest, then that op on each edge
    (model_search.py:258-296)."""
    none_idx = PRIMITIVES.index("none")
    ops = [k for k in range(len(PRIMITIVES)) if k != none_idx]

    def _parse(w):
        w = torch.softmax(torch.as_tensor(w).detach().float().cpu(),
                          dim=-1).tolist()
        gene, start, n = [], 0, 2
        for _ in range(steps):
            W = w[start:start + n]
            edges = sorted(range(n), key=lambda j: -max(W[j][k] for k in ops))[:2]
            for j in sorted(edges):
                k_best = max(ops, key=lambda k: W[j][k])
                gene.append((PRIMITIVES[k_best], j))
            start += n
            n += 1
        return gene
    concat = list(range(2 + steps - multiplier, steps + 2))
    return Genotype(normal=_parse(alphas["normal"]), normal_concat=concat,
                    reduce=_parse(alphas["reduce"]), reduce_concat=concat)


# ---------------------------------------------------------------------------
# the fixed (derived) network of the FedNAS train phase (cv/darts/model.py)
# ---------------------------------------------------------------------------

class _FixedOp(nn.Module):
    """One primitive of a derived genotype; the pools and a stride-1 skip
    hold no parameters."""

    def __init__(self, op: str, C: int, stride: int):
        super().__init__()
        self.op, self.stride = op, stride
        if op == "skip_connect":
            if stride != 1:
                self.FactorizedReduce_0 = FactorizedReduce(C, C)
        elif op in ("sep_conv_3x3", "sep_conv_5x5"):
            self.SepConv_0 = SepConv(C, C, int(op[-1]), stride)
        elif op in ("dil_conv_3x3", "dil_conv_5x5"):
            self.DilConv_0 = DilConv(C, C, int(op[-1]), stride)
        elif op not in ("max_pool_3x3", "avg_pool_3x3"):
            raise ValueError(f"op {op!r} not valid in a derived genotype")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.op == "skip_connect":
            return x if self.stride == 1 else self.FactorizedReduce_0(x)
        if self.op.endswith("pool_3x3"):
            return pool(x, self.op[:3], self.stride)
        inner = self.SepConv_0 if self.op.startswith("sep") else self.DilConv_0
        return inner(x)


class FixedCell(nn.Module):
    def __init__(self, genotype, C_pp: int, C_p: int, C: int,
                 reduction: bool, reduction_prev: bool):
        super().__init__()
        if reduction_prev:
            self.FactorizedReduce_0 = FactorizedReduce(C_pp, C)
            self.ReLUConvGN_0 = ReLUConvGN(C_p, C)
            self.pre0, self.pre1 = "FactorizedReduce_0", "ReLUConvGN_0"
        else:
            self.ReLUConvGN_0 = ReLUConvGN(C_pp, C)
            self.ReLUConvGN_1 = ReLUConvGN(C_p, C)
            self.pre0, self.pre1 = "ReLUConvGN_0", "ReLUConvGN_1"
        ops = genotype.reduce if reduction else genotype.normal
        self.concat = list(genotype.reduce_concat if reduction
                           else genotype.normal_concat)
        # ops come in pairs: 2 incoming edges per intermediate node
        self.edges = [j for _, j in ops]
        for i, (name, j) in enumerate(ops):
            stride = 2 if reduction and j < 2 else 1
            self.add_module(f"_FixedOp_{i}", _FixedOp(name, C, stride))

    def forward(self, s0, s1) -> torch.Tensor:
        states = [getattr(self, self.pre0)(s0), getattr(self, self.pre1)(s1)]
        for i in range(0, len(self.edges), 2):
            states.append(sum(getattr(self, f"_FixedOp_{k}")(states[self.edges[k]])
                              for k in (i, i + 1)))
        return torch.cat([states[i] for i in self.concat], dim=-1)


class DartsNetwork(nn.Module):
    """The train-phase network of a derived genotype (cv/darts/model.py
    NetworkCIFAR; drop-path omitted, as in the JAX package)."""

    def __init__(self, num_classes: int, genotype=DARTS_V2, C: int = 36,
                 layers: int = 20, stem_multiplier: int = 3,
                 in_channels: int = 3):
        super().__init__()
        C_curr = stem_multiplier * C
        self.Conv_0 = SameConv2d(in_channels, C_curr, 3)
        self.GroupNorm_0 = _gn(C_curr)
        C_pp, C_p, C_curr = C_curr, C_curr, C
        self.n_cells, reduction_prev = layers, False
        for i in range(layers):
            reduction = i in (layers // 3, 2 * layers // 3)
            if reduction:
                C_curr *= 2
            cell = FixedCell(genotype, C_pp, C_p, C_curr, reduction,
                             reduction_prev)
            self.add_module(f"FixedCell_{i}", cell)
            C_pp, C_p = C_p, len(cell.concat) * C_curr
            reduction_prev = reduction
        self.Dense_0 = Dense(C_p, num_classes)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        s0 = s1 = self.GroupNorm_0(_conv(self.Conv_0, x))
        for i in range(self.n_cells):
            s0, s1 = s1, getattr(self, f"FixedCell_{i}")(s0, s1)
        return self.Dense_0(s1.mean(dim=(1, 2)))
