"""Training-time image augmentation (port of fedml_tpu/data/augment.py).

The reference's torchvision pipeline, RandomCrop(32, padding=4) +
RandomHorizontalFlip + Cutout(16) (cifar10/data_loader.py:57-98), as
batched tensor ops on the device the batch lies on.  The trainer applies
it in the training step only (core/trainer.py), so eval never augments.

JAX draws the crop offsets, flips and cutout centres with `jax.random`,
whose streams torch cannot reproduce, so the draw is split from the
transform:

* ``crop``, ``flip`` and ``cut`` are pure functions of x [bs, H, W, C] and
  their draws, each one batched gather or select with no loop over
  samples (JAX vmaps a ``dynamic_slice``).  Given the same draws they are
  bitwise JAX's transforms: they only move and zero values.
* ``random_crop``, ``random_flip`` and ``cutout`` draw on the generator's
  device (no host synchronisation) and apply the transform;
  ``make_augment_fn`` composes them as one (generator, x) -> x function.
  A generator of None draws from torch's default generator of x's device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _draw_device(generator: Optional[torch.Generator], x: torch.Tensor):
    return generator.device if generator is not None else x.device


def crop(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
         padding: int = 4) -> torch.Tensor:
    """Zero-pad x by `padding` on H and W, then take sample i's H x W
    window at offset (ys[i], xs[i]), offsets in [0, 2 * padding]."""
    bs, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    rows = ys.to(x.device)[:, None] + torch.arange(h, device=x.device)
    cols = xs.to(x.device)[:, None] + torch.arange(w, device=x.device)
    b = torch.arange(bs, device=x.device)[:, None, None]
    return xp[b, rows[:, :, None], cols[:, None, :]]


def flip(x: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Mirror sample i along W where flags[i] is true."""
    return torch.where(flags.to(x.device)[:, None, None, None], x.flip(2), x)


def cut(x: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
        length: int = 16) -> torch.Tensor:
    """Zero sample i's length x length square centred at (cy[i], cx[i]),
    clipped at the borders (JAX's half-open [c - length//2, c + length//2))."""
    _, h, w, _ = x.shape
    half = length // 2
    cy = cy.to(x.device)[:, None, None]
    cx = cx.to(x.device)[:, None, None]
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    inside = ((yy >= cy - half) & (yy < cy + half)
              & (xx >= cx - half) & (xx < cx + half))
    return x * (~inside)[..., None].to(x.dtype)


def random_crop(generator: Optional[torch.Generator], x: torch.Tensor,
                padding: int = 4) -> torch.Tensor:
    """RandomCrop(H, padding): offsets uniform in [0, 2 * padding]."""
    dev, bs = _draw_device(generator, x), x.shape[0]
    ys = torch.randint(0, 2 * padding + 1, (bs,), generator=generator,
                       device=dev)
    xs = torch.randint(0, 2 * padding + 1, (bs,), generator=generator,
                       device=dev)
    return crop(x, ys, xs, padding)


def random_flip(generator: Optional[torch.Generator],
                x: torch.Tensor) -> torch.Tensor:
    """RandomHorizontalFlip, p = 0.5 per sample."""
    u = torch.rand(x.shape[0], generator=generator,
                   device=_draw_device(generator, x))
    return flip(x, u < 0.5)


def cutout(generator: Optional[torch.Generator], x: torch.Tensor,
           length: int = 16) -> torch.Tensor:
    """Cutout(length) at a centre uniform over the image, so squares at the
    edges are partly cut (data_loader.py:57-77)."""
    dev, (bs, h, w, _) = _draw_device(generator, x), x.shape
    cy = torch.randint(0, h, (bs,), generator=generator, device=dev)
    cx = torch.randint(0, w, (bs,), generator=generator, device=dev)
    return cut(x, cy, cx, length)


def make_augment_fn(crop_padding: int = 4, flip: bool = True,
                    cutout_length: Optional[int] = 16):
    """The reference CIFAR pipeline as one (generator, x) -> x function,
    drawing crop, then flip, then cutout.  cutout_length=None disables
    cutout (the reference applies it only to CIFAR-10/100-style sets)."""
    do_flip = flip

    def augment(generator: Optional[torch.Generator],
                x: torch.Tensor) -> torch.Tensor:
        if crop_padding:
            x = random_crop(generator, x, crop_padding)
        if do_flip:
            x = random_flip(generator, x)
        if cutout_length:
            x = cutout(generator, x, cutout_length)
        return x

    return augment
