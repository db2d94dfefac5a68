"""Device-side normalization and augmentation.

Counterpart of ``distributed_machine_learning_tpu/data/augment.py``: the
reference's RandomCrop(32, padding=4) + RandomHorizontalFlip, then Normalize
with the fixed CIFAR statistics (``part1/main.py:82-89``), on uint8 NHWC
batches already on the device.  ``jax.random`` cannot be reproduced in
PyTorch, so the function is split in two: :func:`draw_augment` makes the
random draws from an explicit ``torch.Generator`` seeded from (seed, rank,
step) (on the host, so every device draws the same), and
:func:`crop_flip` applies them deterministically, which the tests hold bit
for bit against the JAX version fed the same draws.
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD

PADDING = 4


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> normalized f32 NHWC (ToTensor + Normalize)."""
    x = images_u8.float() / 255.0
    mean = torch.as_tensor(CIFAR10_MEAN, device=x.device)
    std = torch.as_tensor(CIFAR10_STD, device=x.device)
    return (x - mean) / std


def augment_seed(seed: int, rank: int, step: int) -> int:
    """The generator seed of one rank's draws at one step."""
    return (seed * 1_000_003 + rank * 7_919 + step) % (2**63 - 1)


def draw_augment(n: int, seed: int, rank: int, step: int, span: int = 2 * PADDING + 1):
    """(top [n], left [n], flip [n] bool) for one rank's batch at one step."""
    gen = torch.Generator().manual_seed(augment_seed(seed, rank, step))
    top = torch.randint(0, span, (n,), generator=gen)
    left = torch.randint(0, span, (n,), generator=gen)
    flip = torch.rand(n, generator=gen) < 0.5
    return top, left, flip


def crop_flip(images_u8: torch.Tensor, top, left, flip) -> torch.Tensor:
    """Pad by 4, crop each image at (top, left) to its own size, flip the
    flagged ones horizontally: uint8 NHWC in, uint8 NHWC out."""
    n, h, w, _ = images_u8.shape
    dev = images_u8.device
    top, left, flip = top.to(dev), left.to(dev), flip.to(dev)
    padded = torch.nn.functional.pad(images_u8, (0, 0, PADDING, PADDING, PADDING, PADDING))
    rows = top[:, None] + torch.arange(h, device=dev)[None, :]
    cols = torch.arange(w, device=dev)[None, :].expand(n, w)
    cols = left[:, None] + torch.where(flip[:, None], w - 1 - cols, cols)
    batch = torch.arange(n, device=dev)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def augment_batch(images_u8: torch.Tensor, seed: int, rank: int, step: int) -> torch.Tensor:
    """RandomCrop(32, pad 4) + RandomHorizontalFlip + normalize."""
    return normalize(crop_flip(images_u8, *draw_augment(images_u8.shape[0], seed, rank, step)))
