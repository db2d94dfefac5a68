"""PyTorch/CUDA port of ``distributed_machine_learning_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; module names here mirror
its names so each counterpart is easy to find.  This package imports
``torch`` and never ``jax``.  Every Pallas kernel on a ported path has a
hand-written CUDA kernel under ``ops/csrc/``, built at first use by
``ops/build.py``; on CPU tensors each kernel wrapper runs its plain
PyTorch version instead (the CPU tests hold those against the JAX package).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default.

    Raises when CUDA is asked for (explicitly or by default) and absent —
    the CPU is used only when the caller names it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
