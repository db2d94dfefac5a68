"""AdamW — decoupled-weight-decay Adam (Loshchilov & Hutter).

Counterpart of ``distributed_machine_learning_tpu/train/adamw.py``.
Update rule (torch ``optim.AdamW`` semantics; ``t = step + 1``)::

    mu  = b1·mu + (1−b1)·g
    nu  = b2·nu + (1−b2)·g²
    m̂   = mu / (1 − b1ᵗ)          # bias correction
    n̂   = nu / (1 − b2ᵗ)
    p  −= lr · ( m̂ / (√n̂ + eps) + wd·p )

Moments are f32 whatever the parameter dtype.  The port updates the
parameters and moments in place (the reference returns new trees; its
step donates the old ones).  ``params``, ``moments["mu"|"nu"]`` and
``grads`` are dicts of tensors keyed by parameter name.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.ops.fused_adamw import (
    fused_adamw_leaf,
    fused_adamw_reference,
)


@dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    #: Run the update as the fused one-pass kernel (K7,
    #: ``ops/fused_adamw.py``; CLI ``--fused-update``) instead of the
    #: elementwise chain.  Same rule, held to 8 ulp per update.
    fused: bool = False


def adamw_init(params: dict, config=None) -> dict:
    """First/second-moment buffers: f32 zeros, one pair per parameter.
    ``config`` is taken for the registry's uniform signature."""
    del config
    zeros = lambda: {name: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                       device=p.device)
                     for name, p in params.items()}
    return {"mu": zeros(), "nu": zeros()}


def bias_corrections(config: AdamWConfig, step: int) -> tuple[float, float]:
    """``(1 − b1ᵗ, 1 − b2ᵗ)`` with ``t = step + 1``, computed in float32 from
    the integer step as the reference does, on the host (no device sync)."""
    t = np.float32(step) + np.float32(1.0)
    one = np.float32(1.0)
    bc1 = one - np.power(np.float32(config.beta1), t)
    bc2 = one - np.power(np.float32(config.beta2), t)
    return float(bc1), float(bc2)


@torch.no_grad()
def adamw_update(params: dict, moments: dict, grads: dict,
                 config: AdamWConfig, lr=None, step=None):
    """One AdamW step, in place; returns ``(params, moments)``.

    ``lr``: optional override of ``config.learning_rate``.  ``step``: the
    0-indexed step counter *before* this update (``TrainState.step``);
    required.  ``config.fused`` runs each leaf through K7 (on CUDA; its
    plain version on the CPU); otherwise the reference's elementwise chain
    (``adamw.py:95-102``), which is K7's plain version op for op."""
    if type(config) is not AdamWConfig:
        raise TypeError(
            f"adamw_update needs an AdamWConfig on the TrainState, got "
            f"{type(config).__name__}")
    if step is None:
        raise ValueError("adamw_update requires step= (the TrainState step "
                         "counter) for bias correction")
    lr = config.learning_rate if lr is None else lr
    bc1, bc2 = bias_corrections(config, step)
    update = fused_adamw_leaf if config.fused else fused_adamw_reference
    for name, p in params.items():
        update(p, moments["mu"][name], moments["nu"][name], grads[name], lr, bc1,
               bc2, beta1=config.beta1, beta2=config.beta2, eps=config.eps,
               weight_decay=config.weight_decay)
    return params, moments
