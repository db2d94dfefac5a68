"""LARS, layer-wise adaptive rate scaling for large-batch SGD.

Counterpart of ``distributed_machine_learning_tpu/train/lars.py`` (You
et al., "Large Batch Training of Convolutional Networks"; the apex/LARC
convention, momentum on the scaled step)::

    scale = trust · ||w|| / (||g|| + wd·||w|| + eps)   if both norms > 0
            1                                          otherwise (the plain lr)
    step  = lr · scale · (g + wd·w)
    m     = momentum · m + step
    w    -= m

In place on the parameters and the zero-initialized buffers (SGD's init);
the norms and the step in f32.  A set ``momentum_dtype`` is refused at
construction, as the reference refuses it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig


@dataclass(frozen=True)
class LARSConfig(SGDConfig):
    # The reference's SGD hyperparameters plus LARS's trust coefficient.
    trust_coefficient: float = 1e-3
    eps: float = 1e-9

    def __post_init__(self):
        if self.momentum_dtype is not None:
            raise ValueError("LARSConfig does not support momentum_dtype (the LARS "
                             "update accumulates in the buffer dtype); use sgd for "
                             "narrowed optimizer state")


@torch.no_grad()
def lars_update(params: dict, momentum_buf: dict, grads: dict, config: LARSConfig,
                lr=None, step=None, norm=None) -> tuple[dict, dict]:
    """One LARS step over every leaf, in place; returns (params, buffers).
    ``step`` is ignored (signature shared with AdamW).  ``norm(name, t)``:
    the L2 norm of a leaf's f32 weight or gradient (default: the tensor's
    own; a tensor-parallel rank sums the squares of a split leaf over its
    ranks)."""
    del step
    norm = norm or (lambda name, t: torch.linalg.vector_norm(t))
    if not isinstance(config, LARSConfig):
        raise TypeError(f"lars_update needs a LARSConfig on the TrainState, got "
                        f"{type(config).__name__}")
    lr = config.learning_rate if lr is None else lr
    wd = config.weight_decay
    for k, p in params.items():
        p32, g32 = p.float(), grads[k].float()
        w_norm = norm(k, p32)
        g_norm = norm(k, g32)
        scale = torch.where((w_norm > 0) & (g_norm > 0),
                            config.trust_coefficient * w_norm / (g_norm + wd * w_norm
                                                                  + config.eps),
                            torch.ones_like(w_norm))
        upd = lr * scale * (g32 + wd * p32)
        m = momentum_buf[k]
        m.mul_(config.momentum).add_(upd.to(m.dtype))
        p.sub_(m.to(p.dtype))
    return params, momentum_buf
