"""SGD with momentum and weight decay, torch-update semantics.

Counterpart of ``distributed_machine_learning_tpu/train/sgd.py``: the
reference's ``optim.SGD(lr=0.1, momentum=0.9, weight_decay=1e-4)``
(``part1/main.py:120-121``), non-Nesterov, no dampening::

    g   = grad + weight_decay * param
    buf = momentum * buf + g          # zero-initialized: first step buf = g
    param -= lr * buf

In place on the parameters and the buffers (the reference's functional
update returns new trees).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SGDConfig:
    # Reference hyperparameters (part1/main.py:120-121).
    learning_rate: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # Momentum-buffer storage dtype name ("bfloat16"), or None for the
    # parameter's; the update math stays f32.
    momentum_dtype: str | None = None


def sgd_init(params: dict, config: SGDConfig | None = None) -> dict:
    """Zero momentum buffers by parameter name."""
    name = getattr(config, "momentum_dtype", None)
    return {k: torch.zeros_like(p, dtype=getattr(torch, name) if name else p.dtype)
            for k, p in params.items()}


@torch.no_grad()
def sgd_update(params: dict, momentum_buf: dict, grads: dict, config: SGDConfig,
               lr=None, step=None) -> tuple[dict, dict]:
    """One SGD step over every leaf, in place; returns (params, buffers).
    ``lr`` overrides the config's rate; ``step`` is ignored (signature
    shared with AdamW)."""
    del step
    lr = config.learning_rate if lr is None else lr
    for k, p in params.items():
        g = grads[k] + config.weight_decay * p
        m = momentum_buf[k]
        m_new = config.momentum * m.to(g.dtype) + g
        p.sub_(lr * m_new)
        m.copy_(m_new)
    return params, momentum_buf
