"""The parameter table part1 prints before training.

Counterpart of ``model_summary`` in
``distributed_machine_learning_tpu/utils/summary.py``: the reference prints
a torchsummary table (``part1/main.py:118``) whose ~9.2M-parameter total
its report leans on.  One row per module that owns parameters, with their
shapes and count, then the total and its f32 size.
"""

from __future__ import annotations

from torch import nn


def model_summary(model: nn.Module, title: str = "Model") -> str:
    groups: dict = {}
    for name, p in model.named_parameters():
        owner = name.rsplit(".", 1)[0]
        groups.setdefault(owner, []).append(p)
    width = 24
    rows = [f"  {owner:<{width}} {sum(p.numel() for p in ps):>12,}  "
            f"[{' '.join('x'.join(str(d) for d in p.shape) for p in ps)}]"
            for owner, ps in groups.items()]
    total = sum(p.numel() for p in model.parameters())
    return "\n".join([
        f"{title} summary", "-" * 64, *rows, "-" * 64,
        f"  {'Total params':<{width}} {total:>12,}",
        f"  {'Size (fp32)':<{width}} {total * 4 / 2**20:>10.2f} MB",
        "-" * 64,
    ])
