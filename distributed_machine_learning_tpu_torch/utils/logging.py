"""Rank-0-gated printing.

Counterpart of ``rank0_print`` in
``distributed_machine_learning_tpu/utils/logging.py``: informational prints
come from rank 0 of the process group (every call when no group is up),
with an escape hatch for per-rank lines.
"""

from __future__ import annotations

import sys


def process_rank() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def rank0_print(*args, all_ranks: bool = False, **kwargs) -> None:
    """print() on rank 0 only (or on every rank with ``all_ranks``), flushed."""
    if all_ranks or process_rank() == 0:
        print(*args, **kwargs)
        sys.stdout.flush()
