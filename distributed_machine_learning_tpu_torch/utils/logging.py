"""Rank-0-gated printing.

Counterpart of ``rank0_print`` in
``distributed_machine_learning_tpu/utils/logging.py``.  The port runs one
process (world 1) until multi-card training lands (ROADMAP A3), so every
print is rank 0's.
"""

from __future__ import annotations

import sys


def rank0_print(*args, all_ranks: bool = False, **kwargs) -> None:
    """print() on rank 0 (every call at world 1), flushed."""
    del all_ranks  # world 1: this process is rank 0
    print(*args, **kwargs)
    sys.stdout.flush()
