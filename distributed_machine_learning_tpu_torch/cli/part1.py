"""part1 — the single-process baseline (reference ``part1/main.py``).

Batch 256 (``part1/main.py:18``), VGG-11 without BatchNorm, no sync.
Run: ``python -m distributed_machine_learning_tpu_torch.cli.part1`` (on the
card; ``--device cpu`` for the CPU).
"""

from __future__ import annotations

from distributed_machine_learning_tpu_torch.cli.common import (
    make_flag_parser,
    parse_flags,
    run_part,
)

BATCH_SIZE = 256  # part1/main.py:18


def main(argv=None, init_method: str | None = None) -> dict:
    """Run the part; ``init_method`` overrides the ``--master-ip`` rendezvous
    (``cli/parity.py`` starts its ranks on a ``file://`` one)."""
    args = parse_flags(make_flag_parser(__doc__), argv)
    return run_part("none", per_rank_batch=BATCH_SIZE, use_bn=False, args=args,
                    init_method=init_method)


if __name__ == "__main__":
    main()
