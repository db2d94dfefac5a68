"""part2a — centralized gather/scatter sync (reference ``part2/2a/main.py``).

The reference gathers every gradient to rank 0, sums, scatters back
(``part2/2a/main.py:89-116``; SUM semantics, batch 64 a worker): here an
all-gather and the same rank-order sum on every rank.  Start one process
per rank::

    python -m distributed_machine_learning_tpu_torch.cli.part2a \\
        --master-ip 127.0.0.1:29500 --num-nodes 2 --rank R
"""

from __future__ import annotations

from distributed_machine_learning_tpu_torch.cli.common import (
    make_flag_parser,
    parse_flags,
    run_part,
)

BATCH_SIZE = 64  # per worker — part2/2a/main.py:33


def main(argv=None, init_method: str | None = None) -> dict:
    """Run the part; ``init_method`` overrides the ``--master-ip`` rendezvous
    (``cli/parity.py`` starts its ranks on a ``file://`` one)."""
    args = parse_flags(make_flag_parser(__doc__), argv)
    return run_part("gather_scatter", per_rank_batch=BATCH_SIZE, use_bn=False, args=args,
                    init_method=init_method)


if __name__ == "__main__":
    main()
