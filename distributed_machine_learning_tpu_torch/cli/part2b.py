"""part2b — collective all-reduce sync (reference ``part2/2b/main.py``).

One ``dist.all_reduce(SUM)`` per parameter (``part2/2b/main.py:101-106``);
SUM semantics (no division by the world size), batch 64 a worker.  Start
one process per rank (``--num-nodes N --rank R``).
"""

from __future__ import annotations

from distributed_machine_learning_tpu_torch.cli.common import (
    make_flag_parser,
    parse_flags,
    run_part,
)

BATCH_SIZE = 64  # per worker — part2/2b/main.py:31


def main(argv=None, init_method: str | None = None) -> dict:
    """Run the part; ``init_method`` overrides the ``--master-ip`` rendezvous
    (``cli/parity.py`` starts its ranks on a ``file://`` one)."""
    args = parse_flags(make_flag_parser(__doc__), argv)
    return run_part("all_reduce", per_rank_batch=BATCH_SIZE, use_bn=False, args=args,
                    init_method=init_method)


if __name__ == "__main__":
    main()
