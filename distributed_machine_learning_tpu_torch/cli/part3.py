"""part3 — bucketed ring all-reduce (reference ``part3/main.py``).

The reference wraps the model in DDP with 25 MB buckets
(``part3/main.py:137``): a bucketed ring all-reduce with averaging, VGG-11
with BatchNorm (``part3/model.py:24``), batch 64 a worker.  Here: the
explicit ring of ``ops/ring.py``, one process per rank, 25 MB buckets, mean
semantics.  ``--ring-compress {none,bf16,int8,topk}`` compresses each hop
(int8/topk with an error-feedback residual); ``--ring-codec-impl pallas``
runs the int8 codec through the hand-written kernels K8-K10.  Start one
process per rank::

    python -m distributed_machine_learning_tpu_torch.cli.part3 \\
        --master-ip 127.0.0.1:29500 --num-nodes 4 --rank R \\
        --ring-compress int8 --ring-codec-impl pallas
"""

from __future__ import annotations

from distributed_machine_learning_tpu_torch.cli.common import (
    make_flag_parser,
    parse_flags,
    run_part,
)

BATCH_SIZE = 64  # per worker — part3/main.py:31


def make_parser():
    parser = make_flag_parser(__doc__)
    parser.add_argument("--bucket-mb", default=25, type=int,
                        help="ring all-reduce bucket size (part3/main.py:137)")
    return parser


def main(argv=None, init_method: str | None = None) -> dict:
    """Run the part; ``init_method`` overrides the ``--master-ip`` rendezvous
    (``cli/parity.py`` starts its ranks on a ``file://`` one)."""
    args = parse_flags(make_parser(), argv)
    return run_part("ring", per_rank_batch=BATCH_SIZE, use_bn=True, args=args,
                    strategy_kwargs={"bucket_bytes": args.bucket_mb * 2**20},
                    init_method=init_method)


if __name__ == "__main__":
    main()
