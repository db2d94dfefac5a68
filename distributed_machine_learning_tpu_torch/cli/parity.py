"""Parity harness: all four reference parts, one command.

Counterpart of ``distributed_machine_learning_tpu/cli/parity.py``.  The
reference's published end state (``group25.pdf``, via BASELINE.md) is
part1's 10 % test accuracy and 2.3031 average test loss after 40
iterations, and the parts' execution times (93.44 / 47.23 / 36.44 /
32.68 s for parts 1 / 2a / 2b / 3).  This runs the reference protocol for
every part through the port's own part CLIs, with their default batch
sizes, seed 69143, the 40-iteration cap and the whole-test-set eval, and
prints a table beside the published numbers.  The JAX package runs a
multi-device part in one process; the port runs one process per rank, so
the distributed parts start ``--num-nodes`` ranks (``runtime/launch.spawn``)
and rank 0's printed lines are parsed, with the reference harness's
regexes.

Usage::

    python -m distributed_machine_learning_tpu_torch.cli.parity \\
        --data-root /path/with/cifar-10-batches-py [--num-nodes 4]

Without a real ``cifar-10-batches-py/`` under ``--data-root`` every row
is marked ``synthetic`` (the deterministic stand-in, ``data/cifar10.py``).
``--equivalence`` machine-checks the report's equivalence argument
instead (:func:`run_equivalence`).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

# Published numbers: group25.pdf via BASELINE.md.
REFERENCE = {
    "part1": {
        "total_s": 93.44, "avg_iter_s": 2.39,
        "accuracy_pct": 10.0, "avg_test_loss": 2.3031,
        "config": "batch 256, 1 CPU node", "source": "group25.pdf p.2",
    },
    "part2a": {
        "total_s": 47.23, "avg_iter_s": 1.21,
        "config": "batch 64/node, 4 CPU nodes", "source": "group25.pdf p.3",
    },
    "part2b": {
        "total_s": 36.44, "avg_iter_s": 0.934,
        "config": "batch 64/node, 4 CPU nodes", "source": "group25.pdf p.5",
    },
    "part3": {
        "total_s": 32.68, "avg_iter_s": 0.838,
        "config": "batch 64/node, 4 CPU nodes", "source": "group25.pdf p.6",
    },
}

_PARTS = list(REFERENCE)
SPAWN_TIMEOUT_S = 1800.0


def _parse_output(out: str) -> dict:
    """The reference-protocol numbers in a part's printed lines."""
    res: dict = {}
    m = re.search(r"Total execution time is : ([\d.eE+-]+) seconds", out)
    if m:
        res["total_s"] = float(m.group(1))
    m = re.search(r"Average execution time is\s+: ([\d.eE+-]+) seconds", out)
    if m:
        res["avg_iter_s"] = float(m.group(1))
    m = re.search(r"Test set: Average loss: ([\d.]+), Accuracy: \d+/\d+ \((\d+)%\)", out)
    if m:
        res["avg_test_loss"] = float(m.group(1))
        res["accuracy_pct"] = float(m.group(2))
    return res


def _run_part_captured(part: str, argv: list, init_method: str | None = None) -> str:
    """One rank of ``part`` with its stdout captured."""
    import importlib

    main = importlib.import_module(f"distributed_machine_learning_tpu_torch.cli.{part}").main
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv, init_method=init_method)
    return buf.getvalue()


def _part_rank(rank: int, world: int, init_method: str, part: str, argv: list) -> str:
    """A spawned rank: the part's printed lines (rank 0's are the report's)."""
    return _run_part_captured(part, [*argv, "--num-nodes", str(world), "--rank", str(rank)],
                              init_method)


def part_worlds(args) -> dict:
    """The ranks each part runs on: part1 one, the others ``--num-nodes``."""
    return {p: 1 if p == "part1" else args.num_nodes for p in _PARTS}


def run_parity(args) -> list[dict]:
    """Run the selected parts; one result row per part."""
    from distributed_machine_learning_tpu_torch.data.cifar10 import _maybe_extract
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    real_data = os.path.isdir(args.data_root) and _maybe_extract(args.data_root) is not None
    # The whole list is checked before any (long) training run.
    parts = [p.strip() for p in args.parts.split(",")]
    unknown = [p for p in parts if p not in REFERENCE]
    if unknown:
        raise ValueError(f"unknown part(s) {unknown}; choose from {_PARTS}")
    worlds = part_worlds(args)
    rows = []
    for part in parts:
        argv = ["--data-root", args.data_root, "--max-iters", str(args.max_iters)]
        for flag, value in (("--batch-size", args.batch_size),
                            ("--eval-batches", args.eval_batches),
                            ("--eval-batch-size", args.eval_batch_size),
                            ("--model", args.model), ("--device", args.device)):
            if value is not None:
                argv += [flag, str(value)]
        world = worlds[part]
        print(f"[parity] running {part} {' '.join(argv)} (world {world})", file=sys.stderr)
        if world == 1:
            out = _run_part_captured(part, argv)
        else:
            out = spawn(_part_rank, world, (part, argv), timeout_s=SPAWN_TIMEOUT_S)[0]
        got = _parse_output(out)
        if not got:
            raise RuntimeError(f"{part} produced no parseable protocol output:\n{out}")
        rows.append({
            "part": part,
            "data": "cifar-10-batches-py" if real_data else "synthetic",
            "world": world,
            "max_iters": args.max_iters,
            "reference": REFERENCE[part],
            "measured": got,
        })
    return rows


def print_table(rows: list[dict]) -> None:
    hdr = (f"{'part':8} {'metric':15} {'reference':>12} {'measured':>12} "
           f"{'ref/ours':>9}  note")
    print(hdr)
    print("-" * len(hdr))
    for row in rows:
        ref, got = row["reference"], row["measured"]
        note = f"{row['data']}, world={row['world']} (ref: {ref['config']})"
        # The reference total is 39 timed iterations; a shortened run's total
        # is not comparable (sec/iter stays fair at any cap).
        full_protocol = row["max_iters"] == 40
        timed = max(row["max_iters"] - 1, 1)
        for key, label in (("total_s", f"total_s({timed}it)"), ("avg_iter_s", "sec/iter"),
                           ("accuracy_pct", "accuracy_%"), ("avg_test_loss", "avg_test_loss")):
            if key not in ref:
                continue
            r = ref[key]
            g = got.get(key)
            if g is None:
                cell, ratio = "—", "—"
            else:
                cell = f"{g:.4f}" if key != "accuracy_pct" else f"{g:.0f}"
                comparable = key == "avg_iter_s" or (key == "total_s" and full_protocol)
                ratio = (f"{r / g:.1f}x" if key.endswith("_s") and g > 0 and comparable
                         else "—")
            print(f"{row['part']:8} {label:15} {r:>12} {cell:>12} {ratio:>9}  {note}")
            note = ""
    if any(r["data"] == "synthetic" for r in rows):
        print("\nNOTE: no cifar-10-batches-py found under --data-root — the parts trained "
              "on the deterministic synthetic stand-in, so accuracy/loss rows are NOT a "
              "real-data parity claim.  Place the dataset (or its .tar.gz) under "
              "--data-root and re-run.")


def _batches(iters: int, global_batch: int):
    import numpy as np

    from distributed_machine_learning_tpu_torch.cli.common import SEED

    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, 256, (global_batch, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, global_batch).astype(np.int32)) for _ in range(iters)]


def _trajectory(model_name: str, lr: float, batches, device, strategy=None, comm=None,
                rows=None) -> list:
    """The printed loss of every step of one run: BN-free model, seed-69143
    init, augmentation and weight decay off; ``rows`` selects this rank's
    slice of each global batch."""
    import torch

    from distributed_machine_learning_tpu_torch.cli.common import SEED
    from distributed_machine_learning_tpu_torch.models.registry import get_model, init_params
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    model = init_params(get_model(model_name, use_bn=False, device=device), SEED)
    state = TrainState.create(model, SGDConfig(learning_rate=lr, weight_decay=0.0))
    step = make_train_step(model, strategy, comm, augment=False)
    losses = []
    for x, y in batches:
        if rows is not None:
            x, y = x[rows], y[rows]
        state, loss = step(state, torch.from_numpy(x).to(device),
                           torch.from_numpy(y).to(device, torch.long))
        losses.append(float(loss))
    return losses


def _equivalence_rank(rank: int, world: int, init_method: str, model_name: str, lr: float,
                      iters: int, per_node: int, device) -> dict:
    """One rank of the three distributed trajectories (2a, 2b, 3)."""
    from distributed_machine_learning_tpu_torch.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    ctx = initialize_from_flags(rank=rank, num_nodes=world, device=device,
                                init_method=init_method)
    try:
        batches = _batches(iters, per_node * world)
        rows = slice(rank * per_node, (rank + 1) * per_node)  # rank-major, as the mesh shards
        return {name: _trajectory(model_name, lr, batches, ctx.device, get_strategy(name),
                                  ctx.comm, rows)
                for name in ("gather_scatter", "all_reduce", "ring")}
    finally:
        ctx.shutdown()


def run_equivalence(args) -> dict:
    """Machine-check the report's equivalence argument (group25.pdf p.5-6)
    as a loss-trajectory table on deterministic synthetic data:

    - **part2a ≡ part2b**: gather→sum→scatter and all-reduce(SUM) are the
      same update through different collectives;
    - **SUM parts ≡ part1 at world× lr**: the summed gradient over w ranks
      is w × the global-batch mean gradient;
    - **part3 (mean) ≡ part1**: the ring's averaged update is part1's rule.

    Controlled: BN-free model, augmentation off, weight decay off (the SUM ≡
    hot-lr identity holds for the gradient term only), identical batches and
    seed-69143 init; only the strategy varies.  The distributed parts run
    ``min(4, --num-nodes)`` ranks; a world of 1 would make every check pass
    vacuously, so it is refused."""
    import numpy as np

    from distributed_machine_learning_tpu_torch import resolve_device
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    world = min(4, args.num_nodes)  # the reference cluster was 4 nodes
    if world < 2:
        raise ValueError("the equivalence check needs >= 2 ranks (a world of 1 makes "
                         "every check vacuously pass); run with --num-nodes 2 or more")
    iters = args.max_iters
    per_node = args.batch_size or 64
    global_batch = per_node * world
    model_name = args.model or "vgg11"
    base_lr = 0.1  # part1/main.py:120
    print(f"[equivalence] world={world}, per-node batch {per_node} (global {global_batch}), "
          f"{iters} iters, model {model_name} (BN-free), augment off", file=sys.stderr)
    device = resolve_device(args.device)
    batches = _batches(iters, global_batch)
    part1 = np.asarray(_trajectory(model_name, base_lr, batches, device))
    part1_hot = np.asarray(_trajectory(model_name, base_lr * world, batches, device))
    ranks = spawn(_equivalence_rank, world,
                  (model_name, base_lr, iters, per_node, args.device),
                  timeout_s=SPAWN_TIMEOUT_S)
    p2a, p2b, p3 = (np.asarray(ranks[0][k]) for k in ("gather_scatter", "all_reduce", "ring"))
    checks = {
        # identical SUM through different collectives: associativity noise only
        "part2a==part2b": (p2a, p2b, 1e-5),
        # SUM semantics = world× effective lr (f32 reduction-order drift)
        f"part2b==part1@lr*{world}": (p2b, part1_hot, 2e-3),
        # the ring's mean = DDP's averaged update = part1's rule
        "part3==part1": (p3, part1, 1e-4),
    }
    hdr = (f"{'iter':>4} {'part1':>9} {'p1@hotlr':>9} {'part2a':>9} "
           f"{'part2b':>9} {'part3':>9}")
    print(hdr)
    print("-" * len(hdr))
    for i in range(0, iters, max(1, iters // 8)):
        print(f"{i:>4} {part1[i]:9.5f} {part1_hot[i]:9.5f} {p2a[i]:9.5f} "
              f"{p2b[i]:9.5f} {p3[i]:9.5f}")
    results = {}
    ok = True
    for name, (a, b, tol) in checks.items():
        dev = float(np.max(np.abs(a - b)))
        passed = dev <= tol
        ok &= passed
        results[name] = {"max_abs_dev": dev, "tol": tol, "pass": passed}
        print(f"{'PASS' if passed else 'FAIL'}  {name:28} max|Δloss| = {dev:.2e} "
              f"(tol {tol:g})")
    return {"world": world, "global_batch": global_batch, "iters": iters,
            "checks": results, "ok": ok}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-root", default="./data",
                   help="directory containing cifar-10-batches-py/ (or its tar.gz); "
                        "synthetic stand-in otherwise")
    p.add_argument("--parts", default=",".join(_PARTS),
                   help="comma-separated subset of " + ",".join(_PARTS))
    p.add_argument("--max-iters", default=40, type=int,
                   help="reference protocol: 40 (iteration 0 untimed)")
    p.add_argument("--batch-size", default=None, type=int,
                   help="override each part's reference batch size")
    p.add_argument("--eval-batches", default=None, type=int,
                   help="cap eval batches (reference: full test set)")
    p.add_argument("--eval-batch-size", default=None, type=int)
    p.add_argument("--model", default=None, help="override the model (reference: vgg11)")
    p.add_argument("--num-nodes", dest="num_nodes", default=4, type=int,
                   help="ranks of the distributed parts, one process each (the "
                        "reference's cluster: 4); ranks share the cards there are")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--json", dest="json_out", default=None,
                   help="also write the rows as JSON to this path")
    p.add_argument("--equivalence", action="store_true",
                   help="machine-check the report's equivalence argument (group25.pdf "
                        "p.5-6) as a loss-trajectory table: part2a==part2b, SUM "
                        "parts==part1 at world x LR, part3 mean==part1; exits non-zero "
                        "on any FAIL")
    return p


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    if args.num_nodes < 1:
        raise ValueError(f"--num-nodes must be >= 1, got {args.num_nodes}")
    if args.equivalence:
        result = run_equivalence(args)
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(result, f, indent=2)
            print(f"\nwrote {args.json_out}")
        if not result["ok"]:
            sys.exit(1)
        return
    rows = run_parity(args)
    print_table(rows)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"\nwrote {args.json_out}")


if __name__ == "__main__":
    main()
