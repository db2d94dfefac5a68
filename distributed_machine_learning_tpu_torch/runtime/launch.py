"""Start the ranks of a multi-process run from one parent and collect what
each reports.

``spawn(target, world, args)`` starts ``world`` fresh interpreters (the
``spawn`` start method: no state is inherited, so each rank initializes
CUDA and its process group itself), calls ``target(rank, world,
init_method, *args)`` in each, and returns the ranks' return values in
rank order.  ``init_method`` is a ``file://`` rendezvous in a fresh
temporary directory, so concurrent runs never share a port.  A rank that
raises, dies or outlives ``timeout_s`` fails the whole run: the parent
kills every rank still alive and raises with the ranks' tracebacks.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import tempfile
import time
import traceback
from pathlib import Path


def _child(rank: int, world: int, init_method: str, target, args, results) -> None:
    try:
        out = target(rank, world, init_method, *args)
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(target, world: int, args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``target(rank, world, init_method, *args)`` in ``world`` processes;
    returns their results in rank order, or raises if any rank fails."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="dml_pg_") as tmp:
        init_method = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world, init_method, target, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        got: dict = {}
        failures = []
        try:
            while len(got) < world:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    failures.append(f"timed out after {timeout_s:.0f} s; ranks "
                                    f"{sorted(set(range(world)) - set(got))} never reported")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if not p.is_alive() and r not in got]
                    if dead:  # exited without reporting (killed, or died in C)
                        time.sleep(0.5)  # a report may still be in flight
                        if results.empty():
                            failures.append(f"ranks {dead} exited without reporting "
                                            f"(exit codes {[procs[r].exitcode for r in dead]})")
                            break
                    continue
                got[rank] = out
                if not ok:
                    failures.append(f"rank {rank} failed:\n{out}")
                    break
            for p in procs:
                p.join(timeout=30 if not failures else 5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if failures:
            raise RuntimeError("multi-process run failed: " + "\n".join(failures))
        return [got[r] for r in range(world)]
