"""Retrying batch iterator — the data leg of the self-healing runtime.

A copy of ``distributed_machine_learning_tpu/data/retry.py`` (jax-free
there), counting through the port's ``telemetry/``.

A Python iterator that raises is dead: you cannot ``next()`` it again.
So retrying a data path means *recreating* the source from a factory —
and the factory must be **seekable** (``make_iter(start_index)`` yields
the stream from absolute batch ``start_index``), because a
deterministically bad batch would otherwise kill every replay that has
to pass through it.  Every loader in this repo is deterministic and
sliceable (seeded windows, contiguous slicing; SURVEY.md §2.2's sampler
contract), so seeking is a cheap slice, not a re-read.

The wrapper adds exponential backoff between attempts, a bound on total
retries, and skip-bad-batch semantics: a batch that keeps failing after
``max_attempts_per_batch`` tries is skipped (counted, never silent) so
one corrupt record can't wedge a million-step run — the skip/retry
ladder every production data service ends up with.

Used by the part CLIs (``--loader-retries``, ``cli/common.py``) around
their seekable batch factories.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator

from distributed_machine_learning_tpu_torch.utils.logging import rank0_print


def _mirror_retry_counter(kind: str) -> None:
    """Registry counter for a retry event with no FaultEvents attached —
    same naming as the FaultEvents mirror so dashboards see one series."""
    from distributed_machine_learning_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    if tel is not None:
        tel.registry.counter("fault_events", kind=kind).inc()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounds for :func:`retry_batches`.

    ``max_retries`` caps total source recreations across the stream
    (exhaustion re-raises the last error — a persistently dead source
    must surface, not spin).  ``max_attempts_per_batch`` is the
    skip-bad-batch threshold: once one batch index has failed this many
    times it is skipped and the stream continues past it.
    """

    max_retries: int = 3
    max_attempts_per_batch: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 5.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )
        if self.max_attempts_per_batch < 1:
            raise ValueError(
                f"max_attempts_per_batch must be >= 1, got "
                f"{self.max_attempts_per_batch}"
            )
        if self.backoff_s < 0 or self.backoff_mult < 1:
            raise ValueError(
                f"backoff_s must be >= 0 and backoff_mult >= 1, got "
                f"{self.backoff_s}, {self.backoff_mult}"
            )


def retry_batches(
    make_iter: Callable[[int], Iterable],
    policy: RetryPolicy | None = None,
    events=None,
    start: int = 0,
) -> Iterator:
    """Yield batches from ``make_iter(index)``, surviving exceptions.

    ``make_iter(i)`` must return an iterable positioned at absolute
    batch index ``i`` of the underlying stream.  On an exception at
    index ``i`` the source is rebuilt at ``i`` (retry) or ``i + 1``
    (skip, once the index's attempts are spent).  ``events`` (a
    ``runtime/faults.FaultEvents``) counts ``loader_retries`` and
    ``skipped_batches`` so recoveries are observable, never silent.

    KeyboardInterrupt/SystemExit are never swallowed.
    """
    policy = policy or RetryPolicy()
    pos = start           # absolute index of the next batch to deliver
    retries = 0
    attempts: dict[int, int] = {}
    backoff = policy.backoff_s
    while True:
        it = iter(make_iter(pos))
        try:
            for batch in it:
                yield batch
                pos += 1
            return
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:
            attempts[pos] = attempts.get(pos, 0) + 1
            retries += 1
            if events is not None:
                events.loader_retries += 1
            else:
                # No FaultEvents wired (bare BatchLoader(retry=...) use):
                # the registry is then the only observer.  With events,
                # the FaultEvents mirror (runtime/faults.py) already
                # lands the count — counting here too would double it.
                _mirror_retry_counter("loader_retries")
            if retries > policy.max_retries:
                # Exhaustion is checked BEFORE the skip accounting: when
                # a batch crosses its skip threshold on the same failure
                # that spends the last retry, nothing was recovered — a
                # summary reporting a "skipped batch" here would claim a
                # recovery that never happened.
                rank0_print(
                    f"[data-retry] batch {pos} failed and the retry "
                    f"budget is spent ({retries - 1}/{policy.max_retries} "
                    f"used); giving up ({type(exc).__name__}: {exc})"
                )
                raise
            if attempts[pos] >= policy.max_attempts_per_batch:
                if events is not None:
                    events.skipped_batches += 1
                else:
                    _mirror_retry_counter("skipped_batches")
                rank0_print(
                    f"[data-retry] batch {pos} failed {attempts[pos]} "
                    f"time(s) ({type(exc).__name__}: {exc}); skipping it"
                )
                pos += 1
            else:
                rank0_print(
                    f"[data-retry] batch {pos} failed "
                    f"({type(exc).__name__}: {exc}); retrying "
                    f"(attempt {attempts[pos]}/"
                    f"{policy.max_attempts_per_batch})"
                )
            if backoff:
                time.sleep(backoff)
                backoff = min(backoff * policy.backoff_mult,
                              policy.max_backoff_s)
