"""Restart supervision: the retry primitive behind ``--resume auto``.

Counterpart of ``run_attempts`` in
``distributed_machine_learning_tpu/runtime/supervisor.py``.  The rest of
that module (``supervised_train`` with its data cursor and stall
watchdog, ``gang_supervise`` relaunching a gang of worker processes) is
not ported yet: ROADMAP A6.
"""

from __future__ import annotations

import contextlib
from typing import Callable

from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
from distributed_machine_learning_tpu_torch.utils.logging import rank0_print


def run_attempts(attempt: Callable[[int], object], *, max_restarts: int = 3,
                 events: FaultEvents | None = None):
    """Run ``attempt(restart_index)`` until it returns, restarting on any
    Exception up to ``max_restarts`` times.  ``attempt`` owns its restore
    from the latest checkpoint; this owns the policy: count, log, give up
    loudly.  KeyboardInterrupt and SystemExit always propagate.  With
    telemetry installed, each attempt is one ``restart_attempt`` span and
    its rows carry the attempt tag."""
    from distributed_machine_learning_tpu_torch.telemetry import get_telemetry

    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    restarts = 0
    while True:
        tel = get_telemetry()
        if tel is not None:
            tel.set_attempt(tel.attempt if restarts == 0 else tel.attempt + 1)
        try:
            with (tel.span("restart_attempt", attempt=tel.attempt)
                  if tel is not None else contextlib.nullcontext()):
                return attempt(restarts)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as exc:
            if restarts >= max_restarts:
                rank0_print(f"[supervisor] giving up after {restarts} restart(s): "
                            f"{type(exc).__name__}: {exc}")
                raise
            restarts += 1
            if events is not None:
                events.restarts += 1
            rank0_print(f"[supervisor] attempt failed ({type(exc).__name__}: {exc}); "
                        f"restart {restarts}/{max_restarts} from the latest complete "
                        "checkpoint")
