"""Serving request records: per-stage event stamps.

Counterpart of ``stamp_stage`` in
``distributed_machine_learning_tpu/runtime/transport.py``.  The rest of
that module (the gang transports and serving channels) comes with the
serving-fleet slice (ROADMAP A2).

A request payload carries ``events``: a list of ``{"stage", "by", "dt"}``
where ``dt`` is the seconds since the same actor's previous stamp on
this request, on that actor's monotonic clock, or None when the previous
stamp came from another actor.  The clock anchor rides the payload as the
private ``_mono_last``/``_mono_by`` pair.
"""

from __future__ import annotations

import time


def stamp_stage(payload: dict, stage: str, by: str, **extra) -> dict:
    """Append one stage event to ``payload["events"]`` and advance the
    payload's per-actor monotonic anchor; returns the event."""
    now = time.monotonic()
    dt = None
    if payload.get("_mono_by") == by:
        last = payload.get("_mono_last")
        if isinstance(last, (int, float)):
            dt = now - float(last)
    payload["_mono_last"] = now
    payload["_mono_by"] = by
    ev = {"stage": str(stage), "by": str(by), "dt": dt}
    if "dispatch" in payload:
        ev["disp"] = payload["dispatch"]
    ev.update(extra)
    payload.setdefault("events", []).append(ev)
    return ev
