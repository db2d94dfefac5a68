"""Host-side span tracer emitting Chrome trace-event JSON.

A copy of ``distributed_machine_learning_tpu/telemetry/tracer.py``.
The device side has its own trace (``torch.profiler``); what that cannot
show is the *host loop's* phase structure: how long the loop waited on the
data queue, where a serving request sat, where a restart landed in
wall-clock.  This tracer records that complement: cheap host-side spans
in the Chrome trace-event format (`ph:"X"` complete events), loadable in
Perfetto (ui.perfetto.dev) or chrome://tracing.

Crash-safety uses a property of the JSON Array Format: the trailing
``]`` is OPTIONAL for trace viewers, so events are appended as they
complete (``[`` first, then ``,\\n``-separated objects) and a killed
process still leaves a loadable trace.  A clean :meth:`close` terminates
the array, making the file strictly-valid JSON too.

Timestamps are ``perf_counter``-based microseconds (the unit the format
requires), anchored to wall-clock at tracer start so traces appended by
a restarted process stay chronological.  ``pid`` is the process's
rank (``sink._rank``), ``tid`` the host thread id — spans from the prefetch thread land
on their own track.
"""

from __future__ import annotations

import json
import os
import threading
import time

from distributed_machine_learning_tpu_torch.telemetry.sink import _rank

# Stop recording past this many events: a month-long run must not grow an
# unbounded trace (the metrics JSONL is the long-horizon artifact).
DEFAULT_MAX_EVENTS = 200_000


class SpanTracer:
    """Appends Chrome trace events to ``path`` as they complete."""

    def __init__(self, path: str | os.PathLike, flush_every: int = 20,
                 enabled: bool | None = None,
                 max_events: int = DEFAULT_MAX_EVENTS):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.path = os.fspath(path)
        self.flush_every = flush_every
        # None = rank-0 gate, resolved lazily at the first event (see
        # JsonlSink.enabled: construction predates distributed init).
        self._enabled = enabled
        self.max_events = max_events
        self.events_written = 0
        self._file = None
        self._pending = 0
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # Anchor the (monotonic) perf_counter timeline to wall-clock at
        # tracer start: a re-exec'd process appending to the same trace
        # then lands AFTER the dead run's events instead of overlapping
        # them back at ts≈0.
        self._ts0_us = time.time() * 1e6

    @property
    def enabled(self) -> bool:
        if self._enabled is None:
            self._enabled = _rank() == 0
        return self._enabled

    # -- time ------------------------------------------------------------
    def now(self) -> float:
        """Seconds on the tracer's clock (pass to :meth:`complete`)."""
        return time.perf_counter()

    def _us(self, t_s: float) -> float:
        return (t_s - self._t0) * 1e6 + self._ts0_us

    # -- emission --------------------------------------------------------
    def _emit(self, event: dict) -> None:
        if not self.enabled or self.events_written >= self.max_events:
            return
        with self._lock:
            if self._file is None:
                parent = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(parent, exist_ok=True)
                # Append, not truncate: a supervisor re-exec into the
                # same telemetry dir must extend the timeline, not erase
                # the pre-crash attempts.  A prior run's terminator (or
                # a kill's torn final event) is repaired first so the
                # continued file stays one well-formed array.
                _reopen_trace_array(self.path)
                self._file = open(self.path, "a")
                if self._file.tell() == 0:
                    self._file.write("[\n")
                    first = True
                else:
                    first = False
            else:
                first = False
            if not first:
                self._file.write(",\n")
            self._file.write(json.dumps(event))
            self.events_written += 1
            self._pending += 1
            if self._pending >= self.flush_every:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._pending = 0

    def complete(self, name: str, start_s: float, end_s: float,
                 **args) -> None:
        """Record a completed span [start_s, end_s] (tracer-clock
        seconds, i.e. ``perf_counter`` values)."""
        self._emit({
            "name": name,
            "ph": "X",
            "ts": self._us(start_s),
            "dur": max((end_s - start_s) * 1e6, 0.0),
            "pid": _rank(),
            "tid": threading.get_ident() % 2**31,
            **({"args": args} if args else {}),
        })

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (``ph:"i"``) — faults, restarts."""
        self._emit({
            "name": name,
            "ph": "i",
            "s": "p",  # process-scoped: draws a flag line across tracks
            "ts": self._us(time.perf_counter()),
            "pid": _rank(),
            "tid": threading.get_ident() % 2**31,
            **({"args": args} if args else {}),
        })

    def span(self, name: str, **args):
        """``with tracer.span("checkpoint_save", step=3): ...`` — records
        the block as a complete event even when it raises (a failed
        restart attempt is exactly the span you want to see)."""
        return _Span(self, name, args)

    # -- lifecycle -------------------------------------------------------
    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())
                self._pending = 0

    def close(self) -> None:
        """Terminate the JSON array — the file is then valid strict JSON
        (viewers accepted it even before)."""
        with self._lock:
            if self._file is not None:
                self._file.write("\n]\n")
                self._file.flush()
                self._file.close()
                self._file = None


def _reopen_trace_array(path: str) -> None:
    """Prepare an existing trace file for further appends.

    Two prior-run shapes need repair before ``",\\n{event}"`` can extend
    the array: a CLEAN CLOSE left a trailing ``]`` (appending after it
    would put events outside the array — viewers reject that, unlike a
    merely missing terminator), and a KILL may have left a torn final
    event (appending after it would weld two events into garbage).  The
    terminator is stripped; a torn tail is truncated back to the last
    complete event.  A torn event that happens to end in ``}`` (cut
    inside its args) is indistinguishable from a complete one cheaply —
    ``read_trace`` still skips it as an unparseable chunk.
    """
    try:
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return
            back = min(size, 1 << 20)
            f.seek(size - back)
            data = f.read(back)
            end = len(data)

            def rstrip_ws(e: int) -> int:
                while e > 0 and data[e - 1:e] in (b" ", b"\t", b"\r",
                                                  b"\n"):
                    e -= 1
                return e

            end = rstrip_ws(end)
            if end and data[end - 1:end] == b"]":  # clean close: reopen
                end = rstrip_ws(end - 1)
            if end and data[end - 1:end] == b",":  # kill between writes
                end = rstrip_ws(end - 1)
            if end and data[end - 1:end] not in (b"}", b"["):
                # Torn final event: drop back past its separator.
                nl = data.rfind(b"\n", 0, end)
                end = rstrip_ws(nl + 1 if nl >= 0 else 0)
                if end and data[end - 1:end] == b",":
                    end = rstrip_ws(end - 1)
            if end and data[end - 1:end] == b"[":
                end = 0  # nothing but the opener survived: start fresh
            f.truncate(size - len(data) + end)
    except FileNotFoundError:
        return


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_start")

    def __init__(self, tracer: SpanTracer, name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._start = 0.0

    def __enter__(self) -> "_Span":
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        args = dict(self._args)
        if exc_type is not None:
            args["error"] = exc_type.__name__
        self._tracer.complete(self._name, self._start, time.perf_counter(),
                              **args)


def read_trace(path: str | os.PathLike) -> list[dict]:
    """Load a trace written by :class:`SpanTracer` — closed or not (a
    crash leaves the array unterminated, which viewers and this reader
    both accept; a trailing torn line is dropped the same way
    ``sink.read_jsonl`` drops one)."""
    with open(os.fspath(path)) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    body = text.strip()
    if body.startswith("["):
        body = body[1:]
    body = body.rstrip()
    if body.endswith("]"):
        body = body[:-1]
    events = []
    for chunk in body.split(",\n"):
        chunk = chunk.strip().rstrip(",")
        if not chunk:
            continue
        try:
            events.append(json.loads(chunk))
        except json.JSONDecodeError:
            continue  # torn final event from a mid-write kill
    return events
