"""Streaming telemetry subsystem — registry, crash-safe sinks, spans.

A copy of ``distributed_machine_learning_tpu/telemetry/__init__.py``
(its MFU takes the port's H100 peak, ``utils/flops``).  Three pieces,
one facade:

- :class:`~.registry.MetricsRegistry` — process-wide named
  counters/gauges/histograms (``telemetry/registry.py``);
- :class:`~.sink.JsonlSink` — append-mode, fsynced, rank-0-gated JSONL
  (``telemetry/sink.py``), plus a Prometheus-textfile export of the
  final registry state;
- :class:`~.tracer.SpanTracer` — host-side Chrome trace-event spans
  (``telemetry/tracer.py``), the host-loop complement to the
  ``torch.profiler`` device trace.

:class:`Telemetry` bundles them over one output directory::

    telemetry_dir/
      metrics.jsonl   per-step rows, attempt-tagged, appended live
      trace.json      Chrome trace (open in ui.perfetto.dev)
      registry.json   final registry snapshot (counters, quantiles)
      metrics.prom    Prometheus textfile export of the final values

Everything is OFF by default: ``get_telemetry()`` returns ``None``
unless a CLI installed an instance (``--telemetry-dir``), and every
integration point guards with ``if tel is not None`` — the hot loop
pays one pointer test per step when telemetry is off, no allocations,
no syscalls.  The module-level install (:func:`set_telemetry`) is what
makes deep layers (loaders, checkpointing, fault counters) observable
without threading a handle through every signature.

Attempt tagging: the supervisor (``runtime/supervisor.py``) calls
:meth:`Telemetry.set_attempt` before each attempt, so every metrics row
carries the attempt that produced it, and a fresh process resuming into
the same directory continues from the attempt after the last one on
disk — restarts APPEND history, never truncate it.
"""

from __future__ import annotations

import json
import os
import time

from distributed_machine_learning_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_buckets,
)
from distributed_machine_learning_tpu_torch.telemetry.sink import (
    JsonlSink,
    read_jsonl,
    write_prometheus,
)
from distributed_machine_learning_tpu_torch.telemetry.tracer import (
    SpanTracer,
    read_trace,
)
from distributed_machine_learning_tpu_torch.telemetry.aggregator import (
    GangRollup,
    HeartbeatSampler,
    StragglerDetector,
    StragglerVerdict,
    aggregate_gang_metrics,
    discover_rank_streams,
    publish_rollup,
    serving_stage_samples,
)
from distributed_machine_learning_tpu_torch.telemetry.slo import (
    SLOEngine,
    SLOSpec,
    format_verdict,
    parse_slo,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_latency_buckets",
    "JsonlSink", "read_jsonl", "write_prometheus",
    "SpanTracer", "read_trace",
    "GangRollup", "HeartbeatSampler", "StragglerDetector",
    "StragglerVerdict", "aggregate_gang_metrics",
    "discover_rank_streams", "publish_rollup",
    "serving_stage_samples",
    "SLOEngine", "SLOSpec", "format_verdict", "parse_slo",
    "Telemetry", "telemetry_from_flags",
    "get_telemetry", "set_telemetry", "instance_file",
]

METRICS_FILE = "metrics.jsonl"
TRACE_FILE = "trace.json"
REGISTRY_FILE = "registry.json"
PROM_FILE = "metrics.prom"


def instance_file(name: str, instance: str | None) -> str:
    """``metrics.jsonl`` + instance ``rank2`` -> ``metrics.rank2.jsonl``.

    The collision-safety contract: two processes pointed at the SAME
    telemetry directory must never append to the same stream (append
    interleaving welds their rows into garbage neither reader
    tolerates), so each gets an instance tag spliced in front of the
    extension.  ``None`` keeps the canonical single-process names."""
    if not instance:
        return name
    if "/" in instance or os.sep in instance:
        raise ValueError(f"instance must be a bare tag, got {instance!r}")
    stem, dot, ext = name.rpartition(".")
    return f"{stem}.{instance}{dot}{ext}" if dot else f"{name}.{instance}"


def _last_attempt_on_disk(path: str) -> int | None:
    """The ``attempt`` tag of the last parseable row in a metrics
    stream, or None for no/empty stream.

    Attempts only ever increase along the stream (rows are appended in
    attempt order), so the last row carries the max — a bounded TAIL
    read, not a full parse: the metrics JSONL is the long-horizon
    artifact, and a supervisor re-exec must not re-parse a multi-GB
    history before training can start.  Tolerates the torn final row a
    kill leaves (scans back to the last parseable line).
    """
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return None
            back = min(size, 1 << 20)
            f.seek(size - back)
            tail = f.read(back)
    except OSError:
        return None
    for line in reversed(tail.splitlines()):
        if not line.strip():
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            continue  # torn final row, or the truncated first tail line
        if isinstance(row, dict) and isinstance(row.get("attempt"), int):
            return row["attempt"]
    return None


def _rehydrate_counters(registry_path: str, registry: MetricsRegistry
                        ) -> None:
    """Seed ``registry`` with the counter totals a prior process left in
    its ``registry.json`` (corrupt/absent snapshots are ignored — the
    stream artifacts still hold the full history)."""
    try:
        with open(registry_path) as f:
            snap = json.load(f)
    except (OSError, json.JSONDecodeError):
        return
    for entry in snap.get("counters", []):
        try:
            registry.counter(entry["name"], **entry.get("labels", {})).inc(
                entry["value"]
            )
        except (KeyError, TypeError, ValueError):
            continue


class Telemetry:
    """One run's telemetry: registry + metrics sink + span tracer over a
    single output directory.

    ``attempt`` starts after the last attempt already on disk (a
    supervisor re-exec into the same directory appends as attempt N+1);
    in-process restarts advance it via :meth:`set_attempt`.

    ``instance``: a per-process tag (e.g. ``rank2``) spliced into every
    artifact filename (``metrics.rank2.jsonl``, ``trace.rank2.json``,
    ...) so N processes can share one telemetry directory without their
    appends ever interleaving — the gang layout
    ``telemetry/aggregator.py`` reads back as one cross-rank plane.
    """

    def __init__(self, out_dir: str | os.PathLike, flush_every: int = 20,
                 enabled: bool | None = None, fsync: bool = True,
                 instance: str | None = None):
        self.out_dir = os.fspath(out_dir)
        self.instance = instance or None
        self.registry = MetricsRegistry()
        metrics_path = os.path.join(
            self.out_dir, instance_file(METRICS_FILE, self.instance)
        )
        prior = _last_attempt_on_disk(metrics_path)
        self.attempt = 0 if prior is None else prior + 1
        if prior is not None:
            # Resuming into a prior run's directory: carry its COUNTER
            # totals forward so the exported registry keeps whole-run
            # semantics (fault_events across every attempt), matching
            # the append-not-truncate contract of the other artifacts.
            # Gauges are instantaneous and histogram snapshots hold only
            # quantiles (not bucket counts), so those restart.
            _rehydrate_counters(self._artifact(REGISTRY_FILE),
                                self.registry)
        self.metrics = JsonlSink(metrics_path, flush_every=flush_every,
                                 fsync=fsync, enabled=enabled)
        self.tracer = SpanTracer(self._artifact(TRACE_FILE),
                                 flush_every=flush_every, enabled=enabled)
        # Optional cost model for MFU: the CLI sets whichever it knows.
        self.flops_per_example: float | None = None
        self.flops_per_token: float | None = None
        self.peak_tflops: float | None = None
        # Static per-step counter increments the train loop applies on
        # every completed step (e.g. ``ring_wire_bytes``: the compressed
        # ring's bytes-on-the-wire are a compile-time constant of the
        # program, so the CLI computes the increment once and the loop
        # just accumulates it).  Empty by default: one dict iteration
        # per step when telemetry is on, nothing when off.
        self.step_counters: dict[str, float] = {}
        self._closed = False

    def _artifact(self, name: str) -> str:
        return os.path.join(self.out_dir,
                            instance_file(name, self.instance))

    # -- per-step surface ------------------------------------------------
    def log_step(self, step: int, **metrics) -> None:
        """One attempt-tagged metrics row, streamed (not buffered to
        end-of-run — the crash-loss fix this subsystem exists for).
        The registry snapshot is re-exported once per sink flush window,
        so a hard kill loses at most one window of counter updates, the
        same durability bound the rows get."""
        self.metrics.write({
            "step": step, "time": time.time(), "attempt": self.attempt,
            **metrics,
        })
        if self.metrics.rows_written % self.metrics.flush_every == 0:
            self._export_registry()

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def set_attempt(self, attempt: int) -> None:
        """Tag subsequent rows/spans with this restart attempt (called by
        ``runtime/supervisor.py::run_attempts``).  Never moves backwards:
        a fresh process that already resumed past attempt 0 keeps its
        offset when the in-process supervisor starts counting from 0."""
        attempt = max(attempt, self.attempt)
        if attempt != self.attempt:
            self.attempt = attempt
            self.flush()  # the prior attempt's rows are now history

    def mfu_of(self, examples_per_s: float, tokens_per_s: float | None
               ) -> float | None:
        """MFU from whichever cost model the CLI installed, or None."""
        from distributed_machine_learning_tpu_torch.utils.flops import (
            DEFAULT_PEAK_TFLOPS,
            mfu,
        )

        peak = self.peak_tflops or DEFAULT_PEAK_TFLOPS
        if self.flops_per_token is not None and tokens_per_s is not None:
            return mfu(tokens_per_s * self.flops_per_token, peak)
        if self.flops_per_example is not None:
            return mfu(examples_per_s * self.flops_per_example, peak)
        return None

    # -- lifecycle -------------------------------------------------------
    def flush(self) -> None:
        self.metrics.flush()
        self.tracer.flush()
        self._export_registry()

    def _export_registry(self) -> None:
        if not self.metrics.enabled:
            return
        os.makedirs(self.out_dir, exist_ok=True)
        snap_path = self._artifact(REGISTRY_FILE)
        tmp = snap_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.registry.snapshot(), f, indent=1)
        os.replace(tmp, snap_path)
        write_prometheus(self._artifact(PROM_FILE), self.registry)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.metrics.close()
        self.tracer.close()
        self._export_registry()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- process-wide install -------------------------------------------------
_active: Telemetry | None = None


def get_telemetry() -> Telemetry | None:
    """The installed telemetry, or None (the default: everything off)."""
    return _active


def set_telemetry(tel: Telemetry | None) -> Telemetry | None:
    """Install ``tel`` process-wide (None uninstalls); returns the
    previous instance so scoped users can restore it."""
    global _active
    prev = _active
    _active = tel
    return prev


def telemetry_from_flags(args) -> Telemetry | None:
    """Telemetry from the shared CLI flags (``--telemetry-dir``,
    ``--telemetry-flush-every``), or None when the flag is unset — the
    single construction point both CLIs share."""
    out_dir = getattr(args, "telemetry_dir", None)
    if not out_dir:
        return None
    return Telemetry(out_dir,
                     flush_every=getattr(args, "telemetry_flush_every", 20))
