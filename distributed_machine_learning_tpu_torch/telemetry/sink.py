"""Crash-safe streaming sinks — telemetry that survives the failures the
runtime recovers from.

A copy of ``distributed_machine_learning_tpu/telemetry/sink.py``; only
:func:`_rank` differs (the ``torch.distributed`` rank, not JAX's process
index).

- **append-mode** JSONL, so a supervisor restart (same path, next
  attempt) appends to the survivor rows instead of truncating them;
- **flush + fsync every N rows**, so at most the last flush window is
  lost to a hard kill;
- **rank-0 gated**, the same multi-host discipline as every print in
  ``utils/logging.py``;
- a tolerant reader (:func:`read_jsonl`) that drops a torn final line —
  a process killed mid-``write(2)`` leaves exactly one partial row, and
  analysis must not die on the artifact of the crash it is analyzing.
"""

from __future__ import annotations

import json
import os
import threading


def _rank() -> int:
    """This process's rank: the ``torch.distributed`` rank once a process
    group is up, else the ``RANK`` environment variable, else 0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


class JsonlSink:
    """Append-mode JSONL writer, flushed (+fsynced) every ``flush_every``
    rows.  ``enabled=None`` gates on process 0 (the rank-0 contract);
    pass an explicit bool to override (tests, per-rank diagnostics)."""

    def __init__(self, path: str | os.PathLike, flush_every: int = 20,
                 fsync: bool = True, enabled: bool | None = None,
                 append: bool = True):
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        self.path = os.fspath(path)
        self.flush_every = flush_every
        self.fsync = fsync
        # append=False truncates at first open: for callers whose run is
        # NOT a continuation (a fresh --metrics-file run with no
        # --resume), where appending would silently mix unrelated runs.
        self.append = append
        # None = rank-0 gate, resolved LAZILY at the first write: sinks
        # are constructed before init_process_group on multi-process
        # runs, where an eager process_index() would read 0 on every host
        # and every rank would write.
        self._enabled = enabled
        self._file = None
        self._pending = 0
        self.rows_written = 0
        # Writes/flushes can race (the fault mirror flushes from the
        # watchdog thread while the loop writes rows).
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        if self._enabled is None:
            self._enabled = _rank() == 0
        return self._enabled

    def _open(self):
        if self._file is None:
            parent = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(parent, exist_ok=True)
            if self.append:
                _truncate_torn_final_line(self.path)
                self._file = open(self.path, "a")
            else:
                self._file = open(self.path, "w")
        return self._file

    def touch(self) -> None:
        """Ensure the file exists (a reported path must exist even when
        zero rows were written — the MetricsLogger contract)."""
        if self.enabled:
            with self._lock:
                self._open()

    def write(self, row: dict) -> None:
        if not self.enabled:
            return
        line = json.dumps(row) + "\n"
        with self._lock:
            f = self._open()
            f.write(line)
            self.rows_written += 1
            self._pending += 1
            if self._pending >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._file is None:
            return
        self._file.flush()
        if self.fsync:
            os.fsync(self._file.fileno())
        self._pending = 0

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._flush_locked()
                self._file.close()
                self._file = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _truncate_torn_final_line(path: str) -> None:
    """Drop a partial (newline-less) final line before appending.

    A kill mid-``write(2)`` leaves one torn row at the tail.  Appending
    straight after it would weld the new attempt's first row onto the
    torn bytes — corrupting BOTH and moving the damage mid-file, where
    :func:`read_jsonl` rightly refuses to tolerate it.  Truncating back
    to the last newline sacrifices only the row the crash already
    destroyed.
    """
    try:
        with open(path, "rb+") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size == 0:
                return
            back = min(size, 1 << 20)
            f.seek(size - back)
            tail = f.read(back)
            if tail.endswith(b"\n"):
                return
            nl = tail.rfind(b"\n")
            f.truncate(size - back + nl + 1 if nl >= 0 else 0)
    except FileNotFoundError:
        return


def read_jsonl(path: str | os.PathLike, tolerate_truncation: bool = True
               ) -> list[dict]:
    """Parse a JSONL file back to rows.

    With ``tolerate_truncation`` (the default), an unparseable FINAL line
    is dropped — that is the signature of a kill mid-write, and the rows
    before it are exactly the crash-safe payload.  An unparseable line
    anywhere else is real corruption and raises.
    """
    rows = []
    with open(os.fspath(path)) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            if tolerate_truncation and i == len(lines) - 1:
                break
            raise
    return rows


def write_prometheus(path: str | os.PathLike, registry) -> None:
    """Atomic-rename write of ``registry.to_prometheus()`` — the
    node-exporter textfile-collector contract (a scraper must never see
    a half-written file)."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(registry.to_prometheus())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
