"""Checkpoint and resume: the port's own tensor files under the reference's
on-disk contract.

Counterpart of ``distributed_machine_learning_tpu/train/checkpoint.py``,
which saves through orbax (and so through JAX).  The port writes its own
files, under the same contract, so the stdlib-only ``tools/ckpt_verify.py``
and the reference's file-level checks (``validate_checkpoint``,
``latest_checkpoint``, ``checkpoint_chain_report``) read both packages'
checkpoints alike:

- ``<dir>/step_<n>/`` per saved step;
- ``state/``: one raw little-endian file per leaf (``<leaf name>.bin``; a
  bf16 leaf is its 2-byte words, dtype ``"bfloat16"``) and ``index.json``
  (leaf name → dtype, shape, file).  It is written as ``state.tmp/`` and
  renamed into place, so a crashed save never leaves a final-named
  ``state/`` (the meaning orbax's rename gives it in the reference);
- ``manifest.json``: sha256 and size of every file under ``state/``, and
  sha256/crc32/bytes/dtype/shape of every leaf, written between the state
  and the config;
- ``sgd_config.json``, written last, the completeness marker: the
  optimizer config's dataclass fields under ``__class__``, and
  ``__layout__``, ``__cursor__``, ``__shard_spec__``, ``__extra__``;
- ``.invalid``: the quarantine marker of a checkpoint known to be bad.

Leaf names are the port's: ``params/<state_dict name>``, the momentum
tree (``momentum/mu/<name>``, ``momentum/nu/<name>``; SGD
``momentum/<name>``), ``batch_stats/<name>`` and ``step``.  A checkpoint
the JAX package wrote (orbax files, no index) is refused at restore, never
guessed at.

Each leaf's bytes are hashed once, as they are written: the file holds
exactly the leaf's bytes, so its sha256 is the leaf's.  A restore reads
each file once into the host buffer the tensor is made from and checks
that buffer against both halves of the manifest.  Files are written, read
and hashed by a pool of threads (hashlib, zlib and file I/O release the
interpreter lock on large buffers).

Only rank 0 of a ``torch.distributed`` group writes (the dp state is
replicated); the other ranks wait at a barrier.  The flat-shard states
(``parallel/zero1.py``'s ``Zero1State``, ``parallel/fsdp.py``'s
``FSDPState``) are saved under a ``ShardSpec`` as the reference saves them:
the global padded flat vectors (``param_flat`` or ``param_shards``,
``momentum_shards[/mu|/nu]``), each gathered whole over the caller's
``comm`` in turn (each port rank holds only its block, where a JAX array
is global) and moved to the host by rank 0 before the next, with
``batch_stats/<name>`` and ``step``.  Their leaf digests cover the logical
prefix (``logical_elems``: the first ``n_elems`` values, the part a reshard
keeps), the file digests the bytes as written.  ``reshard_restore`` lays
them out for another world.  The port's flat order is its own
(``named_parameters()``, each tensor row-major), so its digests are its
own.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec, padded_len, repad_flat

_CONFIG_FILE = "sgd_config.json"
_STATE_DIR = "state"
_STATE_TMP = "state.tmp"
_MANIFEST_FILE = "manifest.json"
_INVALID_MARKER = ".invalid"
_INDEX_FILE = "index.json"
_INDEX_FORMAT = "distributed_machine_learning_tpu_torch/tensors-v1"
_LEAF_SUFFIX = ".bin"
_IO_THREADS = min(8, os.cpu_count() or 1)
# Leaf names (prefixes) of the flat world-padded vectors of the zero1/fsdp
# layouts: their manifest digests cover the logical prefix.
_FLAT_LEAF_PREFIXES = ("param_flat", "param_shards", "momentum_shards")

# Absolute paths of checkpoints this process has hashed clean during GC:
# complete checkpoints are immutable, so GC (on the training thread after
# every save) trusts one full hash per path.  Re-saves, quarantine verdicts
# and anything that flips bytes drop the entry (forget_validated).
_GC_VALIDATED: set[str] = set()

# torch dtype name ↔ the numpy dtype a leaf's bytes are read as (bf16 has
# no numpy dtype: its 2-byte words travel as int16).
_NP_DTYPES = {
    "float64": np.float64, "float32": np.float32, "float16": np.float16,
    "bfloat16": np.int16, "int64": np.int64, "int32": np.int32, "int16": np.int16,
    "int8": np.int8, "uint8": np.uint8, "bool": np.bool_,
}


def forget_validated(path: str | os.PathLike) -> None:
    """Drop ``path`` from the in-process GC validation memo: anything that
    changes a committed checkpoint's bytes calls this."""
    _GC_VALIDATED.discard(os.path.abspath(os.fspath(path)))


class CheckpointVerifyError(RuntimeError):
    """A checkpoint failed content verification (a file missing from the
    manifest, a size or digest mismatch, a quarantine marker), or cannot be
    read by the port at all.  Raised instead of restoring garbage."""


class NoRestorableCheckpointError(CheckpointVerifyError):
    """Every candidate of the fallback chain is unusable; the message lists
    each candidate with its verdict."""


@dataclasses.dataclass
class HostState:
    """A checkpoint's training state as CPU tensors: what
    :func:`restore_checkpoint` gives without a template.  ``params`` and
    ``batch_stats`` by name, ``momentum`` the optimizer's tree."""

    params: dict
    momentum: dict
    batch_stats: dict
    step: int
    config: object


def _bump(name: str, events=None) -> None:
    """Count one ``ckpt_verify_failures``/``ckpt_fallbacks``/
    ``reshard_restores`` in the telemetry registry and, when given, on
    ``events`` (a ``FaultEvents``)."""
    from distributed_machine_learning_tpu_torch.telemetry import get_telemetry

    tel = get_telemetry()
    if tel is not None:
        tel.registry.counter(name).inc()
    if events is not None and hasattr(events, name):
        setattr(events, name, getattr(events, name) + 1)


def _is_writer() -> bool:
    """Rank 0 of the process group writes checkpoints (every process when
    no group is up)."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# -- leaves ------------------------------------------------------------------
def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for key, value in tree.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            _flatten(value, name, out)
        else:
            out[name] = value


def _nest(flat: dict) -> dict:
    """``{"a/b/c": x}`` → ``{"a": {"b": {"c": x}}}`` (the first component
    is the group; state_dict names keep their dots)."""
    out: dict = {}
    for name, value in flat.items():
        parts = name.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def state_layout(state) -> str:
    """The ``SHARD_LAYOUTS`` name of a state: ``fsdp`` (an ``FSDPState``),
    ``zero1`` (a ``Zero1State``) or ``dp``."""
    if hasattr(state, "param_shard"):
        return "fsdp"
    if hasattr(state, "param_flat"):
        return "zero1"
    return "dp"


def _flat_lens(state, comm) -> list[int]:
    """The global padded length each of a flat state's vectors stands for:
    the replicated vector's own (zero1), ``comm``'s W blocks of the rank's
    for the sharded ones (without a comm the state holds whole vectors)."""
    world = comm.world if comm is not None else 1
    mom = state.momentum_shards
    lens = [t.numel() * world for t in (mom.values() if isinstance(mom, dict) else [mom])]
    if state_layout(state) == "fsdp":
        return [state.param_shard.numel() * world, *lens]
    if state.param_flat is None:
        raise ValueError("the overlap step's gather of this Zero1State is in flight: "
                         "call step.join(state) before saving it")
    return [state.param_flat.numel(), *lens]


def _leaf_items(state, comm=None):
    """The state's tensors as (leaf name, tensor), one at a time (the config
    is metadata).  A flat state's sharded vectors are gathered whole over
    ``comm``, each when it is reached (every rank of ``comm`` must walk them
    all); without a comm the state holds the whole vectors."""
    layout = state_layout(state)
    if layout == "dp":
        leaves = {f"params/{k}": p.detach() for k, p in state.params.items()}
        _flatten(state.momentum, "momentum", leaves)
        yield from leaves.items()
    else:
        def whole(t):
            return comm.all_gather_flat(t) if comm is not None else t.detach()

        yield (("param_shards", whole(state.param_shard)) if layout == "fsdp"
               else ("param_flat", state.param_flat.detach()))
        mom = state.momentum_shards
        moms = ({f"momentum_shards/{k}": v for k, v in mom.items()} if isinstance(mom, dict)
                else {"momentum_shards": mom})
        for name, t in moms.items():
            yield name, whole(t)
    for k, b in state.batch_stats.items():
        yield f"batch_stats/{k}", b.detach()
    yield "step", torch.tensor(int(state.step), dtype=torch.int32)


def _state_leaves(state, comm=None) -> dict:
    """The state's tensors by leaf name (:func:`_leaf_items`)."""
    return dict(_leaf_items(state, comm))


def _check_shard_spec(state, shard_spec: ShardSpec | None, comm=None) -> None:
    """A flat-shard state saved without (or with a mismatched) spec could
    not be resharded or verified, and one whose overlap gather is in flight
    over ``comm`` cannot be gathered: refused at the save, the spec errors
    in the reference's words."""
    layout = state_layout(state)
    if layout != "dp" and comm is not None and comm.gather_in_flight:
        raise ValueError(f"the overlap step's gather of this {layout} state is in flight: "
                         "call step.join(state) before saving it")
    if shard_spec is None:
        if layout != "dp":
            raise ValueError(f"saving a {layout} state requires a shard_spec (world size + "
                             "unpadded flat length); without it the padded vectors cannot "
                             "be resharded or verified")
        return
    if shard_spec.layout != layout:
        raise ValueError(f"shard_spec.layout={shard_spec.layout!r} does not match "
                         f"the state's layout {layout!r}")
    if layout == "dp":
        return
    expect = padded_len(shard_spec.n_elems, shard_spec.world)
    got = next((n for n in _flat_lens(state, comm) if n != expect), expect)
    if got != expect:
        raise ValueError(f"shard_spec {shard_spec} expects a flat vector of {expect} "
                         f"elements (padded_len({shard_spec.n_elems}, {shard_spec.world})), "
                         f"but the state's is ({got},) — wrong world or n_elems would "
                         "silently drop parameter data on reshard")


def _logical_elems(name: str, shape, spec: ShardSpec | None) -> int | None:
    """The unpadded length of a flat padded leaf under ``spec``, or None for
    a leaf without world-dependent padding (every dp leaf, the flat
    layouts' statistics and step)."""
    if spec is None or spec.layout == "dp" or spec.n_elems is None or len(shape) != 1:
        return None
    if not any(name == p or name.startswith(p + "/") for p in _FLAT_LEAF_PREFIXES):
        return None
    if shape[0] != padded_len(spec.n_elems, spec.world):
        return None
    return spec.n_elems


def _host_leaf(t, copy: bool) -> tuple[str, tuple, np.ndarray]:
    """(dtype name, shape, contiguous numpy array of the raw values) of one
    tensor, on the host.  ``copy`` forces a private copy of a CPU tensor
    (a device tensor is copied by the transfer anyway)."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(np.asarray(t))
    dtype = str(t.dtype).removeprefix("torch.")
    if dtype not in _NP_DTYPES:
        raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
    t = t.detach()
    if dtype == "bfloat16":
        t = t.view(torch.int16)
    on_host = t.device.type == "cpu"
    t = t.to("cpu").contiguous()
    if copy and on_host:
        t = t.clone()
    return dtype, tuple(t.shape), t.numpy()


class _Host(dict):
    """A host snapshot, name → (dtype, shape, array), with the ShardSpec it
    is saved under (its flat leaves' digests cover the logical prefix)."""

    spec: ShardSpec | None = None


def _snapshot(leaves: dict, copy: bool, spec: ShardSpec | None = None) -> _Host:
    """Every leaf on the host: name → (dtype, shape, array)."""
    host = _Host((name, _host_leaf(t, copy)) for name, t in leaves.items())
    host.spec = spec
    return host


def _save_snapshot(state, comm, copy: bool, spec: ShardSpec | None) -> _Host | None:
    """The writer's host snapshot of ``state``, None on the other ranks.  A
    flat state's vectors are gathered whole one at a time, every rank taking
    part: the writer moves each to the host before the next gather, the
    others drop it at once."""
    writer = _is_writer()
    if not writer and state_layout(state) == "dp":
        return None
    host = _Host()
    for name, t in _leaf_items(state, comm):
        if writer:
            host[name] = _host_leaf(t, copy)
    host.spec = spec
    return host if writer else None


def _digest(raw) -> tuple[str, int, int]:
    """(sha256 hex, crc32, byte count) of a buffer."""
    mv = memoryview(raw).cast("B")
    return hashlib.sha256(mv).hexdigest(), zlib.crc32(mv) & 0xFFFFFFFF, mv.nbytes


def _digests(raw, logical_bytes: int | None) -> tuple[tuple, tuple]:
    """One pass over a buffer: ((sha256, crc32, bytes) of the leaf — its
    first ``logical_bytes`` when given, else all of it —, (sha256, bytes) of
    the whole buffer, the file)."""
    mv = memoryview(raw).cast("B")
    if logical_bytes is None:
        leaf = _digest(mv)
        return leaf, (leaf[0], leaf[2])
    head = mv[:logical_bytes]
    h = hashlib.sha256(head)
    leaf = (h.hexdigest(), zlib.crc32(head) & 0xFFFFFFFF, head.nbytes)
    h.update(mv[logical_bytes:])
    return leaf, (h.hexdigest(), mv.nbytes)


def _leaf_entry(dtype: str, shape, sha: str, crc: int, nbytes: int,
                logical: int | None = None) -> dict:
    entry = {"sha256": sha, "crc32": crc, "bytes": nbytes, "dtype": dtype,
             "shape": list(shape)}
    if logical is not None:
        entry["logical_elems"] = logical
    return entry


def _logical_bytes(arr: np.ndarray, logical: int | None) -> int | None:
    return None if logical is None else logical * arr.itemsize


def _leaf_entries(host: _Host) -> dict:
    """Per-leaf digests of a host snapshot (the manifest's ``leaves``)."""
    logical = {name: _logical_elems(name, shape, host.spec)
               for name, (_, shape, _) in host.items()}

    def one(item):
        name, (dtype, shape, arr) = item
        leaf, _ = _digests(arr, _logical_bytes(arr, logical[name]))
        return _leaf_entry(dtype, shape, *leaf, logical[name])

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        return dict(zip(host, pool.map(one, list(host.items()))))


def _leaf_file(name: str) -> str:
    return name + _LEAF_SUFFIX


# -- manifest ----------------------------------------------------------------
def _file_digest(path: str) -> tuple[str, int]:
    """(sha256 hexdigest, byte size) of a file, streamed."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            n += len(chunk)
            h.update(chunk)
    return h.hexdigest(), n


def _state_files(path: str) -> list[str]:
    """Every file under ``path/state``, relative to ``path``: the on-disk
    surface the manifest covers."""
    state_dir = os.path.join(path, _STATE_DIR)
    out = []
    for root, _, files in os.walk(state_dir):
        for name in files:
            out.append(os.path.relpath(os.path.join(root, name), path))
    return sorted(out)


def _dump_manifest(path: str, files: dict, leaves: dict,
                   shard_spec: ShardSpec | None) -> dict:
    manifest = {"version": 1, "files": dict(sorted(files.items())), "leaves": leaves}
    if shard_spec is not None:
        manifest["shard_spec"] = shard_spec.as_dict()
    tmp = os.path.join(path, _MANIFEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, _MANIFEST_FILE))
    return manifest


def write_checkpoint_manifest(path: str | os.PathLike, tree=None,
                              leaf_entries: dict | None = None,
                              shard_spec: ShardSpec | None = None) -> dict:
    """Hash every file under ``path/state`` (and, given ``tree`` — a state —
    or precomputed ``leaf_entries``, every leaf) into ``path/manifest.json``
    (atomic replace).  Returns the manifest."""
    path = os.path.abspath(os.fspath(path))
    rels = _state_files(path)
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        digests = list(pool.map(lambda r: _file_digest(os.path.join(path, r)), rels))
    files = {rel: {"sha256": sha, "bytes": n} for rel, (sha, n) in zip(rels, digests)}
    if leaf_entries is None:
        leaf_entries = (_leaf_entries(_snapshot(_state_leaves(tree), False, shard_spec))
                        if tree is not None else {})
    return _dump_manifest(path, files, leaf_entries, shard_spec)


def checkpoint_manifest(path: str | os.PathLike) -> dict | None:
    """The manifest a checkpoint was saved with, or None (legacy)."""
    try:
        with open(os.path.join(os.fspath(path), _MANIFEST_FILE)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


# -- quarantine ----------------------------------------------------------------
def quarantine_reason(path: str | os.PathLike) -> str | None:
    """Why a checkpoint was quarantined (its ``.invalid`` marker), or None."""
    try:
        with open(os.path.join(os.fspath(path), _INVALID_MARKER)) as f:
            payload = json.load(f)
        return str(payload.get("reason", "unknown"))
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError):
        return "unreadable quarantine marker"


def quarantine_checkpoint(path: str | os.PathLike, reason: str) -> None:
    """Mark a checkpoint known-bad (``.invalid`` with the reason): the
    fallback chain and every reader skip it without reading its data.
    Idempotent; atomic replace."""
    path = os.fspath(path)
    forget_validated(path)
    tmp = os.path.join(path, _INVALID_MARKER + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"reason": reason, "time": time.time()}, f)
    os.replace(tmp, os.path.join(path, _INVALID_MARKER))


def _verify_manifest_files(path: str, manifest: dict) -> list[str]:
    """Problems of the on-disk files against ``manifest`` (empty: every
    file present, sized and digest-identical)."""
    def check(item):
        rel, entry = item
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            return f"missing file {rel}"
        size = os.path.getsize(fp)
        if size != entry["bytes"]:
            return f"size mismatch {rel}: {size} != {entry['bytes']}"
        if _file_digest(fp)[0] != entry["sha256"]:
            return f"digest mismatch {rel}"
        return None

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        found = pool.map(check, list(manifest.get("files", {}).items()))
        return [p for p in found if p is not None]


def _is_complete(path: str) -> bool:
    """Both halves landed: the state dir (renamed into place whole) and the
    config file written after it."""
    return (os.path.isdir(os.path.join(path, _STATE_DIR))
            and os.path.isfile(os.path.join(path, _CONFIG_FILE)))


def validate_checkpoint(path: str | os.PathLike) -> list[str]:
    """Why this checkpoint cannot be restored; empty means valid.  The one
    validity predicate of the fallback chain, GC, the gang's restore-point
    election and ``tools/ckpt_verify.py``: the quarantine marker,
    completeness, and the manifest's file digests (a pre-manifest
    checkpoint is valid when complete)."""
    path = os.path.abspath(os.fspath(path))
    reason = quarantine_reason(path)
    if reason is not None:
        return [f"quarantined: {reason}"]
    if not _is_complete(path):
        return ["incomplete: state dir or config file missing"]
    try:
        manifest = checkpoint_manifest(path)
    except (OSError, json.JSONDecodeError) as e:
        return [f"manifest unreadable: {e}"]
    if manifest is None:
        return []
    return _verify_manifest_files(path, manifest)


# -- telemetry -----------------------------------------------------------------
def _record_ckpt_io(tel, kind: str, start_s: float, end_s: float, step: int,
                    nbytes: int) -> None:
    """The span and registry entries of one checkpoint save or restore."""
    dur = end_s - start_s
    tel.tracer.complete(f"checkpoint_{kind}", start_s, end_s, step=step, bytes=nbytes)
    tel.registry.histogram(f"checkpoint_{kind}_seconds").observe(dur)
    tel.registry.counter(f"checkpoint_{kind}_bytes_total").inc(nbytes)
    tel.registry.counter(f"checkpoint_{kind}s_total").inc()
    if dur > 0:
        tel.registry.gauge(f"checkpoint_{kind}_mb_per_s").set(nbytes / dur / 1e6)


def _telemetry():
    from distributed_machine_learning_tpu_torch.telemetry import get_telemetry

    return get_telemetry()


# -- save ------------------------------------------------------------------------
def _config_payload(config, layout=None, cursor=None, shard_spec=None,
                    extra_payload=None) -> dict:
    payload = {"__class__": type(config).__name__, **dataclasses.asdict(config)}
    if layout is not None:
        payload["__layout__"] = layout
    if cursor is not None:
        payload["__cursor__"] = int(cursor)
    if shard_spec is not None:
        payload["__shard_spec__"] = shard_spec.as_dict()
    if extra_payload:
        payload["__extra__"] = dict(extra_payload)
    return payload


def _write_state_dir(path: str, host: _Host) -> tuple[dict, dict]:
    """Write ``host`` (a snapshot) as ``path/state``: every leaf file and
    the index into ``state.tmp``, then one rename.  Returns the manifest's
    ``files`` and ``leaves``, hashed from the bytes as written (a flat
    leaf's digest over its logical prefix under the snapshot's spec)."""
    tmp = os.path.join(path, _STATE_TMP)
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)

    def write(item):
        name, (dtype, shape, arr) = item
        fp = os.path.join(tmp, _leaf_file(name))
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        with open(fp, "wb") as f:
            f.write(memoryview(arr).cast("B"))
        logical = _logical_elems(name, shape, host.spec)
        return logical, _digests(arr, _logical_bytes(arr, logical))

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        digests = list(pool.map(write, list(host.items())))
    index = {"format": _INDEX_FORMAT,
             "leaves": {name: {"dtype": dtype, "shape": list(shape),
                               "file": _leaf_file(name)}
                        for name, (dtype, shape, _) in host.items()}}
    with open(os.path.join(tmp, _INDEX_FILE), "w") as f:
        json.dump(index, f, indent=1)
    files, leaves = {}, {}
    for (name, (dtype, shape, _)), (logical, (leaf, (sha, n))) in zip(host.items(), digests):
        files[os.path.join(_STATE_DIR, _leaf_file(name))] = {"sha256": sha, "bytes": n}
        leaves[name] = _leaf_entry(dtype, shape, *leaf, logical)
    sha, n = _file_digest(os.path.join(tmp, _INDEX_FILE))
    files[os.path.join(_STATE_DIR, _INDEX_FILE)] = {"sha256": sha, "bytes": n}
    # A re-save of this step: the old config goes first, so the directory
    # reads incomplete (never complete with a stale manifest) until the new
    # config lands.
    for stale in (_CONFIG_FILE, _MANIFEST_FILE):
        try:
            os.remove(os.path.join(path, stale))
        except FileNotFoundError:
            pass
    shutil.rmtree(os.path.join(path, _STATE_DIR), ignore_errors=True)
    os.replace(tmp, os.path.join(path, _STATE_DIR))
    return files, leaves


def _commit(path: str, files: dict, leaves: dict, payload: dict,
            shard_spec: ShardSpec | None) -> None:
    """Manifest, then the config (the completeness marker)."""
    try:  # a re-save over a quarantined dir is a fresh checkpoint
        os.remove(os.path.join(path, _INVALID_MARKER))
    except FileNotFoundError:
        pass
    _dump_manifest(path, files, leaves, shard_spec)
    with open(os.path.join(path, _CONFIG_FILE), "w") as f:
        json.dump(payload, f)
    _GC_VALIDATED.add(path)  # the manifest was just computed from these bytes


def _host_bytes(host: dict) -> int:
    return sum(arr.nbytes for _, _, arr in host.values())


def save_checkpoint(directory: str | os.PathLike, state, layout: str | None = None,
                    cursor: int | None = None, mid_save_hook=None,
                    keep_last_n: int | None = None, post_save_hook=None,
                    shard_spec: ShardSpec | None = None,
                    extra_payload: dict | None = None, comm=None) -> str:
    """Write ``state`` (a ``TrainState`` or a :class:`HostState`) under
    ``directory/step_<n>/``; returns the path.

    ``layout``: a tag naming the parameter layout, checked on resume
    (``checkpoint_layout``).  ``cursor``: the data-stream position
    (batches consumed), in the config payload (``checkpoint_cursor``).
    ``mid_save_hook``: called between the state write and the config
    write, the crash window ``_is_complete`` guards.  ``keep_last_n``:
    garbage-collect older checkpoints after this save (``gc_checkpoints``).
    ``post_save_hook(path)``: called once the checkpoint is committed.
    ``shard_spec``: the layout and world recorded in the manifest and the
    config; a ``Zero1State`` or ``FSDPState`` requires one that describes
    its padded vectors.  ``extra_payload``: caller metadata under
    ``__extra__`` (``checkpoint_extra``).  ``comm``: the ``Comm`` a
    ``FSDPState``'s or ``Zero1State``'s shards are spread over (None: this
    process holds the whole vectors).

    A re-save of the same step overwrites it.  Rank 0 writes; with a
    process group the other ranks wait at a barrier (after taking part in
    a flat state's gathers over ``comm``: every rank must call it)."""
    directory = os.path.abspath(os.fspath(directory))
    _check_shard_spec(state, shard_spec, comm)
    step = int(state.step)
    path = os.path.join(directory, f"step_{step}")
    _GC_VALIDATED.discard(path)
    t0 = time.perf_counter()
    nbytes = 0
    host = _save_snapshot(state, comm, False, shard_spec)
    if host is not None:  # the writer
        os.makedirs(path, exist_ok=True)
        nbytes = _host_bytes(host)
        files, leaves = _write_state_dir(path, host)
        del host
        if mid_save_hook is not None:
            mid_save_hook()
        _commit(path, files, leaves,
                _config_payload(state.config, layout, cursor, shard_spec, extra_payload),
                shard_spec)
        if keep_last_n is not None:
            gc_checkpoints(directory, keep_last_n)
        if post_save_hook is not None:
            post_save_hook(path)
    _barrier()
    tel = _telemetry()
    if tel is not None:
        _record_ckpt_io(tel, "save", t0, time.perf_counter(), step, nbytes)
    return path


def gc_checkpoints(directory: str | os.PathLike, keep_last_n: int) -> list[str]:
    """Delete old checkpoints, keeping the newest ``keep_last_n`` valid
    ones; returns the paths removed.  The newest valid checkpoint is never
    deleted; an invalid directory goes only when a valid one with a higher
    step exists (a newer one may be an async save in flight).  A complete
    directory that fails its digests is quarantined on discovery."""
    if keep_last_n < 1:
        raise ValueError(f"keep_last_n must be >= 1, got {keep_last_n}")
    directory = os.path.abspath(os.fspath(directory))
    if not os.path.isdir(directory):
        return []
    steps = _steps(directory)
    keep: set[int] = set()
    newest_valid: int | None = None
    validated_bad: set[int] = set()
    for s in sorted(steps, reverse=True):
        if len(keep) >= keep_last_n:
            break
        path = os.path.join(directory, f"step_{s}")
        if (path in _GC_VALIDATED and _is_complete(path)
                and quarantine_reason(path) is None):
            problems: list[str] = []
        else:
            problems = validate_checkpoint(path)
        if not problems:
            _GC_VALIDATED.add(path)
            keep.add(s)
            if newest_valid is None:
                newest_valid = s
            continue
        validated_bad.add(s)
        if _is_complete(path) and quarantine_reason(path) is None:
            quarantine_checkpoint(path, "; ".join(problems))
            _bump("ckpt_verify_failures")
    removed = []
    for s in steps:
        if s in keep:
            continue
        if s in validated_bad and (newest_valid is None or s >= newest_valid):
            continue  # possibly an in-flight save
        path = os.path.join(directory, f"step_{s}")
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


class AsyncCheckpointWriter:
    """Saves that do not hold up training: ``save`` snapshots the state to
    host memory on the caller's thread, then one background thread writes
    the state dir, the manifest and the config (in that order, as
    :func:`save_checkpoint` does) and runs the GC.  An in-flight save is
    invisible to ``latest_checkpoint`` until its config lands.  A new
    ``save`` waits for the previous one; call :meth:`wait` (or ``close``)
    before relying on the checkpoint.  A failure in the background is
    raised by the next ``wait``/``save``."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._issued = False

    def save(self, directory: str | os.PathLike, state, cursor: int | None = None,
             keep_last_n: int | None = None,
             shard_spec: ShardSpec | None = None) -> str:
        directory = os.path.abspath(os.fspath(directory))
        _check_shard_spec(state, shard_spec)
        step = int(state.step)
        path = os.path.join(directory, f"step_{step}")
        self.wait()
        _GC_VALIDATED.discard(path)
        self._issued = True
        t0 = time.perf_counter()
        host = _save_snapshot(state, None, True, shard_spec)  # a flat state's whole vectors
        if host is None:
            return path
        payload = _config_payload(state.config, cursor=cursor, shard_spec=shard_spec)
        tel = _telemetry()

        def work():
            try:
                os.makedirs(path, exist_ok=True)
                files, leaves = _write_state_dir(path, host)
                _commit(path, files, leaves, payload, shard_spec)
                if keep_last_n is not None:
                    gc_checkpoints(directory, keep_last_n)
                if tel is not None:  # dispatch → durable on disk
                    _record_ckpt_io(tel, "save", t0, time.perf_counter(), step,
                                    _host_bytes(host))
            except BaseException as exc:  # raised by the next wait()
                self._error = exc

        self._thread = threading.Thread(target=work, name="checkpoint-writer", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until the in-flight save (if any) is on disk with its
        config; every rank of a group meets at a barrier after it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._issued:
            self._issued = False
            _barrier()
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- the fallback chain ----------------------------------------------------------
def _steps(directory: str) -> list[int]:
    return [int(name[5:]) for name in os.listdir(directory)
            if name.startswith("step_") and name[5:].isdigit()]


def latest_checkpoint(directory: str | os.PathLike, events=None) -> str | None:
    """The highest-step valid ``step_<n>`` under ``directory``, or None: a
    fallback chain.  Incomplete checkpoints are skipped silently,
    quarantined ones without touching their data, and a complete one whose
    digests no longer match is quarantined and skipped, counting one
    ``ckpt_verify_failures`` and one ``ckpt_fallbacks``."""
    directory = os.fspath(directory)
    if not os.path.isdir(directory):
        return None
    for step in sorted(_steps(directory), reverse=True):
        path = os.path.join(directory, f"step_{step}")
        if quarantine_reason(path) is not None:
            continue
        if not _is_complete(path):
            continue
        problems = validate_checkpoint(path)
        if problems:
            quarantine_checkpoint(path, "; ".join(problems))
            _bump("ckpt_verify_failures", events)
            _bump("ckpt_fallbacks", events)
            from distributed_machine_learning_tpu_torch.utils.logging import rank0_print

            rank0_print(f"[checkpoint] {path} failed verification "
                        f"({problems[0]}{' …' if len(problems) > 1 else ''}); "
                        "quarantined, falling back to the previous valid checkpoint")
            continue
        return path
    return None


def checkpoint_chain_report(directory: str | os.PathLike) -> list[tuple[str, str]]:
    """(path, verdict) of every ``step_<n>`` under ``directory``, newest
    first: ``"valid"``, ``"quarantined: <why>"``, ``"incomplete: ..."`` or
    the first digest problem."""
    directory = os.fspath(directory)
    out: list[tuple[str, str]] = []
    if not os.path.isdir(directory):
        return out
    for step in sorted(_steps(directory), reverse=True):
        path = os.path.join(directory, f"step_{step}")
        reason = quarantine_reason(path)
        if reason is not None:
            verdict = f"quarantined: {reason}"
        else:
            problems = validate_checkpoint(path)
            verdict = "valid" if not problems else problems[0]
        out.append((path, verdict))
    return out


def require_latest_checkpoint(directory: str | os.PathLike, events=None) -> str:
    """:func:`latest_checkpoint`, or :class:`NoRestorableCheckpointError`
    listing every candidate with its verdict."""
    latest = latest_checkpoint(directory, events=events)
    if latest is not None:
        return latest
    report = checkpoint_chain_report(directory)
    if not report:
        raise NoRestorableCheckpointError(
            f"no checkpoint under {os.fspath(directory)} (no step_<n> directories exist)")
    lines = "\n".join(f"  {p}: {v}" for p, v in report)
    raise NoRestorableCheckpointError(
        f"no restorable checkpoint under {os.fspath(directory)} — every candidate "
        f"in the fallback chain is unusable:\n{lines}")


# -- metadata readers ----------------------------------------------------------
def _read_payload(path) -> dict:
    with open(os.path.join(os.fspath(path), _CONFIG_FILE)) as f:
        return json.load(f)


def checkpoint_config(path: str | os.PathLike):
    """The optimizer config a checkpoint was saved with.  A quarantined
    checkpoint raises :class:`CheckpointVerifyError` without reading data."""
    reason = quarantine_reason(path)
    if reason is not None:
        raise CheckpointVerifyError(f"checkpoint {os.fspath(path)} is quarantined "
                                    f"({reason}); refusing to read its config")
    from distributed_machine_learning_tpu_torch.train.optimizers import (
        config_class_by_name,
    )

    payload = _read_payload(path)
    for tag in ("__layout__", "__cursor__", "__shard_spec__", "__extra__"):
        payload.pop(tag, None)
    return config_class_by_name(payload.pop("__class__", "SGDConfig"))(**payload)


def _payload_field(path, key: str):
    """A config-payload field, or None for quarantined or torn checkpoints."""
    if quarantine_reason(path) is not None:
        return None
    try:
        return _read_payload(path).get(key)
    except (OSError, json.JSONDecodeError):
        return None


def checkpoint_shard_spec(path: str | os.PathLike) -> ShardSpec | None:
    """The ShardSpec a checkpoint was saved under, or None (spec-less,
    quarantined or torn)."""
    payload = _payload_field(path, "__shard_spec__")
    if payload is None:
        return None
    try:
        return ShardSpec.from_dict(payload)
    except (KeyError, TypeError, ValueError):
        return None


def checkpoint_cursor(path: str | os.PathLike) -> int | None:
    """The data-stream position a checkpoint was saved at, or None."""
    cursor = _payload_field(path, "__cursor__")
    return None if cursor is None else int(cursor)


def checkpoint_extra(path: str | os.PathLike) -> dict:
    """The caller metadata a checkpoint was saved with (empty without)."""
    extra = _payload_field(path, "__extra__")
    return extra if isinstance(extra, dict) else {}


def checkpoint_layout(path: str | os.PathLike) -> str | None:
    """The parameter-layout tag a checkpoint was saved with, or None (plain
    layouts, and quarantined checkpoints, whose data is not read)."""
    if quarantine_reason(path) is not None:
        return None
    return _read_payload(path).get("__layout__")


def _read_index(path: str) -> dict:
    fp = os.path.join(path, _STATE_DIR, _INDEX_FILE)
    if not os.path.isfile(fp):
        raise CheckpointVerifyError(
            f"checkpoint {path}: its {_STATE_DIR}/ holds no {_INDEX_FILE}: it was "
            "written by the JAX package (orbax tensorstore files), which the port "
            "does not read")
    try:
        with open(fp, "rb") as f:
            index = json.loads(f.read())
    except ValueError as exc:  # JSON or UTF-8: bytes that changed on disk
        quarantine_checkpoint(path, f"unreadable tensor index: {exc}")
        raise CheckpointVerifyError(f"checkpoint {path}: unreadable tensor index "
                                    f"({exc})") from None
    if index.get("format") != _INDEX_FORMAT:
        raise CheckpointVerifyError(f"checkpoint {path}: unknown tensor index format "
                                    f"{index.get('format')!r}")
    return index["leaves"]


def checkpoint_array_shapes(path: str | os.PathLike) -> dict:
    """The shapes of a checkpoint's leaves, nested by leaf-name group (a
    metadata read: no tensor I/O)."""
    leaves = _read_index(os.path.abspath(os.fspath(path)))
    return _nest({name: tuple(e["shape"]) for name, e in leaves.items()})


# -- restore -----------------------------------------------------------------------
def _tensor(buf: np.ndarray, dtype: str, shape) -> torch.Tensor:
    arr = buf.view(_NP_DTYPES[dtype]).reshape(shape)
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _load_leaves(path: str, manifest: dict | None, verify_files: bool,
                 events=None) -> dict[str, torch.Tensor]:
    """Every leaf of ``path/state`` as a CPU tensor, each file read once.
    ``verify_files``: hold the files to the manifest's file digests first
    (the index and any other file too).  Every leaf's buffer is then held
    to the manifest's leaf digests.  A mismatch quarantines the checkpoint
    and raises."""
    files = (manifest or {}).get("files", {})
    leaf_manifest = (manifest or {}).get("leaves", {})

    def fail(kind: str, problems: list[str]):
        quarantine_checkpoint(path, "; ".join(problems))
        _bump("ckpt_verify_failures", events)
        raise CheckpointVerifyError(f"checkpoint {path} failed {kind}: "
                                    + "; ".join(problems[:3]))

    if verify_files:  # the index (and any other non-leaf file) before it is parsed
        problems = _verify_manifest_files(path, {"files": {
            rel: e for rel, e in files.items() if not rel.endswith(_LEAF_SUFFIX)}})
        if problems:
            fail("file verification", problems)
    index = _read_index(path)

    def load(item):
        name, entry = item
        rel = os.path.join(_STATE_DIR, entry["file"])
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            return name, None, f"missing file {rel}", f"leaf {name}: no file"
        size = os.path.getsize(fp)
        buf = np.empty(size, dtype=np.uint8)
        with open(fp, "rb") as f:
            got = f.readinto(memoryview(buf))
        itemsize = np.dtype(_NP_DTYPES[entry["dtype"]]).itemsize
        want_leaf = leaf_manifest.get(name, {})
        logical = want_leaf.get("logical_elems")  # a flat leaf: its digest is the prefix's
        (leaf_sha, crc, leaf_n), (sha, n) = _digests(
            buf[:got], None if logical is None else int(logical) * itemsize)
        file_problem = leaf_problem = None
        want = files.get(rel)
        if verify_files and want is not None:
            if n != want["bytes"]:
                file_problem = f"size mismatch {rel}: {n} != {want['bytes']}"
            elif sha != want["sha256"]:
                file_problem = f"digest mismatch {rel}"
        expect = itemsize * int(np.prod(entry["shape"], dtype=np.int64))
        if n != expect:
            leaf_problem = f"leaf {name}: {n} bytes on disk != {expect} for its shape"
        elif "sha256" in want_leaf:
            if leaf_n != want_leaf["bytes"]:
                leaf_problem = f"leaf {name}: {leaf_n} bytes != {want_leaf['bytes']}"
            elif crc != want_leaf["crc32"] or leaf_sha != want_leaf["sha256"]:
                leaf_problem = f"leaf {name}: content digest mismatch"
        return name, buf, file_problem, leaf_problem

    leaf_rels = {os.path.join(_STATE_DIR, e["file"]) for e in index.values()}
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        loaded = list(pool.map(load, list(index.items())))
    file_problems = [p for _, _, p, _ in loaded if p]
    if verify_files:  # leaf-named files the index does not list
        file_problems += _verify_manifest_files(path, {"files": {
            rel: e for rel, e in files.items()
            if rel.endswith(_LEAF_SUFFIX) and rel not in leaf_rels}})
    if file_problems:
        fail("file verification", file_problems)
    leaf_problems = [p for _, _, _, p in loaded if p]
    if leaf_problems:
        fail("content verification after restore", leaf_problems)
    return {name: _tensor(buf, index[name]["dtype"], index[name]["shape"])
            for name, buf, _, _ in loaded}


@torch.no_grad()
def _into_template(template, flat: dict) -> None:
    """Copy the loaded leaves into ``template``'s tensors, in place (on the
    template's devices, cast to its dtypes)."""
    want = _state_leaves(template)
    want.pop("step")
    have = {k for k in flat if k != "step"}
    if have != set(want):
        missing, extra = sorted(set(want) - have), sorted(have - set(want))
        raise ValueError(f"checkpoint leaves do not fit the template: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    targets = {f"params/{k}": p for k, p in template.params.items()}
    _flatten(template.momentum, "momentum", targets)
    targets.update({f"batch_stats/{k}": b for k, b in template.batch_stats.items()})
    for name, dst in targets.items():
        src = flat[name]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"leaf {name}: checkpoint shape {tuple(src.shape)} != "
                             f"template {tuple(dst.shape)}")
        dst.copy_(src)


def restore_checkpoint(path: str | os.PathLike, template_state=None, *,
                       files_verified: bool = False, events=None):
    """Load the state saved at ``path`` (a ``step_<n>`` directory).

    With ``template_state`` (a ``TrainState`` of the same model and
    optimizer), every leaf is copied into its tensors in place, on their
    devices, and its ``step`` and ``config`` are set from the checkpoint;
    it is returned.  Without one, a :class:`HostState` of CPU tensors.

    Verification is end to end: the files against the manifest's file
    digests (unless ``files_verified``: the caller just had the path from
    ``latest_checkpoint``, which hashed them), then every leaf's buffer
    against its leaf digests, before anything reaches the state.  A
    mismatch quarantines the checkpoint and raises
    :class:`CheckpointVerifyError`, as does a checkpoint of the JAX
    package (orbax files the port does not read).  A zero1/fsdp checkpoint
    restores as :func:`reshard_restore` at its saved world does (no
    template)."""
    path = os.path.abspath(os.fspath(path))
    reason = quarantine_reason(path)
    if reason is not None:
        raise CheckpointVerifyError(f"checkpoint {path} is quarantined ({reason})")
    spec = checkpoint_shard_spec(path)
    if spec is not None and spec.layout != "dp":
        if template_state is not None:
            raise ValueError(f"a {spec.layout} checkpoint holds flat padded vectors, not a "
                             "TrainState's leaves: restore it with reshard_restore")
        return reshard_restore(path, files_verified=files_verified, events=events)[0]
    manifest = checkpoint_manifest(path)
    t0 = time.perf_counter()
    flat = _load_leaves(path, manifest, verify_files=not files_verified, events=events)
    config = checkpoint_config(path)
    step = int(flat["step"])
    nbytes = sum(t.numel() * t.element_size() for t in flat.values())
    if template_state is not None:
        _into_template(template_state, flat)
        template_state.step = step
        template_state.config = config
        state = template_state
    else:
        groups = _nest({k: v for k, v in flat.items() if k != "step"})
        state = HostState(params=groups.get("params", {}),
                          momentum=groups.get("momentum", {}),
                          batch_stats=groups.get("batch_stats", {}), step=step,
                          config=config)
    tel = _telemetry()
    if tel is not None:
        _record_ckpt_io(tel, "restore", t0, time.perf_counter(), step, nbytes)
    return state


def _flat_state(path: str, saved: ShardSpec, target: int, rank: int | None,
                files_verified: bool, events):
    """A zero1/fsdp checkpoint as a ``Zero1State``/``FSDPState`` laid out for
    ``target`` ranks: the logical digests verified, each flat vector cut to
    ``n_elems`` and padded anew (``repad_flat``), then this ``rank``'s block
    of the sharded ones (all of them when ``rank`` is None)."""
    flat = _load_leaves(path, checkpoint_manifest(path), verify_files=not files_verified,
                        events=events)
    n = saved.n_elems

    def repad(t):
        return torch.from_numpy(repad_flat(t.numpy(), n, target))

    def mine(t):
        if rank is None:
            return t
        size = t.numel() // target
        return t[rank * size:(rank + 1) * size].clone()

    moments = {k.split("/", 1)[1]: mine(repad(v)) for k, v in flat.items()
               if k.startswith("momentum_shards/")}
    momentum = moments or mine(repad(flat["momentum_shards"]))
    stats = {k.split("/", 1)[1]: v for k, v in flat.items() if k.startswith("batch_stats/")}
    step, config = int(flat["step"]), checkpoint_config(path)
    if saved.layout == "fsdp":
        from distributed_machine_learning_tpu_torch.parallel.fsdp import FSDPState

        return FSDPState(param_shard=mine(repad(flat["param_shards"])), momentum_shards=momentum,
                         step=step, config=config, batch_stats=stats)
    from distributed_machine_learning_tpu_torch.parallel.zero1 import Zero1State

    return Zero1State(param_flat=repad(flat["param_flat"]), momentum_shards=momentum,
                      step=step, config=config, batch_stats=stats)


def reshard_restore(path: str | os.PathLike, *, world: int | None = None,
                    rank: int | None = None, events=None, files_verified: bool = False):
    """Restore the checkpoint at ``path`` onto a (possibly different) world
    size; returns ``(state, spec)`` with ``spec`` aimed at the target world
    (``world``, else the saved one).

    - ``dp`` (or spec-less): no world-dependent padding, the plain
      :func:`restore_checkpoint` at any target (a ``HostState``).
    - ``zero1``/``fsdp``: the flat padded vectors are read at their saved
      length and verified against the manifest's logical digests, then cut
      to ``n_elems`` and padded for the target world, content kept bit for
      bit (ragged worlds included); the result is a ``Zero1State`` or
      ``FSDPState`` of CPU tensors (layouts are not converted).  Its sharded
      vectors are ``rank``'s blocks of the target world, or without a
      ``rank`` the whole vectors (a state that one process can save again).

    A restore whose target differs from a recorded world counts one
    ``reshard_restores``."""
    path = os.path.abspath(os.fspath(path))
    reason = quarantine_reason(path)
    if reason is not None:
        raise CheckpointVerifyError(f"checkpoint {path} is quarantined ({reason})")
    spec = checkpoint_shard_spec(path)
    saved = spec if spec is not None else ShardSpec("dp", world=1)
    target = saved.world if world is None else int(world)
    if rank is not None and not 0 <= rank < target:
        raise ValueError(f"rank {rank} out of range for world {target}")
    if saved.layout == "dp":
        state = restore_checkpoint(path, files_verified=files_verified, events=events)
    else:
        t0 = time.perf_counter()
        state = _flat_state(path, saved, target, rank, files_verified, events)
        tel = _telemetry()
        if tel is not None:
            nbytes = sum(e["bytes"] for e in (checkpoint_manifest(path) or {})
                         .get("files", {}).values())
            _record_ckpt_io(tel, "restore", t0, time.perf_counter(), state.step, nbytes)
    if spec is not None and target != saved.world:
        _bump("reshard_restores", events)
        tel = _telemetry()
        if tel is not None:
            tel.tracer.instant("reshard_restore", layout=saved.layout,
                               from_world=saved.world, to_world=target)
        from distributed_machine_learning_tpu_torch.utils.logging import rank0_print

        rank0_print(f"[checkpoint] resharded {path} ({saved.layout}) from world "
                    f"{saved.world} onto world {target}")
    return state, saved.with_world(target)
