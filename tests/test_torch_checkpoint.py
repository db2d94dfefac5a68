"""The port's checkpoints (train/checkpoint.py, cli.lm --ckpt-dir/--resume,
cli.generate --ckpt-dir) against themselves and against the JAX package.

Port against itself, each case of ``tests/test_checkpoint.py``: a round
trip bit for bit (parameters, momentum, BatchNorm statistics, step,
config), the highest step wins, incomplete checkpoints are skipped,
resume equals the uninterrupted trajectory bit for bit, the async writer,
GC, the cursor, a crash mid-save.  Against JAX on the same directories:
the validity verdicts of both packages on each other's checkpoints, the
manifest and config schema, ``tools/ckpt_verify.py`` unedited.  Against
JAX by trajectory (``tests/test_torch_lm_train.py``'s d64 LM and its
tolerances: losses within 1e-5 relative, parameters within 2e-5 after
AdamW steps from converted weights): 2 steps, save, restore, 2 more, with
and without a new learning rate; and the greedy text of both packages'
``cli.generate --ckpt-dir``.  A world-2 gloo run of ``cli.lm --ckpt-dir``
then ``--resume``.  Everything is f32 on the CPU.
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec
from distributed_machine_learning_tpu_torch.train import checkpoint as ck
from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
from distributed_machine_learning_tpu_torch.train.lm_step import make_lm_train_step
from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
from distributed_machine_learning_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
BATCH, SEQ = 2, 128
# tests/test_torch_lm_train.py's tolerances, for the same model and steps.
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


# -- helpers -------------------------------------------------------------------
def _vgg_state(config=None, seed=0):
    from distributed_machine_learning_tpu_torch.models.registry import get_model, init_params

    model = init_params(get_model("vggtest", use_bn=True, device="cpu"), seed)
    return TrainState.create(model, config or SGDConfig())


def _vgg_batch(rng, n=4):
    images = torch.from_numpy(rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, n)).long()
    return images, labels


def _vgg_step(state):
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    return make_train_step(state.model, augment=True)


def _leaves(state) -> dict:
    """Every tensor of a state by leaf name, as CPU copies."""
    return {k: v.detach().cpu().clone() for k, v in ck._state_leaves(state).items()}


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _lm_state(params=None, config=None, seed=0):
    from distributed_machine_learning_tpu_torch.convert import init_params

    model = TransformerLM(**MODEL, device="cpu")
    if params is None:
        init_params(model, seed=seed)
    else:
        model.load_state_dict(flax_to_state_dict(params))
    return TrainState.create(model, config or AdamWConfig())


def _set_step(state, step):
    state.step = step
    return state


def _flip_byte(step_dir):
    """Flip one byte in the middle of the largest file under ``state/``."""
    files = []
    for root, _, names in os.walk(os.path.join(step_dir, "state")):
        files += [os.path.join(root, n) for n in names]
    fp = max(files, key=os.path.getsize)
    at = os.path.getsize(fp) // 2
    with open(fp, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0xFF]))
    ck.forget_validated(step_dir)


# -- port against itself -----------------------------------------------------------
def test_roundtrip_bit_identical(tmp_path, rng):
    """A trained step's state (non-zero momentum, moved BN statistics) comes
    back bit for bit, with and without a template; so does the config."""
    state = _vgg_state(SGDConfig(learning_rate=0.05))
    state, _ = _vgg_step(state)(state, *_vgg_batch(rng))
    path = ck.save_checkpoint(tmp_path, state)
    want = _leaves(state)
    host = ck.restore_checkpoint(path)
    assert isinstance(host, ck.HostState) and host.step == state.step == 1
    assert host.config == SGDConfig(learning_rate=0.05)
    _assert_bitwise(_leaves(host), want)
    assert any(not torch.equal(v, torch.zeros_like(v)) for v in host.momentum.values())
    fresh = _vgg_state(seed=5)
    restored = ck.restore_checkpoint(path, fresh)
    assert restored is fresh and restored.step == 1
    assert restored.config == SGDConfig(learning_rate=0.05)
    _assert_bitwise(_leaves(restored), want)


def test_latest_checkpoint_picks_highest_step(tmp_path):
    state = _vgg_state()
    assert ck.latest_checkpoint(tmp_path) is None
    ck.save_checkpoint(tmp_path, state)
    ck.save_checkpoint(tmp_path, _set_step(_vgg_state(), 7))
    latest = ck.latest_checkpoint(tmp_path)
    assert latest is not None and latest.endswith("step_7")
    assert ck.latest_checkpoint(tmp_path / "nonexistent") is None


def test_incomplete_checkpoint_skipped_and_resave_overwrites(tmp_path):
    state = _vgg_state()
    complete = ck.save_checkpoint(tmp_path, state)
    (tmp_path / "step_9" / "state").mkdir(parents=True)  # a crash before the config
    assert ck.latest_checkpoint(tmp_path) == complete
    again = ck.save_checkpoint(tmp_path, state)  # the same step: overwritten
    assert again == complete and not ck.validate_checkpoint(again)
    assert not (tmp_path / "step_0" / "state.tmp").exists()


def test_resume_matches_uninterrupted_trajectory(tmp_path, rng):
    """2 steps, save, restore into a fresh state, 2 more: the same loss and
    the same parameters and momentum, bit for bit, as 4 straight steps (the
    augmentation draws from the step counter, which the checkpoint holds)."""
    batches = [_vgg_batch(rng) for _ in range(4)]
    s = _vgg_state()
    step = _vgg_step(s)
    for x, y in batches:
        s, loss_straight = step(s, x, y)
    s2 = _vgg_state()
    step2 = _vgg_step(s2)
    for x, y in batches[:2]:
        s2, _ = step2(s2, x, y)
    path = ck.save_checkpoint(tmp_path, s2)
    s3 = ck.restore_checkpoint(path, _vgg_state(seed=3))
    assert s3.step == 2
    step3 = _vgg_step(s3)
    for x, y in batches[2:]:
        s3, loss_resumed = step3(s3, x, y)
    assert float(loss_straight) == float(loss_resumed)
    _assert_bitwise(_leaves(s3), _leaves(s))


def test_async_checkpoint_roundtrip(tmp_path):
    state = _vgg_state()
    with ck.AsyncCheckpointWriter() as writer:
        path = writer.save(tmp_path, state)
        writer.wait()
    assert ck.latest_checkpoint(tmp_path) == path
    restored = ck.restore_checkpoint(path, _vgg_state(seed=4))
    _assert_bitwise(_leaves(restored), _leaves(state))
    assert type(restored.config) is type(state.config)


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The writer snapshots on the caller's thread: training on after
    ``save`` does not change what lands on disk."""
    state = _vgg_state()
    want = _leaves(state)
    with ck.AsyncCheckpointWriter() as writer:
        path = writer.save(tmp_path, state)
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    _assert_bitwise(_leaves(ck.restore_checkpoint(path)), want)


def test_gc_checkpoints_keeps_newest_complete(tmp_path):
    for s in (1, 2, 3):
        ck.save_checkpoint(tmp_path, _set_step(_vgg_state(), s))
    (tmp_path / "step_0" / "state").mkdir(parents=True)  # an old crash leftover
    (tmp_path / "step_9" / "state").mkdir(parents=True)  # possibly in flight
    removed = ck.gc_checkpoints(tmp_path, keep_last_n=2)
    names = {p.name for p in tmp_path.iterdir()}
    assert {"step_2", "step_3", "step_9"} <= names
    assert "step_1" not in names and "step_0" not in names
    assert len(removed) == 2
    with pytest.raises(ValueError):
        ck.gc_checkpoints(tmp_path, keep_last_n=0)


def test_save_checkpoint_keep_last_n_gc_inline(tmp_path):
    for s in (1, 2, 3):
        ck.save_checkpoint(tmp_path, _set_step(_vgg_state(), s), keep_last_n=1)
    assert {p.name for p in tmp_path.iterdir()} == {"step_3"}


def test_checkpoint_metadata_roundtrip(tmp_path):
    """cursor, layout, shard spec and extra payload ride the config without
    leaking into the optimizer config; a quarantined checkpoint reads as
    none of them."""
    state = _vgg_state(SGDConfig(learning_rate=0.05))
    path = ck.save_checkpoint(tmp_path / "a", state, cursor=17, layout="pp-contiguous",
                              shard_spec=ShardSpec("dp", world=2),
                              extra_payload={"examples": 68})
    assert ck.checkpoint_cursor(path) == 17
    assert ck.checkpoint_layout(path) == "pp-contiguous"
    assert ck.checkpoint_shard_spec(path) == ShardSpec("dp", world=2)
    assert ck.checkpoint_extra(path) == {"examples": 68}
    assert ck.checkpoint_config(path) == SGDConfig(learning_rate=0.05)
    assert ck.checkpoint_manifest(path)["shard_spec"] == {"layout": "dp", "world": 2,
                                                           "n_elems": None}
    shapes = ck.checkpoint_array_shapes(path)
    assert shapes["step"] == () and shapes["params"]["fc1.weight"] == (10, 16)
    assert shapes["batch_stats"]["bns.0.running_mean"] == (8,)
    without = ck.save_checkpoint(tmp_path / "b", state)
    assert ck.checkpoint_cursor(without) is None and ck.checkpoint_extra(without) == {}
    ck.quarantine_checkpoint(path, "test")
    assert ck.checkpoint_cursor(path) is None and ck.checkpoint_layout(path) is None
    with pytest.raises(ck.CheckpointVerifyError, match="quarantined"):
        ck.checkpoint_config(path)


def test_mid_save_crash_leaves_checkpoint_invisible(tmp_path):
    complete = ck.save_checkpoint(tmp_path, _vgg_state())

    def die():
        raise RuntimeError("killed mid-save")

    later = _set_step(_vgg_state(), 5)
    with pytest.raises(RuntimeError):
        ck.save_checkpoint(tmp_path, later, mid_save_hook=die)
    assert (tmp_path / "step_5" / "state").exists()  # the torn save is on disk
    assert ck.latest_checkpoint(tmp_path) == complete  # ...and invisible
    healed = ck.save_checkpoint(tmp_path, later)
    assert ck.latest_checkpoint(tmp_path) == healed


def test_async_config_written_only_after_state_commit(tmp_path, monkeypatch):
    """While the background thread is still writing the state, neither the
    config nor the state dir exists and the checkpoint is invisible; after
    ``wait`` it is complete with its cursor."""
    import threading

    gate = threading.Event()
    real = ck._write_state_dir

    def held(path, host):
        assert gate.wait(30)
        return real(path, host)

    monkeypatch.setattr(ck, "_write_state_dir", held)
    state = _vgg_state()
    with ck.AsyncCheckpointWriter() as writer:
        path = writer.save(tmp_path, state, cursor=4)
        assert not os.path.exists(os.path.join(path, "sgd_config.json"))
        assert not os.path.exists(os.path.join(path, "state"))
        assert ck.latest_checkpoint(tmp_path) is None
        gate.set()
        writer.wait()
        assert ck.latest_checkpoint(tmp_path) == path
        assert ck.checkpoint_cursor(path) == 4
    assert ck.restore_checkpoint(path, _vgg_state()).step == state.step


def test_restore_verifies_and_quarantines(tmp_path):
    """A flipped byte fails the restore (file check, or with
    ``files_verified`` the leaf check), quarantines and counts; the chain
    then falls back; with none left, require_latest_checkpoint reports
    every candidate."""
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents

    good = ck.save_checkpoint(tmp_path, _set_step(_vgg_state(), 1))
    bad = ck.save_checkpoint(tmp_path, _set_step(_vgg_state(), 2))
    _flip_byte(bad)
    events = FaultEvents()
    with pytest.raises(ck.CheckpointVerifyError, match="failed content verification"):
        ck.restore_checkpoint(bad, files_verified=True, events=events)
    assert events.ckpt_verify_failures == 1 and ck.quarantine_reason(bad)
    assert ck.latest_checkpoint(tmp_path) == good
    _flip_byte(good)
    with pytest.raises(ck.CheckpointVerifyError, match="failed file verification"):
        ck.restore_checkpoint(good)
    with pytest.raises(ck.NoRestorableCheckpointError, match="step_2: quarantined"):
        ck.require_latest_checkpoint(tmp_path)


def test_reshard_restore_of_dp_counts_a_world_change(tmp_path):
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents

    state = _vgg_state()
    path = ck.save_checkpoint(tmp_path, state, shard_spec=ShardSpec("dp", world=2))
    events = FaultEvents()
    restored, spec = ck.reshard_restore(path, world=1, events=events)
    assert spec == ShardSpec("dp", world=1) and events.reshard_restores == 1
    _assert_bitwise(_leaves(restored), _leaves(state))
    _, same = ck.reshard_restore(ck.save_checkpoint(tmp_path / "b", state), world=4,
                                 events=events)
    assert same == ShardSpec("dp", world=4) and events.reshard_restores == 1  # spec-less


def test_telemetry_records_save_and_restore(tmp_path):
    """With telemetry installed, each save and restore is one span with its
    step and bytes, and the registry counts them."""
    from distributed_machine_learning_tpu_torch.telemetry import Telemetry, set_telemetry

    tel = Telemetry(tmp_path / "tel")
    prev = set_telemetry(tel)
    try:
        state = _vgg_state()
        path = ck.save_checkpoint(tmp_path / "ck", state)
        ck.restore_checkpoint(path)
    finally:
        set_telemetry(prev)
        tel.close()
    snap = tel.registry.snapshot()
    counters = {c["name"]: c["value"] for c in snap["counters"]}
    nbytes = sum(v.numel() * v.element_size() for v in _leaves(state).values())
    assert counters["checkpoint_saves_total"] == counters["checkpoint_restores_total"] == 1
    assert counters["checkpoint_save_bytes_total"] == nbytes
    assert counters["checkpoint_restore_bytes_total"] == nbytes
    spans = json.load(open(tmp_path / "tel" / "trace.json"))
    assert {e["name"] for e in spans} >= {"checkpoint_save", "checkpoint_restore"}
    assert all(e["args"]["bytes"] == nbytes and e["args"]["step"] == 0 for e in spans)


# -- the flat layouts (zero1/fsdp), after tests/test_elastic.py:188-353 ----------------
def _flat_state(layout: str, model: str):
    """A world-1 Zero1State/FSDPState of the VGG (SGD) or LM (AdamW) state
    and its unpadded length."""
    from distributed_machine_learning_tpu_torch.parallel.fsdp import shard_fsdp_state
    from distributed_machine_learning_tpu_torch.parallel.zero1 import shard_zero1_state
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    state = _vgg_state() if model == "vgg" else _lm_state()
    shard = shard_zero1_state if layout == "zero1" else shard_fsdp_state
    flat_state, _, n = shard(state, Comm())
    return flat_state, n


def _logical(state, n: int):
    """(parameter prefix, momentum prefixes) of a whole-vector flat state."""
    vec = state.param_shard if hasattr(state, "param_shard") else state.param_flat
    mom = state.momentum_shards
    moms = [mom[k] for k in sorted(mom)] if isinstance(mom, dict) else [mom]
    return vec[:n].clone(), [m[:n].clone() for m in moms]


def _assert_logical_equal(a, b):
    assert torch.equal(a[0], b[0])
    assert len(a[1]) == len(b[1]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("model", ["vgg", "lm"])
@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_flat_reshard_roundtrip_bit_identical(tmp_path, layout, model):
    """save@1 → restore@8 → save@8 → restore@4 → save@4 → restore@8: the
    logical state bit for bit, the flat leaves' logical digests equal in all
    three checkpoints, the JAX package's file-level verdict valid."""
    from distributed_machine_learning_tpu.train.checkpoint import (
        validate_checkpoint as jax_validate,
    )

    s1, n = _flat_state(layout, model)
    assert ck.state_layout(s1) == layout
    p1 = ck.save_checkpoint(tmp_path / "w1", s1, shard_spec=ShardSpec(layout, 1, n_elems=n))
    s8, spec8 = ck.reshard_restore(p1, world=8)
    assert spec8 == ShardSpec(layout, 8, n_elems=n) and type(s8) is type(s1)
    p8 = ck.save_checkpoint(tmp_path / "w8", s8, shard_spec=spec8)
    s4, spec4 = ck.reshard_restore(p8, world=4)
    p4 = ck.save_checkpoint(tmp_path / "w4", s4, shard_spec=spec4)
    back, spec_back = ck.reshard_restore(p4, world=8)
    assert spec_back == spec8 and back.step == s1.step
    _assert_logical_equal(_logical(back, n), _logical(s1, n))
    flat_key = "param_shards" if layout == "fsdp" else "param_flat"
    manifests = [ck.checkpoint_manifest(p)["leaves"] for p in (p1, p8, p4)]
    assert manifests[0][flat_key]["logical_elems"] == n
    for key in manifests[0]:
        assert len({m[key]["sha256"] for m in manifests}) == 1, key
    assert {k: tuple(v.shape) for k, v in back.batch_stats.items()} == \
        {k: tuple(v.shape) for k, v in s1.batch_stats.items()}
    for p in (p1, p8, p4):
        assert ck.validate_checkpoint(p) == [] and jax_validate(p) == []


@pytest.mark.parametrize("small,big", [(3, 5), (4, 7)])
@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_flat_reshard_ragged_worlds_and_corruption(tmp_path, layout, small, big):
    """The grow direction between ragged worlds (neither divides the
    element count), logical bit identity, and a byte flip in the small
    world's save caught (and quarantined) when restoring at the big one."""
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents

    s1, n = _flat_state(layout, "lm")
    p1 = ck.save_checkpoint(tmp_path / "w1", s1, shard_spec=ShardSpec(layout, 1, n_elems=n))
    ev = FaultEvents()
    s_small, spec_small = ck.reshard_restore(p1, world=small, events=ev)
    assert (s_small.param_shard if layout == "fsdp" else s_small.param_flat).numel() == \
        -(-n // small) * small
    p_small = ck.save_checkpoint(tmp_path / "small", s_small, shard_spec=spec_small)
    grown, spec_big = ck.reshard_restore(p_small, world=big, events=ev)
    assert spec_big == ShardSpec(layout, big, n_elems=n) and ev.reshard_restores == 2
    _assert_logical_equal(_logical(grown, n), _logical(s1, n))
    _flip_byte(p_small)
    with pytest.raises(ck.CheckpointVerifyError):
        ck.reshard_restore(p_small, world=big)
    assert ck.quarantine_reason(p_small) is not None


def test_flat_save_requires_matching_spec(tmp_path):
    """A flat state saved without its spec, under another layout's, under
    a (world, n_elems) that does not describe its padded vectors, or as one
    rank's blocks without their comm is refused at the save, in the
    reference's words."""
    s1, n = _flat_state("fsdp", "vgg")
    for spec, match in ((None, "saving a fsdp state requires a shard_spec"),
                        (ShardSpec("zero1", 1, n_elems=n), "does not match the state's "
                                                           "layout 'fsdp'"),
                        (ShardSpec("fsdp", 1, n_elems=n - 8), "expects a flat vector of"),
                        (ShardSpec("fsdp", 4, n_elems=n), "wrong world or n_elems")):
        with pytest.raises(ValueError, match=match):
            ck.save_checkpoint(tmp_path, s1, shard_spec=spec)
    with pytest.raises(ValueError, match="does not match the state's layout 'dp'"):
        ck.save_checkpoint(tmp_path, _vgg_state(), shard_spec=ShardSpec("zero1", 2, n_elems=10))
    # one rank's blocks of a world-2 state, saved without the comm they are
    # spread over: the moments stand for half the vector
    z1, n = _flat_state("zero1", "vgg")
    p = ck.save_checkpoint(tmp_path / "z1", z1, shard_spec=ShardSpec("zero1", 1, n_elems=n))
    block, spec2 = ck.reshard_restore(p, world=2, rank=0)
    with pytest.raises(ValueError, match="wrong world or n_elems"):
        ck.save_checkpoint(tmp_path / "z2", block, shard_spec=spec2)


def test_flat_restore_blocks_and_plain_restore(tmp_path):
    """``reshard_restore(rank=r)`` keeps rank r's blocks of the sharded
    vectors (zero1's parameters stay whole), and the four ranks' blocks
    make the whole vectors; ``restore_checkpoint`` of a flat checkpoint is
    the restore at its saved world and refuses a TrainState template."""
    for layout in ("zero1", "fsdp"):
        s1, n = _flat_state(layout, "lm")
        p = ck.save_checkpoint(tmp_path / layout, s1, shard_spec=ShardSpec(layout, 1, n_elems=n))
        whole, _ = ck.reshard_restore(p, world=4)
        blocks = [ck.reshard_restore(p, world=4, rank=r)[0] for r in range(4)]
        for w in ("mu", "nu"):
            assert torch.equal(torch.cat([b.momentum_shards[w] for b in blocks]),
                               whole.momentum_shards[w])
        if layout == "fsdp":
            assert torch.equal(torch.cat([b.param_shard for b in blocks]), whole.param_shard)
        else:
            assert all(torch.equal(b.param_flat, whole.param_flat) for b in blocks)
        plain = ck.restore_checkpoint(p)
        _assert_logical_equal(_logical(plain, n), _logical(s1, n))
        with pytest.raises(ValueError, match="restore it with reshard_restore"):
            ck.restore_checkpoint(p, _lm_state())


# -- against the JAX package, on the same directories ----------------------------
def _jax_lm():
    """The reference's LM and a fresh AdamW state (its step donates states,
    so every caller gets its own)."""
    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig as RefAdamW
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    model = RefLM(**MODEL)
    return model, init_lm_state(model, seed=69143, config=RefAdamW())


@functools.lru_cache(maxsize=None)
def _jax_state():
    """One reference state for the tests that only save it."""
    return _jax_lm()[1]


def _write(writer: str, directory, step: int):
    if writer == "port":
        return ck.save_checkpoint(directory, _set_step(_lm_state(seed=step), step))
    from distributed_machine_learning_tpu.train import checkpoint as jck

    state = _jax_state()
    return jck.save_checkpoint(directory, state.replace(step=jnp.asarray(step, jnp.int32)))


def _verdicts(pkg, directory):
    return {"validate": {p: pkg.validate_checkpoint(os.path.join(directory, p))
                         for p in sorted(os.listdir(directory))},
            "chain": [(os.path.basename(p), v)
                      for p, v in pkg.checkpoint_chain_report(directory)],
            "latest": os.path.basename(pkg.latest_checkpoint(directory) or "-")}


@pytest.mark.parametrize("case", ["valid", "torn_config", "byte_flip", "quarantined"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_validity_verdicts_match_jax(tmp_path, writer, case):
    """step_1 valid, step_2 in the case's condition: JAX's and the port's
    validate_checkpoint, checkpoint_chain_report and latest_checkpoint
    agree, each on its own copy of the directory (the chain quarantines)."""
    from distributed_machine_learning_tpu.train import checkpoint as jck

    src = tmp_path / "src"
    _write(writer, src, 1)
    newest = _write(writer, src, 2)
    if case == "torn_config":
        os.remove(os.path.join(newest, "sgd_config.json"))
    elif case == "byte_flip":
        _flip_byte(newest)
    elif case == "quarantined":
        ck.quarantine_checkpoint(newest, "operator verdict")
    got = {}
    for name, pkg in (("jax", jck), ("port", ck)):
        shutil.copytree(src, tmp_path / name)
        got[name] = _verdicts(pkg, tmp_path / name)
    assert got["port"] == got["jax"]
    want_latest = "step_2" if case == "valid" else "step_1"
    assert got["port"]["latest"] == want_latest
    assert (got["port"]["chain"][0][1] == "valid") == (case == "valid")


def test_manifest_and_config_schema_match_jax(tmp_path):
    """The same TrainState shape saved by both packages: the same manifest
    and config keys with the same value types, per file and per leaf, and
    the same number of parameter and moment leaves."""
    from distributed_machine_learning_tpu.train import checkpoint as jck

    jstate = _jax_state()
    jpath = jck.save_checkpoint(tmp_path / "jax", jstate)
    ppath = ck.save_checkpoint(tmp_path / "port", _lm_state(jax.device_get(jstate.params)))
    jm, pm = (json.load(open(os.path.join(p, "manifest.json"))) for p in (jpath, ppath))
    assert jm.keys() == pm.keys() and jm["version"] == pm["version"] == 1

    def schema(entries):
        return {tuple((k, type(v).__name__) for k, v in e.items()) for e in entries.values()}

    assert schema(jm["files"]) == schema(pm["files"])
    assert schema(jm["leaves"]) == schema(pm["leaves"])

    def count(m, prefix):
        return sum(1 for k in m["leaves"] if k.startswith(prefix))

    for prefix in ("params/", "momentum/mu/", "momentum/nu/"):
        assert count(jm, prefix) == count(pm, prefix) > 0, prefix
    assert jm["leaves"]["step"]["dtype"] == pm["leaves"]["step"]["dtype"] == "int32"
    jc, pc = (json.load(open(os.path.join(p, "sgd_config.json"))) for p in (jpath, ppath))
    assert {k: type(v).__name__ for k, v in jc.items()} == \
        {k: type(v).__name__ for k, v in pc.items()}
    assert jc == pc


def test_ckpt_verify_tool_on_port_checkpoints(tmp_path):
    """tools/ckpt_verify.py, unedited: exit 0 on a port checkpoint with every
    leaf listed, nonzero after a flipped byte."""
    path = ck.save_checkpoint(tmp_path, _lm_state())
    tool = [sys.executable, os.path.join(REPO, "tools", "ckpt_verify.py"), str(tmp_path)]
    ok = subprocess.run(tool, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    n_leaves = len(ck.checkpoint_manifest(path)["leaves"])
    assert f"{n_leaves} leaves verified against manifest" in ok.stdout
    _flip_byte(path)
    bad = subprocess.run(tool + ["--json"], capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0
    assert json.loads(bad.stdout)["checkpoints"][0]["ok"] is False


def test_jax_written_state_is_refused(tmp_path):
    """A checkpoint the JAX package wrote validates (its files hash clean)
    but does not restore: orbax files, no port index."""
    path = _write("jax", tmp_path, 3)
    assert ck.validate_checkpoint(path) == []
    with pytest.raises(ck.CheckpointVerifyError, match="written by the JAX package"):
        ck.restore_checkpoint(path)
    with pytest.raises(ck.CheckpointVerifyError, match="written by the JAX package"):
        ck.restore_checkpoint(path, _lm_state())


# -- against the JAX package, by trajectory ---------------------------------------
def _batches(n=4, seed=69143):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        block = cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
        out.append((block[:, :-1], block[:, 1:]))
    return out


def _jax_resumed(tmp_path, lr):
    from distributed_machine_learning_tpu.train import checkpoint as jck
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig as RefAdamW
    from distributed_machine_learning_tpu.train.lm_step import make_lm_train_step as ref_step

    model, state = _jax_lm()
    init = jax.device_get(state.params)
    step = ref_step(model)
    losses = []
    for x, y in _batches()[:2]:
        state, loss = step(state, x, y)
        losses.append(float(loss))
    path = jck.save_checkpoint(tmp_path / "jax", state)
    state = jck.restore_checkpoint(path, abstract_state=_jax_lm()[1])
    if lr is not None:
        state = state.replace(config=RefAdamW(learning_rate=lr))
    for x, y in _batches()[2:]:
        state, loss = step(state, x, y)
        losses.append(float(loss))
    return init, losses, jax.device_get(state.params)


def _port_steps(state, batches):
    step = make_lm_train_step(state.model)
    losses = []
    for x, y in batches:
        state, loss = step(state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("lr", [None, 1e-3], ids=["same-lr", "new-lr"])
def test_save_restore_trajectory_matches_jax(tmp_path, lr):
    """Converted weights: 2 steps, save, restore into a fresh state (with a
    new learning rate on resume when asked), 2 more, in both packages; the
    port's losses and parameters against JAX's.  With the rate unchanged
    the resumed run also equals the port's 4 straight steps bit for bit."""
    init, want_losses, want_params = _jax_resumed(tmp_path, lr)
    state, losses = _port_steps(_lm_state(init), _batches()[:2])
    path = ck.save_checkpoint(tmp_path / "port", state)
    resumed = ck.restore_checkpoint(path, _lm_state(seed=9), files_verified=False)
    assert resumed.step == 2
    if lr is not None:
        resumed.config = AdamWConfig(learning_rate=lr)
    resumed, more = _port_steps(resumed, _batches()[2:])
    np.testing.assert_allclose(losses + more, want_losses, rtol=LOSS_RTOL)
    got = resumed.model.state_dict()
    for name, want in flax_to_state_dict(want_params).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    if lr is None:
        straight, _ = _port_steps(_lm_state(init), _batches())
        _assert_bitwise(_leaves(resumed), _leaves(straight))


def test_generate_from_checkpoint_matches_jax_cli(tmp_path, capsys):
    """The same weights checkpointed by each package: the port's
    ``cli.generate --ckpt-dir`` prints the same greedy text as JAX's on its
    own checkpoint (f32, byte-level vocab)."""
    from distributed_machine_learning_tpu.cli import generate as jgen
    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.train import checkpoint as jck
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig as RefAdamW
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    from distributed_machine_learning_tpu_torch.cli import generate as pgen

    shape = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
    jstate = init_lm_state(RefLM(vocab_size=257, **shape), seed=7, config=RefAdamW())
    jck.save_checkpoint(tmp_path / "jax", jstate)
    model = TransformerLM(vocab_size=257, **shape, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.device_get(jstate.params)))
    ck.save_checkpoint(tmp_path / "port", TrainState.create(model, AdamWConfig()))
    flags = ["--prompt", "Hello ", "--max-new-tokens", "12", "--temperature", "0",
             "--compute-dtype", "float32", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2"]
    jgen.main(["--ckpt-dir", str(tmp_path / "jax"), *flags])
    want = capsys.readouterr().out.splitlines()
    tokens = pgen.main(["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu", *flags])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == f"restored {tmp_path / 'port' / 'step_0'}"
    assert len(tokens) == 12 and got[-1] == want[-1]


# -- the CLIs ------------------------------------------------------------------
LM_FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "2", "--n-heads", "4",
            "--n-kv-heads", "2", "--vocab", "97", "--seq-len", str(SEQ),
            "--batch-size", str(BATCH)]


def test_lm_cli_saves_and_resumes(tmp_path, capsys):
    """``--ckpt-dir`` saves after training; ``--resume`` restores the newest
    valid checkpoint, trains on and saves the later step: the same
    parameters, bit for bit, as the uninterrupted run of the same batches
    (the stream restarts from its seed in each process, so the second run
    here sees batches 0-1 again: the reference's semantics)."""
    ckpts = str(tmp_path / "ck")
    cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--resume", "--ckpt-dir", ckpts])
    out = capsys.readouterr().out
    assert f"No checkpoint under {ckpts}; starting from scratch." in out
    assert f"Saved checkpoint to {ckpts}/step_1" in out
    cli_lm.main([*LM_FLAGS, "--max-iters", "2", "--resume", "--ckpt-dir", ckpts])
    out = capsys.readouterr().out
    assert f"Resumed from {ckpts}/step_1 (step 1)" in out
    assert f"Saved checkpoint to {ckpts}/step_3" in out
    args = cli_lm.make_parser().parse_args([*LM_FLAGS, "--max-iters", "1"])
    _, state, _, _ = cli_lm.build(args)
    state = ck.restore_checkpoint(ck.latest_checkpoint(ckpts), state)
    assert state.step == 3
    step, straight, place, _ = cli_lm.build(args)
    for x, y in [*_batches(1, seed=cli_lm.SEED), *_batches(2, seed=cli_lm.SEED)]:
        step(straight, *place(x, y))
    _assert_bitwise(_leaves(state), _leaves(straight))


def test_lm_cli_resume_refusals(tmp_path):
    with pytest.raises(ValueError, match="--resume requires --ckpt-dir"):
        cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--resume"])
    model = TransformerLM(**MODEL, device="cpu")
    ck.save_checkpoint(tmp_path, TrainState.create(model, SGDConfig()))
    with pytest.raises(ValueError, match="matching optimizer"):
        cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--resume", "--ckpt-dir",
                     str(tmp_path)])
    ck.save_checkpoint(tmp_path, _set_step(TrainState.create(model, AdamWConfig()), 4),
                       layout="pp-contiguous")
    with pytest.raises(ValueError, match="parameter layout 'pp-contiguous'"):
        cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--resume", "--ckpt-dir",
                     str(tmp_path)])


def test_lm_cli_resume_auto_restarts_from_the_checkpoint(tmp_path, monkeypatch, capsys):
    """``--resume auto``: an attempt that fails restarts from a fresh state
    restored from the newest checkpoint, up to ``--max-restarts``."""
    ckpts = str(tmp_path / "ck")
    cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--ckpt-dir", ckpts])
    real = cli_lm.train_epoch
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected crash")
        return real(*a, **k)

    monkeypatch.setattr(cli_lm, "train_epoch", flaky)
    capsys.readouterr()
    cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--ckpt-dir", ckpts, "--resume", "auto",
                 "--max-restarts", "1"])
    out = capsys.readouterr().out
    assert out.count(f"Resumed from {ckpts}/step_1 (step 1)") == 2
    assert "restart 1/1 from the latest complete checkpoint" in out
    assert f"Saved checkpoint to {ckpts}/step_2" in out
    monkeypatch.setattr(cli_lm, "train_epoch",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("down")))
    with pytest.raises(RuntimeError, match="down"):
        cli_lm.main([*LM_FLAGS, "--max-iters", "1", "--ckpt-dir", ckpts, "--resume",
                     "auto", "--max-restarts", "0"])


def test_run_attempts_policy():
    from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
    from distributed_machine_learning_tpu_torch.runtime.supervisor import run_attempts

    events, seen = FaultEvents(), []

    def attempt(i):
        seen.append(i)
        if i < 2:
            raise OSError("flaky")
        return "done"

    assert run_attempts(attempt, max_restarts=2, events=events) == "done"
    assert seen == [0, 1, 2] and events.restarts == 2
    with pytest.raises(OSError):
        run_attempts(lambda i: (_ for _ in ()).throw(OSError("x")), max_restarts=1)
    with pytest.raises(KeyboardInterrupt):
        run_attempts(lambda i: (_ for _ in ()).throw(KeyboardInterrupt()), max_restarts=3)
    with pytest.raises(ValueError):
        run_attempts(lambda i: None, max_restarts=-1)


def test_generate_cli_needs_weights_and_names_unported_layouts(tmp_path):
    from distributed_machine_learning_tpu_torch.cli import generate as pgen

    with pytest.raises(ValueError, match="--ckpt-dir .* or --random-init"):
        pgen.main(["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        pgen.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    # A pipeline layout is unstacked on restore: the same parameters as the
    # per-layer checkpoint of the same weights, and the same greedy tokens.
    from distributed_machine_learning_tpu_torch.parallel.pipeline import stack_lm_params
    from distributed_machine_learning_tpu_torch.train.checkpoint import HostState

    state = _lm_state(seed=4)
    flags = ["--device", "cpu", "--d-model", "64", "--n-layers", "2", "--n-heads", "4",
             "--n-kv-heads", "2", "--vocab", "97", "--max-new-tokens", "6",
             "--temperature", "0", "--compute-dtype", "float32"]
    ck.save_checkpoint(tmp_path / "plain", state)
    params = {k: p.detach().clone() for k, p in state.params.items()}
    ck.save_checkpoint(tmp_path / "stacked", HostState(
        params=stack_lm_params(params, 2), momentum={}, batch_stats={}, step=0,
        config=state.config), layout="pp-contiguous")
    want = pgen.restore_lm_params(str(tmp_path / "plain"), say=lambda _: None)
    got = pgen.restore_lm_params(str(tmp_path / "stacked"), say=lambda _: None)
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert (pgen.main([*flags, "--ckpt-dir", str(tmp_path / "stacked")])
            == pgen.main([*flags, "--ckpt-dir", str(tmp_path / "plain")]))


# -- multi-rank ----------------------------------------------------------------
def _lm_rank(rank, world, init_method, flags):
    """One rank of ``cli.lm``'s run, counting the state-dir writes it makes
    and keeping the state as restored (before training) when resuming."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    writes, restored = [], {}
    real_write, real_resume = ck._write_state_dir, cli_lm.resume

    def write(path, host):
        writes.append(path)
        return real_write(path, host)

    def resume(args, state):
        state = real_resume(args, state)
        restored.update({k: v.numpy().copy() for k, v in _leaves(state).items()})
        return state

    ck._write_state_dir, cli_lm.resume = write, resume
    args = cli_lm.make_parser().parse_args([*flags, "--rank", str(rank)])
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        state = cli_lm.run(args, ctx)
    finally:
        ctx.shutdown()
    return writes, restored, {k: v.numpy() for k, v in _leaves(state).items()}


def test_lm_cli_world2_saves_on_rank0_and_every_rank_restores(tmp_path):
    """``cli.lm --parallel dp --num-nodes 2 --ckpt-dir``: rank 0 alone
    writes; ``--resume``: both ranks restore the saved state bit for bit
    and end equal."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    ckpts = str(tmp_path / "ck")
    flags = [*LM_FLAGS, "--parallel", "dp", "--num-nodes", "2", "--ckpt-dir", ckpts]
    first = spawn(_lm_rank, 2, ([*flags, "--max-iters", "2"],), timeout_s=300)
    assert [len(w) for w, _, _ in first] == [1, 0]
    saved = first[0][2]
    second = spawn(_lm_rank, 2, ([*flags, "--max-iters", "1", "--resume"],),
                   timeout_s=300)
    assert [len(w) for w, _, _ in second] == [1, 0]
    for _, restored, final in second:
        assert restored.keys() == saved.keys()
        for k, v in saved.items():
            assert restored[k].dtype == v.dtype and restored[k].tobytes() == v.tobytes(), k
        for k, v in second[0][2].items():
            assert final[k].tobytes() == v.tobytes(), k
    assert ck.restore_checkpoint(ck.latest_checkpoint(ckpts)).step == 3
