"""The port's train-to-serve deployment (runtime/deploy.py, cli/deploy.py)
on the CPU: the port-side scenarios of ``tests/test_deploy.py``.

``load_serving_weights`` restores a port checkpoint bit for bit, requantizes
it and re-verifies the f32 bytes the quantizer consumed (a tampered restore
and a corrupted checkpoint both fail, quarantined and counted); zero1/fsdp
checkpoints serve the dp checkpoint's weights bit for bit through the
model's parameters.  Over the port's fleet (router, replica workers, an
in-process hub or the file transport): the worker's drain-then-commit
swap, the watcher promoting and skipping a corrupt checkpoint, rollback on
a quality regression and on an SLO burn, a canary killed mid-swap, the
deployment in the status tools.  The engine's hot swap during active
decode: every completion decodes under one weights version, token for
token against JAX's ``generate()`` on the same converted weights (f32).
A controller deploying a trained checkpoint onto engine replicas through
``load_serving_weights`` and ``ContinuousEngine.swap_params`` (the card's
deploy leg, at the tiny size).  The CLI's exit status.
"""

from __future__ import annotations

import importlib.util
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli.deploy import (
    checksum_token,
    main as deploy_main,
    quality_probe,
    versioned_step,
    write_demo_checkpoint,
)
from distributed_machine_learning_tpu_torch.runtime import deploy as deploy_mod
from distributed_machine_learning_tpu_torch.runtime.deploy import (
    DeployConfig,
    DeployController,
    load_serving_weights,
    tree_digest,
)
from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
from distributed_machine_learning_tpu_torch.runtime.serving import (
    Overloaded,
    ServingConfig,
    ServingRouter,
)
from distributed_machine_learning_tpu_torch.runtime.serving_worker import (
    ServingWorkerConfig,
    start_worker_thread,
)
from distributed_machine_learning_tpu_torch.runtime.transport import (
    FileTransport,
    InProcHub,
    InProcTransport,
    TransportError,
)
from distributed_machine_learning_tpu_torch.telemetry import Telemetry
from distributed_machine_learning_tpu_torch.train import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAOS_BUDGET_S = 150.0


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demo(directory, step):
    return write_demo_checkpoint(str(directory), step=step, device="cpu")


def _corrupt(step_dir):
    """Flip a byte in the middle of the largest state file."""
    files = []
    for root, _, names in os.walk(os.path.join(step_dir, "state")):
        files += [os.path.join(root, n) for n in names]
    fp = max(files, key=os.path.getsize)
    with open(fp, "r+b") as f:
        f.seek(os.path.getsize(fp) // 2)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    ck.forget_validated(step_dir)


# -- load_serving_weights ---------------------------------------------------------
def test_load_serving_weights_dp_checkpoint(tmp_path):
    """dp save → serving load: the parameters bit for bit, the int8 twin's
    weights, and the meta row the transport's set_weights carries."""
    path = _demo(tmp_path, 7)
    events = FaultEvents()
    out = load_serving_weights(path, events=events)
    saved = ck.restore_checkpoint(path).params
    assert out["spec"].layout == "dp" and out["meta"]["layout"] == "dp"
    assert out["meta"]["step"] == 7 and out["meta"]["path"] == os.path.abspath(path)
    assert out["meta"]["digest"] == tree_digest(out["quantized"])
    assert len(out["meta"]["digest"]) == 64
    assert out["quantized"]["blocks.0.fc_in.w_q"].dtype == torch.int8
    for k, v in saved.items():
        assert torch.equal(out["params"][k], v), k
    assert events.ckpt_verify_failures == 0
    again = load_serving_weights(path)
    assert again["meta"]["digest"] == out["meta"]["digest"]


def test_post_requantize_digest_catches_tampered_restore(tmp_path, monkeypatch):
    """One element changed between the (passing) restore and the quantizer:
    the post-requantize check against the manifest's leaf sha256 fails,
    counted, the checkpoint quarantined."""
    path = _demo(tmp_path / "t", 3)
    real = deploy_mod.reshard_restore

    def tampered(p, world=1, events=None):
        state, spec = real(p, world=world, events=events)
        state.params["blocks.0.fc_in.weight"][0, 0] += 1.0
        return state, spec

    monkeypatch.setattr(deploy_mod, "reshard_restore", tampered)
    events = FaultEvents()
    with pytest.raises(ck.CheckpointVerifyError, match="post-requantize"):
        load_serving_weights(path, events=events)
    assert events.ckpt_verify_failures == 1
    assert ck.latest_checkpoint(tmp_path / "t") is None


def test_corrupt_checkpoint_never_reaches_serving(tmp_path):
    path = _demo(tmp_path / "t", 3)
    _corrupt(path)
    events = FaultEvents()
    with pytest.raises(ck.CheckpointVerifyError, match="failed file verification"):
        load_serving_weights(path, events=events)
    assert events.ckpt_verify_failures == 1
    assert ck.latest_checkpoint(tmp_path / "t") is None


def _flat_checkpoint(directory, layout: str, step: int = 3):
    """The demo model's state (``write_demo_checkpoint``'s weights) saved in
    a flat layout at world 2: the whole padded vectors, as a 2-rank run's
    gathered save writes them; returns (step dir, the model's parameters)."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.parallel.fsdp import shard_fsdp_state
    from distributed_machine_learning_tpu_torch.parallel.zero1 import shard_zero1_state
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm
    from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = TransformerLM(vocab_size=32, d_model=16, n_layers=1, n_heads=2, device="cpu")
    init_params(model, seed=step)
    template = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = TrainState.create(model, AdamWConfig())
    state.step = step
    shard = shard_zero1_state if layout == "zero1" else shard_fsdp_state
    flat, _, n = shard(state, Comm())
    path = ck.save_checkpoint(directory, flat, shard_spec=ShardSpec(layout, 1, n_elems=n))
    wide, spec = ck.reshard_restore(path, world=2)
    shutil.rmtree(directory)
    return ck.save_checkpoint(directory, wide, shard_spec=spec), template


@pytest.mark.parametrize("layout", ["zero1", "fsdp"])
def test_load_serving_weights_from_flat_layouts(tmp_path, layout):
    """zero1/fsdp checkpoints serve the dp path's weights: the flat vector's
    logical prefix unraveled through the model's parameters, bit for bit
    the dp checkpoint's, the same quantized digest; without a template it
    is refused in the reference's words; a byte flipped in the flat leaf
    after the save never reaches serving."""
    dp = load_serving_weights(_demo(tmp_path / "dp", 3))
    path, template = _flat_checkpoint(tmp_path / layout, layout)
    with pytest.raises(ValueError, match="needs template_params"):
        load_serving_weights(path)
    got = load_serving_weights(path, template)
    assert got["meta"]["layout"] == layout and got["meta"]["step"] == 3
    assert got["spec"].world == 1
    assert got["params"].keys() == dp["params"].keys()
    for k, v in dp["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert got["meta"]["digest"] == dp["meta"]["digest"]
    _corrupt(path)
    events = FaultEvents()
    with pytest.raises(ck.CheckpointVerifyError):
        load_serving_weights(path, template, events=events)
    assert events.ckpt_verify_failures == 1 and ck.quarantine_reason(path) is not None


def test_load_serving_weights_flat_post_requantize_check(tmp_path, monkeypatch):
    """The flat layouts' post-requantize check: a restore that hands the
    quantizer other bytes than the manifest's logical digest names fails,
    quarantined and counted."""
    path, template = _flat_checkpoint(tmp_path / "z", "zero1")
    real = deploy_mod.reshard_restore

    def tampered(*a, **k):
        state, spec = real(*a, **k)
        state.param_flat[0] += 1.0
        return state, spec

    monkeypatch.setattr(deploy_mod, "reshard_restore", tampered)
    events = FaultEvents()
    with pytest.raises(ck.CheckpointVerifyError, match="post-requantize"):
        load_serving_weights(path, template, events=events)
    assert events.ckpt_verify_failures == 1 and ck.quarantine_reason(path) is not None


# -- fleet plumbing --------------------------------------------------------------------
def _default_on_swap_for(rank):
    def on_swap(version, rec):
        return versioned_step(version)

    return on_swap


def _deploy_fleet(tmp_path, *, replicas, world, on_swap_for=None, telemetry_dir=None,
                  replica_timeout_s=2.0, micro_batch=2, service_time=0.0,
                  backend="inproc"):
    gang = str(tmp_path / "gang")
    if backend == "inproc":
        hub = InProcHub(mirror_dir=gang)
        make_tx = lambda: InProcTransport(hub)  # noqa: E731
    else:
        os.makedirs(gang, exist_ok=True)
        make_tx = lambda: FileTransport(gang)  # noqa: E731
    events = FaultEvents()
    tels = []
    router_tel = None
    if telemetry_dir:
        router_tel = Telemetry(telemetry_dir, instance="router", enabled=True)
        tels.append(router_tel)
    router = ServingRouter(
        make_tx(), ServingConfig(replicas=replicas, max_queue=64, micro_batch=micro_batch,
                                 replica_timeout_s=replica_timeout_s, poll_s=0.002),
        events=events, telemetry=router_tel)
    on_swap_for = on_swap_for or _default_on_swap_for
    wcfg = ServingWorkerConfig(heartbeat_interval=0.02, micro_batch=micro_batch)
    fleet = []
    for rank in range(world):
        stop = threading.Event()
        tel = None
        if telemetry_dir:
            tel = Telemetry(telemetry_dir, instance=f"replica{rank}", enabled=True)
            tels.append(tel)
        t, out = start_worker_thread(make_tx(), rank, versioned_step(0, service_time), stop,
                                     wcfg, on_swap=on_swap_for(rank), telemetry=tel)
        fleet.append((rank, stop, t, out))
    stop_router = threading.Event()
    rt = threading.Thread(target=router.run, args=(stop_router,), name="deploy-router",
                          daemon=True)
    rt.start()
    return {"make_tx": make_tx, "gang": gang, "events": events, "router": router,
            "fleet": fleet, "tels": tels, "stop_router": stop_router, "rt": rt}


def _teardown_fleet(f):
    verdict = f["router"].close()
    f["stop_router"].set()
    for _, stop, t, _ in f["fleet"]:
        stop.set()
        t.join(5.0)
    f["rt"].join(5.0)
    for tel in f["tels"]:
        tel.close()
    return verdict


def _wait_live(router, n, deadline_s=30.0):
    deadline = time.monotonic() + deadline_s
    while True:
        with router._lock:
            live = len(router._replicas)
        if live >= n:
            return
        assert time.monotonic() < deadline, "fleet never warmed up"
        time.sleep(0.01)


def _start_load(router, *, min_requests, done):
    """Sustained synthetic load until ``done`` is set and at least
    ``min_requests`` were admitted."""
    stop = threading.Event()
    counter = {"n": 0}

    def load():
        rng = 12345
        while not stop.is_set():
            if done.is_set() and counter["n"] >= min_requests:
                return
            rng = (1103515245 * rng + 12345) % (1 << 31)
            prompt = [1 + (rng >> s) % 13 for s in (3, 7, 11)][:1 + rng % 3]
            try:
                router.submit(prompt)
                counter["n"] += 1
            except Overloaded:
                time.sleep(0.002)

    t = threading.Thread(target=load, name="deploy-load", daemon=True)
    t.start()
    return t, stop, counter


def _controller(f, ckpt_dir, **over):
    """A controller over the fleet ``f``.  The canary slice is the canary's
    fair share (every Nth dispatch of N live replicas): a larger slice
    queues work on the canary, and its latency gate then judges the queue."""
    cfg = dict(checkpoint_dir=str(ckpt_dir), canary_replicas=1,
               canary_every_n=f["router"].cfg.replicas, canary_window=8,
               commit_timeout_s=10.0, judge_timeout_s=30.0, poll_s=0.005)
    cfg.update(over)
    return DeployController(f["make_tx"](), f["router"], DeployConfig(**cfg),
                            events=f["events"], quality_fn=quality_probe)


def _health_kinds(f):
    return [e.get("kind") for e in FileTransport(f["gang"]).snapshot()["health"]]


# -- the worker's swap seam and the deploy state machine -----------------------------
def test_worker_hot_swap_commits_and_versions_every_post(tmp_path):
    calls = []

    def on_swap_for(rank):
        def on_swap(version, rec):
            calls.append((rank, version, rec))
            return versioned_step(version)

        return on_swap

    f = _deploy_fleet(tmp_path, replicas=1, world=1, on_swap_for=on_swap_for)
    router, tx = f["router"], f["make_tx"]()
    try:
        _wait_live(router, 1)
        rid_old = router.submit([1, 2, 3])
        assert router.wait_idle(30.0), router.audit()
        tx.set_weights(0, 1, {"step": 5, "digest": "d" * 64})
        deadline = time.monotonic() + 10.0
        while True:
            rec = tx.read_serving(0).get("weights") or {}
            if int(rec.get("version", 0)) == 1:
                assert rec.get("pending") is None
                break
            assert time.monotonic() < deadline, rec
            time.sleep(0.005)
        rid_new = router.submit([4, 5])
        assert router.wait_idle(30.0), router.audit()
        assert router.result(rid_old)["version"] == 0
        new_rec = router.result(rid_new)
        assert new_rec["version"] == 1
        assert new_rec["result"] == [4, 5, checksum_token([4, 5])]
    finally:
        verdict = _teardown_fleet(f)
    assert verdict["exactly_once"], verdict
    (swap_rank, swap_version, swap_rec), = calls
    assert swap_rank == 0 and swap_version == 1
    assert swap_rec["pending"] == 1 and swap_rec["step"] == 5
    (_, _, _, out), = f["fleet"]
    assert out["swaps"] == 1 and out["weight_version"] == 1


def test_watcher_deploys_promotes_and_skips_corrupt(tmp_path, monkeypatch):
    """The promote arc through the watcher, then both bad-checkpoint paths:
    on-disk corruption quarantined inside the chain walk (fleet untouched),
    a load-time verify failure surfaced as ``deploy_verify_failed``; the
    next good step deploys."""
    ckpts = tmp_path / "ckpts"
    f = _deploy_fleet(tmp_path, replicas=3, world=3)
    router, events = f["router"], f["events"]
    ctl = _controller(f, ckpts)
    done = threading.Event()
    lt, lstop, _ = _start_load(router, min_requests=60, done=done)
    try:
        _wait_live(router, 3)
        assert ctl.poll_once() is None  # empty dir
        _demo(ckpts, 100)
        out = ctl.poll_once()
        assert out["outcome"] == "promoted", out
        assert out["step"] == 100
        assert out["canary"]["count"] >= 8 and out["canary"]["bad"] == 0
        assert ctl.state == "promoted" and ctl.deployed_version == 1
        assert ctl.deployed_meta["step"] == 100
        assert list(ctl.loaded) == [1]
        assert ctl.poll_once() is None  # the same step is not redeployed
        assert set(router.audit()["weight_versions"].values()) == {1}
        assert (events.weight_swaps, events.canary_promotions, events.canary_rollbacks) \
            == (3, 1, 0)
        assert [h["why"] for h in ctl.history] == ["canary", "promote", "promote"]
        bad = _demo(ckpts, 150)
        _corrupt(bad)
        assert ctl.poll_once() is None
        assert events.ckpt_verify_failures >= 1
        assert set(router.audit()["weight_versions"].values()) == {1}
        real_load = deploy_mod.load_serving_weights

        def flaky(path, *, events=None):
            if os.path.basename(path) == "step_200":
                raise ck.CheckpointVerifyError("injected: post-requantize digest mismatch")
            return real_load(path, events=events)

        monkeypatch.setattr(deploy_mod, "load_serving_weights", flaky)
        _demo(ckpts, 200)
        out = ctl.poll_once()
        assert out["outcome"] == "verify_failed" and out["step"] == 200
        assert set(router.audit()["weight_versions"].values()) == {1}
        _demo(ckpts, 300)
        out = ctl.poll_once()
        assert out["outcome"] == "promoted" and out["step"] == 300
        assert set(router.audit()["weight_versions"].values()) == {2}
        done.set()
        lt.join(30.0)
        assert router.wait_idle(60.0), router.audit()
    finally:
        done.set()
        lstop.set()
        verdict = _teardown_fleet(f)
    assert verdict["exactly_once"], verdict
    summary = ctl.summary()
    assert summary["state"] == "promoted" and summary["deployed_version"] == 2
    assert summary["swaps"] == 6
    assert [d["outcome"] for d in summary["deploys"]] == ["promoted", "promoted"]
    kinds = _health_kinds(f)
    assert kinds.count("deploy_canary") == 2 and kinds.count("deploy_promote") == 2
    assert kinds.count("deploy_verify_failed") == 1 and kinds.count("weight_swap") == 6


def test_canary_quality_regression_rolls_back(tmp_path):
    def on_swap_for(rank):
        def on_swap(version, rec):
            return versioned_step(version, corrupt=version == 1)

        return on_swap

    ckpts = tmp_path / "ckpts"
    f = _deploy_fleet(tmp_path, replicas=3, world=3, on_swap_for=on_swap_for)
    router, events = f["router"], f["events"]
    ctl = _controller(f, ckpts)
    done = threading.Event()
    lt, lstop, _ = _start_load(router, min_requests=60, done=done)
    try:
        _wait_live(router, 3)
        _demo(ckpts, 100)
        out = ctl.poll_once()
        assert out["outcome"] == "rolled_back", out
        assert "quality regression" in out["reason"]
        assert out["to_version"] == 0 and out["unrecovered"] == []
        assert ctl.state == "rolled_back" and ctl.deployed_version == 0
        assert ctl.loaded == {}
        assert set(router.audit()["weight_versions"].values()) == {0}
        assert (events.canary_rollbacks, events.canary_promotions, events.weight_swaps) \
            == (1, 0, 2)
        assert [h["why"] for h in ctl.history] == ["canary", "rollback"]
        done.set()
        lt.join(30.0)
        assert router.wait_idle(60.0), router.audit()
    finally:
        done.set()
        lstop.set()
        verdict = _teardown_fleet(f)
    assert verdict["exactly_once"], verdict
    assert verdict["admitted"] == verdict["completed"]
    assert "deploy_rollback" in _health_kinds(f)


def test_canary_slo_burn_rolls_back(tmp_path):
    def on_swap_for(rank):
        def on_swap(version, rec):
            return versioned_step(version, service_time_s=0.02)

        return on_swap

    ckpts = tmp_path / "ckpts"
    f = _deploy_fleet(tmp_path, replicas=2, world=2, on_swap_for=on_swap_for)
    router, events = f["router"], f["events"]
    ctl = _controller(f, ckpts, canary_window=6, slo=("p99<=1ms",))
    done = threading.Event()
    lt, lstop, _ = _start_load(router, min_requests=40, done=done)
    try:
        _wait_live(router, 2)
        _demo(ckpts, 100)
        out = ctl.poll_once()
        assert out["outcome"] == "rolled_back", out
        assert out["reason"].startswith("SLO burn on canary: p99<=1ms")
        assert events.canary_rollbacks == 1
        assert set(router.audit()["weight_versions"].values()) == {0}
        done.set()
        lt.join(30.0)
        assert router.wait_idle(60.0), router.audit()
    finally:
        done.set()
        lstop.set()
        verdict = _teardown_fleet(f)
    assert verdict["exactly_once"], verdict


def test_deployment_renders_in_status_tools_and_trace(tmp_path):
    """After a promote then a rollback over the file transport, the repo's
    serve_status, gang_status and trace_merge render the port's deployment
    history and weight_swap instants."""

    def on_swap_for(rank):
        def on_swap(version, rec):
            return versioned_step(version, corrupt=version == 2)

        return on_swap

    ckpts = tmp_path / "ckpts"
    teldir = str(tmp_path / "telemetry")
    f = _deploy_fleet(tmp_path, replicas=2, world=2, backend="file",
                      on_swap_for=on_swap_for, telemetry_dir=teldir)
    router = f["router"]
    ctl = _controller(f, ckpts)
    done = threading.Event()
    lt, lstop, _ = _start_load(router, min_requests=40, done=done)
    try:
        _wait_live(router, 2)
        _demo(ckpts, 100)
        assert ctl.poll_once()["outcome"] == "promoted"
        _demo(ckpts, 200)
        assert ctl.poll_once()["outcome"] == "rolled_back"
        done.set()
        lt.join(30.0)
        assert router.wait_idle(60.0), router.audit()
    finally:
        done.set()
        lstop.set()
        verdict = _teardown_fleet(f)
    assert verdict["exactly_once"], verdict
    serve_status = _load_tool("serve_status")
    status = serve_status.collect(f["gang"], teldir)
    dep = status["deployment"]
    assert dep["state"] == "rolled_back"
    assert dep["promotions"] == 1 and dep["rollbacks"] == 1 and len(dep["swaps"]) >= 3
    rendered = serve_status.render(status)
    assert "Continuous deployment" in rendered and "weights v1" in rendered
    assert "rollback" in rendered and "quality regression" in rendered
    gang_status = _load_tool("gang_status")
    grendered = gang_status.render(gang_status.collect(f["gang"], teldir))
    assert "swap" in grendered and "rollback" in grendered
    trace_merge = _load_tool("trace_merge")
    merged, _ = trace_merge.merge_traces(teldir)
    swaps = [e for e in merged["traceEvents"] if e.get("name") == "weight_swap"]
    assert len(swaps) >= 4
    assert all(e["pid"] >= trace_merge.SERVING_PID_BASE for e in swaps)


def test_chaos_replica_killed_mid_swap_rolls_back(tmp_path):
    """6 live replicas and a spare under load; the canary replica dies inside
    ``on_swap``: the commit times out and the deploy rolls back, the fleet
    heals by promoting the spare, the next deploy promotes, and every
    admitted request completes exactly once."""
    t_start = time.monotonic()
    victim = {"rank": None}

    def on_swap_for(rank):
        def on_swap(version, rec):
            if version == 1 and rank == victim["rank"]:
                raise TransportError("injected: replica died mid-swap")
            return versioned_step(version)

        return on_swap

    ckpts = tmp_path / "ckpts"
    f = _deploy_fleet(tmp_path, replicas=6, world=7, on_swap_for=on_swap_for,
                      replica_timeout_s=0.4, micro_batch=4)
    router, events = f["router"], f["events"]
    ctl = _controller(f, ckpts, commit_timeout_s=1.0, judge_timeout_s=20.0)
    done = threading.Event()
    lt, lstop, _ = _start_load(router, min_requests=300, done=done)
    try:
        _wait_live(router, 6)
        deadline = time.monotonic() + 30.0
        while router.completed < 30:
            assert time.monotonic() < deadline, "fleet never warmed up"
            time.sleep(0.01)
        victim["rank"] = min(router.audit()["weight_versions"])
        _demo(ckpts, 100)
        out = ctl.poll_once()
        assert out["outcome"] == "rolled_back", out
        assert "failed to commit v1" in out["reason"] and out["unrecovered"] == []
        assert events.canary_rollbacks == 1 and events.weight_swaps == 0
        deadline = time.monotonic() + 30.0
        while events.replica_evictions < 1 or len(router.audit()["weight_versions"]) < 6:
            assert time.monotonic() < deadline, router.audit()
            time.sleep(0.01)
        live = router.audit()["weight_versions"]
        assert victim["rank"] not in live and set(live.values()) == {0}
        _demo(ckpts, 200)
        out = ctl.poll_once()
        assert out["outcome"] == "promoted", out
        assert set(router.audit()["weight_versions"].values()) == {2}
        assert events.canary_promotions == 1 and events.weight_swaps == 6
        done.set()
        lt.join(60.0)
        assert router.wait_idle(60.0), router.audit()
    finally:
        done.set()
        lstop.set()
        verdict = _teardown_fleet(f)
    assert verdict["exactly_once"], verdict
    assert verdict["admitted"] == verdict["completed"] >= 300
    assert verdict["unknown_results"] == 0
    assert verdict["evictions"] >= 1 and verdict["promotions"] >= 7
    kinds = _health_kinds(f)
    assert "deploy_rollback" in kinds and "deploy_promote" in kinds
    assert time.monotonic() - t_start < CHAOS_BUDGET_S


# -- engine replicas ---------------------------------------------------------------
ENGINE_LM = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2)
MAX_NEW = 8


class _Ref:
    """JAX's model, two weight sets, and memoised ``generate()`` streams."""

    def __init__(self):
        from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM

        self.model = RefLM(**ENGINE_LM)
        self.params = [jax.device_get(self.model.init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
            for seed in (0, 7)]
        self._streams = {}

    def state_dict(self, which):
        from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

        return flax_to_state_dict(self.params[which])

    def stream(self, which, prompt):
        from distributed_machine_learning_tpu.inference.generate import generate

        key = (which, tuple(prompt))
        if key not in self._streams:
            out = generate(self.model, self.params[which], np.asarray([prompt], np.int32),
                           MAX_NEW)
            self._streams[key] = np.asarray(out)[0].tolist()
        return self._streams[key]


@pytest.fixture(scope="module")
def ref():
    return _Ref()


def _engine(sd):
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM

    model = TransformerLM(**ENGINE_LM, device="cpu")
    model.load_state_dict(sd)
    engine = ContinuousEngine(model, EngineConfig(max_lanes=2, block_size=4, num_blocks=32,
                                                  max_len=16, max_new=MAX_NEW,
                                                  levers=("latency",)), device="cpu")
    engine.warmup(prompt_lens=(3,))
    return engine


def test_engine_hot_swap_during_active_decode_no_mixing(tmp_path, ref):
    """A version staged while sequences are mid-decode waits for the engine
    drain: nothing drops, and every completion equals JAX's ``generate()``
    under exactly one of the two weight sets, the one its version names."""
    engine = _engine(ref.state_dict(0))
    new_weights = ref.state_dict(1)
    swap_calls = []

    def on_swap(version, rec):
        swap_calls.append((version, engine.in_flight()))
        engine.swap_params(new_weights, version=version)

    hub = InProcHub(mirror_dir=str(tmp_path / "gang"))
    make_tx = lambda: InProcTransport(hub)  # noqa: E731
    router = ServingRouter(make_tx(), ServingConfig(replicas=1, micro_batch=4, poll_s=0.002))
    stop = threading.Event()
    t, out = start_worker_thread(make_tx(), 0, None, stop,
                                 ServingWorkerConfig(heartbeat_interval=0.02, micro_batch=4),
                                 on_swap=on_swap, engine=engine)
    stop_router = threading.Event()
    rt = threading.Thread(target=router.run, args=(stop_router,), daemon=True)
    rt.start()
    try:
        _wait_live(router, 1)
        prompts = {}
        for i in range(6):
            p = [1 + i, 2, 3]
            prompts[router.submit(list(p))] = p
        deadline = time.monotonic() + 60.0
        while engine.in_flight() == 0:
            assert time.monotonic() < deadline, "engine never started"
            time.sleep(0.002)
        tx = make_tx()
        tx.set_weights(0, 1, {"step": 5, "digest": "d" * 64})
        while int((tx.read_serving(0).get("weights") or {}).get("version", 0) or 0) != 1:
            assert time.monotonic() < deadline, "commit never landed"
            time.sleep(0.005)
        late = {}
        for i in range(3):
            p = [9 + i, 2, 3]
            late[router.submit(list(p))] = p
        assert router.wait_idle(60.0), router.audit()
        seen = set()
        for rid, p in {**prompts, **late}.items():
            entry = router.result(rid)
            assert entry is not None and entry["state"] == "done"
            v = entry["version"]
            seen.add(v)
            assert entry["result"] == ref.stream(v, p), f"{rid} mixed weight versions (v{v})"
        assert all(router.result(rid)["version"] == 1 for rid in late)
        assert seen == {0, 1}
    finally:
        verdict = router.close()
        stop_router.set()
        stop.set()
        t.join(10.0)
        rt.join(10.0)
    assert verdict["exactly_once"], verdict
    assert swap_calls == [(1, 0)]  # the fence held: on_swap saw a drained engine
    assert out["swaps"] == 1 and out["aborted"] == 0
    assert engine.in_flight() == 0 and engine.queued() == 0
    engine.allocator.check_invariants()


def test_controller_deploys_a_checkpoint_onto_engine_replicas(tmp_path, ref):
    """Two engine replicas and a spare serve weight set 0; a checkpoint of
    weight set 1 (a port TrainState) is deployed by the controller through
    ``load_serving_weights`` and ``swap_params``: promoted, exactly once,
    every completion carries one version and JAX's tokens for it, and every
    request submitted after the promotion carries the new version."""
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = TransformerLM(**ENGINE_LM, device="cpu")
    model.load_state_dict(ref.state_dict(1))
    ckpts = tmp_path / "ckpts"
    state = TrainState.create(model, AdamWConfig())
    state.step = 4
    ck.save_checkpoint(ckpts, state)
    engines = [_engine(ref.state_dict(0)) for _ in range(3)]
    hub = InProcHub()
    make_tx = lambda: InProcTransport(hub)  # noqa: E731
    events = FaultEvents()
    router = ServingRouter(make_tx(), ServingConfig(replicas=2, max_queue=64, micro_batch=2,
                                                    poll_s=0.002), events=events)
    ctl = DeployController(make_tx(), router,
                           DeployConfig(checkpoint_dir=str(ckpts), canary_every_n=2,
                                        canary_window=4, commit_timeout_s=30.0,
                                        judge_timeout_s=60.0, poll_s=0.005),
                           events=events)

    def on_swap_for(engine):
        def on_swap(version, rec):
            assert rec["path"] == ctl.loaded[version]["meta"]["path"]
            engine.swap_params(ctl.loaded[version]["params"], version=version)
        return on_swap

    stops = [threading.Event() for _ in engines]
    workers = [start_worker_thread(make_tx(), rank, None, stops[rank],
                                   ServingWorkerConfig(heartbeat_interval=0.02, micro_batch=2),
                                   on_swap=on_swap_for(e), engine=e)
               for rank, e in enumerate(engines)]
    stop_router = threading.Event()
    rt = threading.Thread(target=router.run, args=(stop_router,), daemon=True)
    rt.start()
    prompts: dict = {}
    done = threading.Event()

    def load():
        i = 0
        while not done.is_set():
            p = [1 + i % 13, 2, 3]
            try:
                prompts[router.submit(list(p))] = p
                i += 1
            except Overloaded:
                pass
            time.sleep(0.005)

    lt = threading.Thread(target=load, daemon=True)
    try:
        _wait_live(router, 2)
        lt.start()
        out = ctl.poll_once()
        assert out["outcome"] == "promoted", out
        assert out["step"] == 4
        done.set()
        lt.join(10.0)
        assert router.wait_idle(60.0), router.audit()
        late = {}
        for i in range(4):
            p = [20 + i % 10, 5, 6]
            late[router.submit(list(p))] = p
        assert router.wait_idle(60.0), router.audit()
        for rid, p in {**prompts, **late}.items():
            entry = router.result(rid)
            assert entry["state"] == "done" and entry["version"] in (0, 1)
            assert entry["result"] == ref.stream(entry["version"], p), rid
        assert all(router.result(rid)["version"] == 1 for rid in late)
    finally:
        done.set()
        verdict = router.close()
        stop_router.set()
        for s in stops:
            s.set()
        for t, _ in workers:
            t.join(10.0)
        rt.join(10.0)
    assert verdict["exactly_once"], verdict
    assert (events.canary_promotions, events.canary_rollbacks, events.weight_swaps) == (1, 0, 2)


def test_deploy_cli_exit_status(capsys):
    assert deploy_main(["--device", "cpu", "--replicas", "4", "--requests", "120",
                        "--deploys", "2"]) == 0
    out = capsys.readouterr().out
    assert "deploy 1: promoted" in out and "deploy 2: promoted" in out
    assert "exactly-once audit: PASS" in out
    assert deploy_main(["--device", "cpu", "--replicas", "4", "--requests", "120",
                        "--deploys", "2", "--inject", "regression@2"]) == 0
    out = capsys.readouterr().out
    assert "deploy 2: rolled_back (quality regression" in out
    assert "(1 promoted, 1 rolled back" in out and "exactly-once audit: PASS" in out
    assert deploy_main(["--device", "cpu", "--inject", "bogus"]) == 2
