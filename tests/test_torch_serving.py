"""The port's serving fleet vs the JAX package's, on the CPU.

Every scenario runs on both packages (router, replica workers, transports
of each package's own) and compares what is deterministic: the verdict's
admitted, completed, rejected, ``exactly_once``, duplicates, promotions,
evictions and drains (never latencies), the workers' summaries, and the
states the transports read back.  The engine fleet runs the port's
router, worker and continuous engine over weights converted from the JAX
model (f32, latency lever) beside JAX's fleet on the same requests: every
rid's tokens must be equal.  Also: the lever stamping of a regime-aware
router, the CLI (exit status = the audit and the SLO verdict; ``--engine``
refuses to run without a card unless ``--device cpu``), and the repo's
status tools reading the port's artifacts.
"""

import importlib
import importlib.util
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "distributed_machine_learning_tpu", "distributed_machine_learning_tpu_torch"
VERDICT_KEYS = ("admitted", "completed", "rejected", "exactly_once",
                "duplicates_discarded", "promotions", "evictions", "drains")


def _api(pkg: str) -> SimpleNamespace:
    serving = importlib.import_module(f"{pkg}.runtime.serving")
    worker = importlib.import_module(f"{pkg}.runtime.serving_worker")
    transport = importlib.import_module(f"{pkg}.runtime.transport")
    faults = importlib.import_module(f"{pkg}.runtime.faults")
    return SimpleNamespace(
        pkg=pkg, Router=serving.ServingRouter, Config=serving.ServingConfig,
        Overloaded=serving.Overloaded, WorkerConfig=worker.ServingWorkerConfig,
        start_worker=worker.start_worker_thread, tr=transport,
        Hub=transport.InProcHub, Tx=transport.InProcTransport,
        FaultEvents=faults.FaultEvents)


def _both(scenario, *args):
    """``scenario(api, *args)`` on the JAX package, then on the port."""
    return scenario(_api(REF), *args), scenario(_api(PORT), *args)


def _verdict(v: dict) -> dict:
    return {k: v[k] for k in VERDICT_KEYS}


def _step(prompts):
    return [list(p) + [sum(p) % 97] for p in prompts]


def _slow_step(delay_s):
    def step(prompts):
        time.sleep(delay_s)
        return _step(prompts)
    return step


def _spare(tx, rank):
    tx.announce_join(rank, {"rank": rank, "spare": True, "kind": "serving",
                            "time": time.time()})


# ---------------------------------------------------------------------------
# Router policy (no threads)
# ---------------------------------------------------------------------------


def _admission(a):
    events = a.FaultEvents()
    router = a.Router(a.Tx(a.Hub()), a.Config(max_queue=2), events=events)
    router.submit([1])
    router.submit([2])
    with pytest.raises(a.Overloaded, match="queue full"):
        router.submit([3])
    dup = a.Router(a.Tx(a.Hub()), a.Config(max_queue=8))
    dup.submit([1], rid="a")
    with pytest.raises(ValueError, match="duplicate rid"):
        dup.submit([2], rid="a")
    dup.close()
    with pytest.raises(a.Overloaded, match="closed"):
        dup.submit([3])
    return (_verdict(router.audit()), events.request_rejects,
            _verdict(dup.audit()), router.latency.bounds)


def test_admission_control_duplicates_and_closed_router_match_jax():
    ref, port = _both(_admission)
    assert port == ref
    assert port[0]["admitted"] == 2 and port[0]["rejected"] == 1 and port[1] == 1


def _straggler(a):
    hub = a.Hub()
    tx = a.Tx(hub)
    events = a.FaultEvents()
    router = a.Router(a.Tx(hub), a.Config(replicas=3, replica_timeout_s=60.0),
                      events=events)
    for rank in range(4):
        _spare(tx, rank)
    router.pump()
    live0 = sorted(router._replicas)
    for _ in range(9):
        router.submit([1, 2])
    router.pump()
    for rank in range(3):
        for req in tx.take_requests(rank, 8):
            req["events"].append({"stage": "computed", "by": f"replica{rank}",
                                  "dt": 0.5 if rank == 2 else 0.05})
            assert tx.post_result(rank, req["epoch"], {
                "rid": req["rid"], "output": req["prompt"], "events": req["events"]})
    for _ in range(4):
        router.pump()
    kinds = [(e.get("kind"), e.get("rank")) for e in tx.read_health_events()]
    return (live0, sorted(router._replicas), _verdict(router.audit()),
            events.replica_evictions, tx.read_serving(2)["role"], kinds)


def test_straggler_replaced_by_a_spare_matches_jax():
    ref, port = _both(_straggler)
    assert port == ref
    assert port[1] == [0, 1, 3] and port[2]["evictions"] == 1 and port[4] == "spare"


def _late_result(a):
    hub = a.Hub()
    tx = a.Tx(hub)
    router = a.Router(a.Tx(hub), a.Config(replicas=1, replica_timeout_s=60.0))
    _spare(tx, 0)
    router.pump()
    rid = router.submit([1, 2])
    router.pump()
    reqs = tx.take_requests(0, 8)
    posted = tx.post_result(0, reqs[0]["epoch"], {"rid": rid, "output": [9]})
    with router._lock:
        router._evict_locked(0, "presumed dead", time.monotonic())
    state_after_evict = router.result(rid)["state"]
    _spare(tx, 1)
    router.pump()
    return (posted, state_after_evict, router.result(rid)["state"],
            tx.take_requests(1, 8), _verdict(router.audit()), router.wait_idle(1.0))


def test_late_result_after_requeue_is_not_redispatched_matches_jax():
    ref, port = _both(_late_result)
    assert port == ref
    assert port[1] == "queued" and port[2] == "done" and port[3] == []
    assert port[4]["exactly_once"] and port[4]["duplicates_discarded"] == 0


def _compaction(a):
    hub = a.Hub()
    tx = a.Tx(hub)
    router = a.Router(a.Tx(hub), a.Config(replicas=1, replica_timeout_s=60.0,
                                          retain_done=3))
    _spare(tx, 0)
    router.pump()
    rids = [router.submit([i]) for i in range(8)]
    while router.completed < 8:
        router.pump()
        for req in tx.take_requests(0, 8):
            tx.post_result(0, req["epoch"], {"rid": req["rid"], "output": [0]})
    tx.post_result(0, 0, {"rid": rids[0], "output": [0]})  # very late duplicate
    router.pump()
    v = router.audit()
    return _verdict(v), v["compacted"], v["unknown_results"], router.result(rids[0])


def test_ledger_compaction_and_late_duplicates_match_jax():
    ref, port = _both(_compaction)
    assert port == ref
    assert port[0]["duplicates_discarded"] == 1 and port[1] == 5 and port[3] is None


# ---------------------------------------------------------------------------
# Workers (threads)
# ---------------------------------------------------------------------------


def _wait(pred, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.003)


def _promotion(a):
    hub = a.Hub()
    admin = a.Tx(hub)
    stop = threading.Event()
    restored = []
    t, out = a.start_worker(a.Tx(hub), 5, _step, stop,
                            a.WorkerConfig(heartbeat_interval=0.01),
                            prefetch_fn=lambda: 42, on_restore=restored.append)
    _wait(lambda: 5 in admin.read_joins(), "spare never announced")
    prefetched = admin.read_joins()[5]["prefetched_step"]
    admin.set_serving_role(5, "live")
    admin.push_request(5, {"rid": "q1", "prompt": [2, 3], "epoch": 0})
    results = []
    _wait(lambda: results.extend(admin.take_results(8)) or results, "no result")
    admin.retire_replica(5)
    admin.consume_join(5)
    _wait(lambda: 5 in admin.read_joins(), "never re-spared")
    stop.set()
    t.join(5.0)
    return (prefetched, restored, [(r["rid"], r["output"], r["epoch"]) for r in results],
            {k: out[k] for k in ("served", "fenced", "repushed", "restores")},
            admin.read_serving(5)["role"])


def test_worker_promotion_restores_and_demotion_respares_matches_jax():
    ref, port = _both(_promotion)
    assert port == ref
    assert port[1] == [42] and port[3]["restores"] == 1 and port[3]["served"] == 1


def _newer_epoch(a):
    class StaleRead(a.Tx):
        """The first live read: retire + re-promote the rank and push a
        request of the NEW epoch, then hand back the stale view."""

        def __init__(self, hub, admin, rank):
            super().__init__(hub)
            self._admin, self._rank, self._raced = admin, rank, False

        def read_serving(self, replica=None):
            state = super().read_serving(replica)
            if not self._raced and replica == self._rank and state.get("role") == "live":
                self._raced = True
                self._admin.retire_replica(self._rank)
                self._admin.set_serving_role(self._rank, "live")
                e = self._admin.read_serving(self._rank)["epoch"]
                self._admin.push_request(self._rank, {"rid": "z", "prompt": [1, 2], "epoch": e})
            return state

    hub = a.Hub()
    admin = a.Tx(hub)
    stop = threading.Event()
    t, out = a.start_worker(StaleRead(hub, admin, 4), 4, _step, stop,
                            a.WorkerConfig(heartbeat_interval=0.01))
    _wait(lambda: 4 in admin.read_joins(), "spare never announced")
    admin.set_serving_role(4, "live")
    results = []
    _wait(lambda: results.extend(admin.take_results(8)) or results, "z never served")
    stop.set()
    t.join(5.0)
    return ([(r["rid"], r["epoch"]) for r in results],
            {k: out[k] for k in ("served", "fenced", "repushed", "restores")})


def test_newer_epoch_request_is_repushed_matches_jax():
    ref, port = _both(_newer_epoch)
    assert port == ref
    assert port == ([("z", 1)], {"served": 1, "fenced": 0, "repushed": 1, "restores": 2})


def _submit_all(a, router, prompts, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    for p in prompts:
        while True:
            try:
                router.submit(p)
                break
            except a.Overloaded:
                assert time.monotonic() < deadline, "fleet stopped absorbing load"
                time.sleep(0.002)


def _prompts(n, seed=12345):
    """The serve CLI's request stream: 1-3 tokens in 1..13."""
    out, rng = [], seed
    for _ in range(n):
        rng = (1103515245 * rng + 12345) % (1 << 31)
        out.append([1 + (rng >> s) % 13 for s in (3, 7, 11)][:1 + rng % 3])
    return out


def _fleet(a, hub, world, step_fn):
    fleet = []
    for rank in range(world):
        stop = threading.Event()
        t, out = a.start_worker(a.Tx(hub), rank, step_fn, stop,
                                a.WorkerConfig(heartbeat_interval=0.02))
        fleet.append((rank, stop, t, out))
    return fleet


def _run_router(router):
    stop = threading.Event()
    rt = threading.Thread(target=router.run, args=(stop,), daemon=True)
    rt.start()
    return stop, rt


def _shutdown(router, stop_router, rt, fleet):
    verdict = router.close()
    stop_router.set()
    for _, stop, t, _ in fleet:
        stop.set()
        t.join(5.0)
    rt.join(5.0)
    return verdict


def _drain(a):
    hub = a.Hub()
    events = a.FaultEvents()
    router = a.Router(a.Tx(hub), a.Config(replicas=2, max_queue=64, micro_batch=2,
                                          replica_timeout_s=30.0, poll_s=0.002),
                      events=events)
    fleet = _fleet(a, hub, 3, _slow_step(0.002))
    stop_router, rt = _run_router(router)
    try:
        _submit_all(a, router, _prompts(20))
        _wait(lambda: router.completed >= 5, "fleet never served")
        with router._lock:
            target = sorted(router._replicas)[0]
        first, again = router.drain(target), router.drain(target)
        _submit_all(a, router, _prompts(20, seed=7))
        assert router.wait_idle(30.0), router.audit()
        _wait(lambda: router.drains_done >= 1, "drain never done")
    finally:
        verdict = _shutdown(router, stop_router, rt, fleet)
    tx = a.Tx(hub)
    demote = [e["why"] for e in tx.read_health_events() if e.get("kind") == "serve_demote"]
    return (_verdict(verdict), events.drains, first, again, tx.read_serving(target)["role"],
            demote)


def test_graceful_drain_with_zero_drops_matches_jax():
    ref, port = _both(_drain)
    assert port == ref
    v = port[0]
    assert v["exactly_once"] and v["admitted"] == v["completed"] == 40
    assert v["drains"] == 1 and v["evictions"] == 0 and port[2:] == (True, False, "spare",
                                                                      ["drained"])


def _kill_two(a, tmp_path):
    hub = a.Hub(mirror_dir=str(tmp_path / f"gang-{a.pkg}"))
    events = a.FaultEvents()
    router = a.Router(a.Tx(hub), a.Config(replicas=4, max_queue=96, micro_batch=4,
                                          replica_timeout_s=2.0, poll_s=0.002),
                      events=events)
    fleet = _fleet(a, hub, 6, _slow_step(0.002))
    stop_router, rt = _run_router(router)
    try:
        _submit_all(a, router, _prompts(24))
        _wait(lambda: router.completed >= 12 and len(router._replicas) == 4,
              "fleet never warmed up", 30.0)
        with router._lock:
            victims = sorted(router._replicas)[:2]
        for rank, stop, _, _ in fleet:
            if rank in victims:
                stop.set()
        _submit_all(a, router, _prompts(56, seed=99))
        assert router.wait_idle(60.0), router.audit()
        with router._lock:
            live = sorted(router._replicas)
    finally:
        verdict = _shutdown(router, stop_router, rt, fleet)
    return (_verdict(verdict), verdict["unknown_results"], events.replica_evictions,
            len(live), bool(set(victims) & set(live)))


def test_two_replicas_killed_mid_load_match_jax(tmp_path):
    ref, port = _both(_kill_two, tmp_path)
    assert port == ref
    v = port[0]
    assert v["exactly_once"] and v["admitted"] == v["completed"] == 80
    assert v["evictions"] == 2 and v["promotions"] == 6 and port[3:] == (4, False)


# ---------------------------------------------------------------------------
# Transports: one op script, three backends
# ---------------------------------------------------------------------------


def _strip(x):
    """Drop wall-clock stamps and op ids from what a transport reads back."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in ("time", "op_id", "t")}
    if isinstance(x, (list, tuple)):
        return [_strip(v) for v in x]
    if isinstance(x, set):
        return sorted(x)
    return x


def _op_script(a, backend, tmp_path):
    server = None
    if backend == "inproc":
        hub = a.Hub()
        make = lambda: a.tr.make_transport("inproc", hub=hub)  # noqa: E731
    elif backend == "file":
        gang = tmp_path / f"gang-{a.pkg}"
        gang.mkdir()
        make = lambda: a.tr.make_transport("file", gang_dir=str(gang))  # noqa: E731
    else:
        server = a.tr.TcpGangServer().start()
        make = lambda: a.tr.make_transport("tcp", address=server.address)  # noqa: E731
    tx, other = make(), make()
    out = []
    try:
        tx.publish_beat(0, {"rank": 0, "seq": 1})
        tx.publish_beat(1, {"rank": 1, "seq": 7})
        out.append(sorted((r, p) for r, (_, p) in other.read_beats().items()))
        tx.announce_join(2, {"rank": 2, "spare": True, "prefetched_step": 5})
        tx.announce_join(3, {"rank": 3, "spare": True})
        other.consume_join(3)
        out.append(other.read_joins())
        tx.write_restore_record(0, [3, 1, 2])
        out.append(other.read_restore_record(0))
        out.append(other.read_restore_record(9))
        tx.append_health_event("serve_promote", rank=2, epoch=1)
        tx.append_fault_entry({"index": 0, "kind": "kill_rank", "rank": 1})
        tx.append_consumed(1, {"step": 3, "ids": [4, 5]})
        out.append(other.read_health_events())
        out.append(other.read_fault_entries())
        out.append(other.read_consumed(1))
        # the serving plane: promote, dispatch, take, post (fenced and not),
        # weights, drain, retire
        tx.set_serving_role(2, "live")
        e = other.read_serving(2)["epoch"]
        for i in range(3):
            tx.push_request(2, {"rid": f"r{i}", "prompt": [i], "epoch": e,
                                "events": [{"stage": "queued", "by": "router", "dt": 0.1}],
                                "_mono_last": 1.0, "_mono_by": "router"})
        taken = other.take_requests(2, 2)
        out.append([(r["rid"], r["prompt"], [ev["stage"] for ev in r["events"]],
                     "_mono_last" in r) for r in taken])
        out.append(other.post_result(2, e, {"rid": "r0", "output": [0, 9],
                                            "events": taken[0]["events"]}))
        out.append(other.post_result(2, e + 5, {"rid": "r1", "output": [1]}))
        tx.set_weights(2, 3, {"ckpt": "step_3"})
        out.append(other.read_serving(2))
        out.append(other.commit_weights(2, 3))
        out.append(other.post_result(2, e, {"rid": "r1", "output": [1]}, version=2))
        out.append(other.post_result(2, e, {"rid": "r1", "output": [1]}, version=3))
        tx.set_drain(2, True)
        out.append(other.read_serving(2))
        out.append([(r["rid"], r["output"], r.get("version"), r.get("epoch"),
                     [ev["stage"] for ev in r.get("events", [])])
                    for r in tx.take_results(8)])
        out.append([r["rid"] for r in tx.retire_replica(2)])
        out.append(other.read_serving(2))
        out.append(other.post_result(2, e, {"rid": "r2", "output": [2]}))
        out.append(other.declare_abort("peer 1 dead", 0, peer=1))
        out.append(other.declare_abort("second", 1))
        out.append(tx.read_abort())
        tx.clear_gang_state()
        fresh = make()  # an inproc handle is bound to the cleared attempt
        out.append((fresh.read_beats(), fresh.read_abort(), fresh.read_restore_record(0)))
        fresh.close()
    finally:
        tx.close()
        other.close()
        if server is not None:
            server.stop()
    return _strip(out)


@pytest.mark.parametrize("backend", ["inproc", "file", "tcp"])
def test_transport_op_script_reads_back_like_jax(tmp_path, backend):
    ref, port = _both(_op_script, backend, tmp_path)
    assert port == ref
    assert port[8] is True and port[9] is False  # the epoch fence
    assert port[12] is False and port[13] is True  # the weights fence


def test_transports_agree_across_backends(tmp_path):
    """The serving plane reads back the same on every backend (the op
    script's results from the requests taken on)."""
    a, states = _api(PORT), {}
    for backend in ("inproc", "file", "tcp"):
        (tmp_path / backend).mkdir()
        states[backend] = _op_script(a, backend, tmp_path / backend)[7:]
    assert states["file"] == states["inproc"] == states["tcp"]


# ---------------------------------------------------------------------------
# The engine fleet
# ---------------------------------------------------------------------------

ENGINE_LM = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2)
ENGINE_CFG = dict(max_lanes=4, block_size=4, num_blocks=32, max_len=16, max_new=8)


@pytest.fixture(scope="module")
def engines():
    """JAX's tiny model and Flax weights, and the port model over them."""
    import jax
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM

    ref = RefLM(**ENGINE_LM)
    params = jax.device_get(ref.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))["params"])
    port = TransformerLM(**ENGINE_LM, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return ref, params, port


def _make_engines(a, lm, n, levers, **cfg):
    ref, params, port = lm
    cont = importlib.import_module(f"{a.pkg}.inference.continuous")
    ecfg = cont.EngineConfig(**{**ENGINE_CFG, **cfg}, levers=levers)
    out = []
    for _ in range(n):
        if a.pkg == REF:
            eng = cont.ContinuousEngine(ref, params, ecfg)
        else:
            eng = cont.ContinuousEngine(port, ecfg, device="cpu",
                                        lever_models=out[0].models if out else None)
        eng.warmup(prompt_lens=(1, 2, 3))
        out.append(eng)
    return out


def _engine_fleet(a, lm, prompts):
    hub = a.Hub()
    router = a.Router(a.Tx(hub), a.Config(replicas=2, max_queue=64, micro_batch=4,
                                          replica_timeout_s=30.0, poll_s=0.002))
    fleet = []
    for rank, eng in enumerate(_make_engines(a, lm, 3, ("latency",))):
        stop = threading.Event()
        t, out = a.start_worker(a.Tx(hub), rank, None, stop,
                                a.WorkerConfig(heartbeat_interval=0.02, micro_batch=4),
                                engine=eng)
        fleet.append((rank, stop, t, out))
    stop_router, rt = _run_router(router)
    try:
        rids = [router.submit(p) for p in prompts]
        assert router.wait_idle(60.0), router.audit()
        results = {rid: router.result(rid) for rid in rids}
    finally:
        verdict = _shutdown(router, stop_router, rt, fleet)
    levers = {ev["lever"] for r in results.values() for ev in r["events"]
              if ev["stage"] == "decode"}
    return ({rid: r["result"] for rid, r in results.items()}, _verdict(verdict), levers)


def test_engine_fleet_tokens_equal_jax_fleet(engines):
    prompts = _prompts(12)
    ref, port = _both(_engine_fleet, engines, prompts)
    assert port == ref
    tokens, verdict, levers = port
    assert verdict["exactly_once"] and verdict["completed"] == 12 and levers == {"latency"}
    for p, rid in zip(prompts, sorted(tokens, key=lambda r: int(r[1:]))):
        assert tokens[rid][:len(p)] == p and len(tokens[rid]) == len(p) + 8


def _regime_fleet(a, lm):
    sched_mod = importlib.import_module(f"{a.pkg}.runtime.scheduler")
    (engine,) = _make_engines(a, lm, 1, ("latency", "throughput"), max_lanes=2, max_new=6)
    sched = sched_mod.RegimeScheduler(sched_mod.RegimeConfig(thin_width=0, wide_width=2,
                                                             dwell_steps=1))
    hub = a.Hub()
    router = a.Router(a.Tx(hub), a.Config(replicas=1, micro_batch=4, poll_s=0.002,
                                          replica_timeout_s=30.0), scheduler=sched)
    stop = threading.Event()
    t, _ = a.start_worker(a.Tx(hub), 0, None, stop,
                          a.WorkerConfig(heartbeat_interval=0.02, micro_batch=4),
                          engine=engine)
    stop_router, rt = _run_router(router)
    try:
        _wait(lambda: router._replicas, "replica never joined", 60.0)
        rids = [router.submit([1 + i % 11, 2, 3]) for i in range(8)]
        assert router.wait_idle(60.0), router.audit()
        levers = set()
        for rid in rids:
            entry = router.result(rid)
            evs = [ev for ev in entry["events"] if ev.get("stage") == "decode"]
            assert entry["state"] == "done" and evs, rid
            levers.add(evs[-1]["lever"])
    finally:
        verdict = _shutdown(router, stop_router, rt, [(0, stop, t, None)])
    return levers, sched.flips >= 1, verdict["exactly_once"]


def test_router_stamps_fleet_regime_onto_engine_completions(engines):
    ref, port = _both(_regime_fleet, engines)
    assert port[0] >= {"throughput"} and port[0] <= {"latency", "throughput"}
    assert ref[0] >= {"throughput"}
    assert port[1:] == ref[1:] == (True, True)


# ---------------------------------------------------------------------------
# The CLI and the status tools
# ---------------------------------------------------------------------------


def _serve(*flags, timeout=240):
    """The port's serve CLI; a generous beat timeout, so a loaded host
    evicts no healthy replica (no scenario here kills one)."""
    return subprocess.run(
        [sys.executable, "-m", f"{PORT}.cli.serve", "--gang-transport", "inproc",
         "--timeout", "60", "--replica-timeout", "30", *flags],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""})


@pytest.mark.parametrize("engine", [False, True])
def test_cli_serve_inproc_passes(engine):
    res = _serve("--device", "cpu", "--replicas", "2", "--spares", "1",
                 "--requests", "30", "--drain-after", "8",
                 *(["--engine"] if engine else []))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "exactly-once audit: PASS" in res.stdout
    assert "2 replicas + 1 spares over inproc" in res.stdout
    assert "30/30 completed" in res.stdout and "1 drains" in res.stdout
    assert ("regime: " in res.stdout) == engine


def test_cli_serve_slo_verdict_gates_exit_status():
    bad = _serve("--device", "cpu", "--replicas", "2", "--spares", "0",
                 "--requests", "20", "--service-time", "0.02", "--slo", "p99<=1ms")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "exactly-once audit: PASS" in bad.stdout
    assert "slo p99<=1ms: FAIL" in bad.stdout
    assert "SLO objectives violated" in bad.stderr


def test_cli_serve_engine_refuses_a_missing_card():
    res = _serve("--engine", "--replicas", "1", "--spares", "0", "--requests", "2",
                 timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "PASS" not in res.stdout


def test_cli_engine_model_is_jax_shape_on_cpu_and_head_dim_32_on_card():
    from distributed_machine_learning_tpu_torch.cli import serve

    assert serve.engine_model_config("cpu") == ENGINE_LM
    card = serve.engine_model_config("cuda")
    assert card == {**ENGINE_LM, "d_model": 128}
    assert card["d_model"] // card["n_heads"] == 32


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("backend", ["inproc", "file"])
def test_status_tools_render_the_port_artifacts(tmp_path, backend):
    gang, teldir = str(tmp_path / "gang"), str(tmp_path / "telemetry")
    res = _serve("--device", "cpu", "--replicas", "2", "--spares", "1", "--requests", "12",
                 "--gang-transport", backend, "--gang-dir", gang, "--telemetry-dir", teldir,
                 "--slo", "p99<=30s")
    assert res.returncode == 0, res.stdout + res.stderr
    serve_status = _load_tool("serve_status")
    status = serve_status.collect(gang, teldir)
    assert len(status["requests"]) == 12
    assert {"queued", "dispatched", "computed", "completed"} <= set(status["stages"])
    rendered = serve_status.render(status)
    assert "Per-stage latency" in rendered and "Per-replica compute" in rendered
    rid = status["requests"][0]["rid"]
    pm = serve_status.render_postmortem(status, rid)
    assert pm is not None and f"Postmortem {rid}" in pm and "completed" in pm
    gang_status = _load_tool("gang_status")
    text = gang_status.render(gang_status.collect(gang, teldir))
    assert "Serving fleet" in text and "exactly-once: PASS" in text
    trace_merge = _load_tool("trace_merge")
    merged, counts = trace_merge.merge_traces(teldir)
    assert counts["router"] == 12 and {"replica0", "replica1"} & set(counts)
    flows = [e for e in merged["traceEvents"] if e.get("name") == "request_flow"]
    assert len(flows) == 2 * 12


def test_launch_state_survives_replica_threads():
    """Replicas are threads of one process launching at once: the launch
    counters and K5's per-stream counter buffers must lose no update
    under a tiny switch interval (more threads than cores)."""
    import torch

    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.ops import decode_attention as da

    threads, per = 4 * (os.cpu_count() or 1), 100
    key = (torch.device("cpu"), -12345)  # a stream id no caller uses
    got, start = [], threading.Barrier(threads)

    def hammer(i):
        start.wait(10.0)
        for j in range(per):
            build.count_launch("paged_attention")
            got.append(da._paged_counters(key[0], key[1], 256 + j * threads + i))

    before = build.launches["paged_attention"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=hammer, args=(i,)) for i in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60.0)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(old)
        installed = da._counters.pop(key)
    assert build.launches["paged_attention"] - before == threads * per
    kept = {id(installed)} | {id(b) for b in da._outgrown}
    assert all(id(b) in kept for b in got)  # no buffer handed out and then dropped
    assert installed.numel() == max(b.numel() for b in got)
    da._outgrown[:] = [b for b in da._outgrown if b.device.type != "cpu"]


def _election(a, tmp_path):
    coord = importlib.import_module(f"{a.pkg}.runtime.coordinator")
    hub = a.Hub()
    tx = a.Tx(hub)
    gang = tmp_path / a.pkg
    gang.mkdir()
    out = []
    for rank, steps in enumerate(([2, 4, 6], [4, 6, 8], [1, 4, 6])):
        tx.write_restore_record(rank, steps)
        coord.GangCoordinator(str(gang), rank=rank, world=3).record_valid_step(steps[-1])
    for ranks in (None, [0, 1], [2]):
        out.append(coord.elect_restore_step(None, 3, ranks=ranks, transport=tx))
        out.append(coord.elect_restore_step(str(gang), 3, ranks=ranks))
    out.append(coord.elect_restore_step(None, 4, transport=tx))  # rank 3: no record
    out.append(coord.enforce_restore_point(None, 4))
    return out


def test_restore_election_matches_jax(tmp_path):
    ref, port = _both(_election, tmp_path)
    assert port == ref
    assert port[:2] == [6, None] and port[-2:] == [None, []]


def test_unported_parts_raise_naming_their_items(tmp_path):
    from distributed_machine_learning_tpu_torch.runtime import faults

    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        faults.FaultInjector([])
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        faults.FaultInjector.parse("kill_rank@1:3")


def _election_on_checkpoints(a, root):
    """Two ranks' checkpoint directories (written by the port) with steps 2,
    4 and 6 recorded by both ranks; step 6 corrupted in rank 1's directory:
    the election skips it, and enforcing the elected step quarantines every
    newer complete checkpoint in both directories."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    coord = importlib.import_module(f"{a.pkg}.runtime.coordinator")
    gang, dirs = root / a.pkg / "gang", [str(root / a.pkg / f"rank{r}") for r in (0, 1)]
    gang.mkdir(parents=True)
    model = TransformerLM(vocab_size=32, d_model=16, n_layers=1, n_heads=2, device="cpu")
    init_params(model, seed=0)
    state = TrainState.create(model)
    for d in dirs:
        for step in (2, 4, 6, 8):
            state.step = step
            ck.save_checkpoint(d, state)
    state.step = 8
    os.remove(os.path.join(dirs[0], "step_8", "sgd_config.json"))  # torn on rank 0
    with open(os.path.join(dirs[1], "step_6", "state", "params", "embed.weight.bin"),
              "r+b") as f:
        first = f.read(1)
        f.seek(0)
        f.write(bytes([first[0] ^ 0xFF]))
    ck.forget_validated(os.path.join(dirs[1], "step_6"))
    tx = a.Tx(a.Hub())
    for rank in (0, 1):
        tx.write_restore_record(rank, [2, 4, 6])
    elected = coord.elect_restore_step(str(gang), 2, ckpt_dirs=dirs, transport=tx)
    quarantined = coord.enforce_restore_point(dirs, elected)
    return elected, sorted(os.path.relpath(p, root / a.pkg) for p in quarantined), [
        sorted(s for s in os.listdir(d) if ck.quarantine_reason(os.path.join(d, s)))
        for d in dirs]


def test_restore_election_on_checkpoints_matches_jax(tmp_path):
    """The checkpoint side of the election, each package on its own copy of
    the same port-written directories: the same step elected past the
    corrupted one, the same checkpoints quarantined."""
    ref, port = _both(_election_on_checkpoints, tmp_path)
    assert port == ref
    assert port == (4, ["rank0/step_6", "rank1/step_6", "rank1/step_8"],
                    [["step_6"], ["step_6", "step_8"]])


def test_router_carries_a_request_max_new():
    a = _api(PORT)
    hub = a.Hub()
    tx = a.Tx(hub)
    router = a.Router(a.Tx(hub), a.Config(replicas=1))
    _spare(tx, 0)
    router.pump()
    router.submit([1, 2], max_new=5)
    router.submit([3])
    router.pump()
    assert [r.get("max_new") for r in tx.take_requests(0, 8)] == [5, None]
