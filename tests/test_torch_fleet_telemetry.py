"""The port's fleet telemetry vs the JAX package, on identical inputs.

Each case feeds the same samples, outcomes, clock readings and files to
the JAX package's telemetry module and to the port's copy, and compares
what comes out exactly: SLO verdicts (timestamps injected), the
aggregator's ``serving_stage_samples`` and ``StragglerDetector``
decisions, registry snapshots and the Prometheus text, the sink's torn-
line handling, tracer output (timestamps and durations aside), the
``Telemetry`` facade's artifacts and the fault-event mirror.  Only the
MFU differs by design: the port divides by the H100's bf16 peak.
"""

import json
import os

import numpy as np
import pytest

from distributed_machine_learning_tpu import telemetry as ref_tel
from distributed_machine_learning_tpu.runtime import faults as ref_faults
from distributed_machine_learning_tpu.telemetry import aggregator as ref_agg
from distributed_machine_learning_tpu.telemetry import registry as ref_reg
from distributed_machine_learning_tpu.telemetry import sink as ref_sink
from distributed_machine_learning_tpu.telemetry import slo as ref_slo
from distributed_machine_learning_tpu.telemetry import tracer as ref_tracer
from distributed_machine_learning_tpu_torch import telemetry as tel
from distributed_machine_learning_tpu_torch.runtime import faults
from distributed_machine_learning_tpu_torch.telemetry import aggregator as agg
from distributed_machine_learning_tpu_torch.telemetry import registry as reg
from distributed_machine_learning_tpu_torch.telemetry import sink
from distributed_machine_learning_tpu_torch.telemetry import slo
from distributed_machine_learning_tpu_torch.telemetry import tracer


def _both(fn):
    """``fn(module_set)`` for the reference's modules and the port's."""
    ref = dict(reg=ref_reg, sink=ref_sink, slo=ref_slo, agg=ref_agg,
               tracer=ref_tracer, tel=ref_tel, faults=ref_faults)
    port = dict(reg=reg, sink=sink, slo=slo, agg=agg, tracer=tracer,
                tel=tel, faults=faults)
    return fn(ref), fn(port)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def _fill_registry(m, seed):
    rng = np.random.default_rng(seed)
    r = m["reg"].MetricsRegistry()
    r.counter("fault_events", kind="drains").inc(3)
    r.counter("serving_rejects").inc(int(rng.integers(1, 9)))
    r.counter("weird", why='a "quoted"\\path\nnewline').inc()
    r.gauge("serving_queue_depth").set(float(rng.integers(0, 64)))
    r.gauge("serving_replicas").set(2.0)
    lat = r.histogram("serving_request_latency_s",
                      buckets=m["reg"].default_latency_buckets())
    for v in rng.lognormal(-5.0, 1.0, 200):
        lat.observe(float(v))
    for stage in ("queued", "decode"):
        h = r.histogram("serving_stage_latency_s",
                        buckets=m["reg"].default_latency_buckets(), stage=stage)
        for v in rng.exponential(0.01, 50):
            h.observe(float(v))
    step = r.histogram("step_s")  # the default (train-step) buckets
    for v in rng.uniform(0.01, 3.0, 40):
        step.observe(float(v))
    return r


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_snapshot_and_prometheus_match_jax(seed):
    ref, port = _both(lambda m: _fill_registry(m, seed))
    assert port.snapshot() == ref.snapshot()
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.to_prometheus().count("# TYPE serving_stage_latency_s ") == 1


def test_bucket_presets_match_jax():
    assert reg.default_time_buckets() == ref_reg.default_time_buckets()
    assert reg.default_latency_buckets() == ref_reg.default_latency_buckets()
    assert reg.Histogram("h", ()).bounds == ref_reg.Histogram("h", ()).bounds


def test_counter_refuses_decrease_like_jax():
    for m in (ref_reg, reg):
        with pytest.raises(ValueError):
            m.MetricsRegistry().counter("c").inc(-1)


# ---------------------------------------------------------------------------
# slo
# ---------------------------------------------------------------------------


def _load(engine, stall, n=400, dt=0.25):
    fired = []
    for i in range(n):
        t = i * dt
        lat = 2.0 if stall and stall[0] <= t < stall[1] else 0.02
        fired.extend(engine.observe(latency_s=lat, now=t))
    return fired


def _burst(engine):
    fired = []
    for i in range(120):
        fired.extend(engine.observe(latency_s=0.01, now=i * 0.5))
    for j in range(42):
        fired.extend(engine.observe(latency_s=0.01, error=True,
                                    now=60.0 + j * 0.5))
    return fired


def _mixed(engine):
    rng = np.random.default_rng(7)
    fired = []
    for i in range(300):
        kind = rng.integers(0, 10)
        fired.extend(engine.observe(latency_s=float(rng.exponential(0.1)),
                                    error=bool(kind == 0),
                                    rejected=bool(kind == 1), now=i * 0.2))
    return fired


SLO_CASES = {
    "stall": (["p99<=250ms"], dict(), lambda e: _load(e, (40.0, 55.0))),
    "no_stall": (["p99<=250ms"], dict(), lambda e: _load(e, None)),
    "quiet_tail": (["p95<=250ms"], dict(), lambda e: _load(e, (40.0, 50.0), n=4000)),
    "burst": (["error_ratio<=5%"], dict(), _burst),
    "mixed": (["p90<=150ms", "error_ratio<=10%", "reject_ratio<=5%"],
              dict(long_window_s=20.0), _mixed),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_verdicts_match_jax(case):
    specs, kw, drive = SLO_CASES[case]

    def run(m):
        engine = m["slo"].SLOEngine(specs, **kw)
        fired = drive(engine)
        verdict = engine.verdict()
        return fired, verdict, m["slo"].format_verdict(verdict)

    ref, port = _both(run)
    assert port == ref


@pytest.mark.parametrize("spec", ["p99<=250ms", "p99.9<=1s", "p90<=500us",
                                  "reject_ratio<=5%", "error_ratio<=0.01",
                                  "p0<=1ms", "latency<=1s", "reject_ratio<=0"])
def test_parse_slo_matches_jax(spec):
    def parse(m):
        try:
            return m["slo"].parse_slo(spec).__dict__
        except ValueError:
            return "ValueError"

    ref, port = _both(parse)
    assert port == ref


# ---------------------------------------------------------------------------
# aggregator
# ---------------------------------------------------------------------------

EVENTS = [
    {"stage": "admitted", "by": "router", "dt": None},
    {"stage": "taken", "by": "replica0", "dt": None},
    {"stage": "computed", "by": "replica0", "dt": 0.25},
    {"stage": "decode", "by": "replica3", "dt": 0.5},
    {"stage": "computed", "by": "replica2", "dt": None},
    {"stage": "computed", "by": "router", "dt": 1.0},
    {"stage": "computed", "by": "replica12", "dt": 0.125},
    "not an event",
]


@pytest.mark.parametrize("stage", ["computed", "decode", "taken"])
def test_serving_stage_samples_match_jax(stage):
    ref, port = _both(lambda m: m["agg"].serving_stage_samples(EVENTS, stage=stage))
    assert port == ref


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_decisions_match_jax(seed):
    rng = np.random.default_rng(seed)
    rounds = []
    for i in range(40):
        samples = {r: float(rng.uniform(0.9, 1.1)) for r in range(4)}
        if 10 <= i < 20 or 25 <= i < 32:
            samples[2] *= 6.0  # a straggler episode, recovery, another
        if i % 7 == 0:
            samples[3] = None
        rounds.append(samples)

    def run(m):
        det = m["agg"].StragglerDetector(multiple=4.0, consecutive=3)
        out = []
        for i, s in enumerate(rounds):
            out.append(([v.as_dict() for v in det.update(s, step=i)],
                        round(det.skew_ratio, 12), sorted(det.flagged)))
            if i == 22:
                det.reset_rank(2)
        return out, det.flags_total

    ref, port = _both(run)
    assert port == ref
    assert port[1] == 2


def test_gang_rollup_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for r in range(3):
        with open(tmp_path / f"metrics.rank{r}.jsonl", "w") as f:
            for step in range(12):
                f.write(json.dumps({
                    "step": step, "iter_s": float(rng.uniform(0.1, 0.2)) * (3 if r == 1 else 1),
                    "data_wait_s": float(rng.uniform(0, 0.01)), "attempt": 0,
                    "examples_per_s": 100.0}) + "\n")
    ref, port = _both(lambda m: m["agg"].aggregate_gang_metrics(str(tmp_path)).as_dict())
    assert port == ref


# ---------------------------------------------------------------------------
# sink
# ---------------------------------------------------------------------------

SINK_FILES = {
    "torn_tail": '{"a": 1}\n{"a": 2}\n{"a": 3, "b"',
    "clean": '{"a": 1}\n\n{"a": 2}\n',
    "corrupt_middle": '{"a": 1}\n{"a": \n{"a": 3}\n',
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(SINK_FILES))
def test_read_jsonl_torn_line_handling_matches_jax(tmp_path, name):
    path = tmp_path / "m.jsonl"
    path.write_text(SINK_FILES[name])

    def read(m):
        try:
            return m["sink"].read_jsonl(path)
        except json.JSONDecodeError:
            return "JSONDecodeError"

    ref, port = _both(read)
    assert port == ref


def test_sink_reopen_after_torn_line_matches_jax(tmp_path):
    def run(m):
        path = tmp_path / f"{m['sink'].__name__.split('.')[0]}.jsonl"
        path.write_text('{"step": 0}\n{"step": 1, "lo')
        with m["sink"].JsonlSink(path, flush_every=2, enabled=True) as s:
            for i in range(1, 5):
                s.write({"step": i, "loss": 1.0 / i})
        return path.read_text(), s.rows_written

    ref, port = _both(run)
    assert port == ref


def test_port_sink_rank_gate(monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "1")
    s = sink.JsonlSink(tmp_path / "m.jsonl")
    s.write({"x": 1})
    s.close()
    assert not s.enabled and not (tmp_path / "m.jsonl").exists()
    monkeypatch.setenv("RANK", "0")
    assert sink._rank() == 0


# ---------------------------------------------------------------------------
# tracer and the facade
# ---------------------------------------------------------------------------


def _trace(m, path):
    t = m["tracer"].SpanTracer(path, flush_every=2, enabled=True, max_events=7)
    t0 = t.now()
    t.complete("request", t0, t0 + 0.001, rid="r1", stage="posted")
    t.instant("weight_swap", rank=1, version=2)
    with t.span("outer", step=3):
        with t.span("inner"):
            pass
    with pytest.raises(KeyError):
        with t.span("failing"):
            raise KeyError("x")
    for i in range(5):  # past max_events: dropped
        t.complete("late", t0, t0, i=i)
    t.close()
    events = m["tracer"].read_trace(path)
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in events]


def test_tracer_output_matches_jax_timestamps_aside(tmp_path):
    ref, port = _both(lambda m: _trace(m, tmp_path / f"{m['tracer'].__name__.split('.')[0]}.json"))
    assert port == ref
    assert len(port) == 7 and port[-1]["name"] == "late"


def test_telemetry_facade_artifacts_match_jax(tmp_path):
    def run(m):
        out = tmp_path / m["tel"].__name__.split(".")[0]
        t = m["tel"].Telemetry(out, instance="router", enabled=True, flush_every=2)
        for step in range(3):
            t.log_step(step, loss=1.0 / (step + 1))
        t.registry.counter("serving_evictions").inc()
        t.registry.histogram("serving_request_latency_s",
                             buckets=m["reg"].default_latency_buckets()).observe(0.01)
        t.set_attempt(2)
        t.log_step(3, loss=0.25)
        t.close()
        rows = [{k: v for k, v in r.items() if k != "time"}
                for r in m["sink"].read_jsonl(out / "metrics.router.jsonl")]
        again = m["tel"].Telemetry(out, instance="router", enabled=True)
        resumed = again.attempt, again.registry.snapshot()["counters"]
        again.close()
        return (rows, json.loads((out / "registry.router.json").read_text()),
                (out / "metrics.router.prom").read_text(), resumed,
                m["tel"].instance_file("trace.json", "replica3"))

    ref, port = _both(run)
    assert port == ref


def test_fault_events_mirror_matches_jax(tmp_path):
    def run(m):
        t = m["tel"].Telemetry(tmp_path / m["tel"].__name__.split(".")[0], enabled=True)
        prev = m["tel"].set_telemetry(t)
        try:
            ev = m["faults"].FaultEvents()
            ev.drains += 1
            ev.replica_evictions += 2
            ev.request_rejects += 1
        finally:
            m["tel"].set_telemetry(prev)
            t.close()
        return ev.as_dict(), t.registry.to_prometheus()

    ref, port = _both(run)
    assert port == ref


def test_mfu_takes_the_h100_peak(tmp_path):
    t = tel.Telemetry(tmp_path, enabled=False)
    t.flops_per_token = 6.0e9
    assert t.mfu_of(0.0, 1000.0) == pytest.approx(6.0e12 / 989e12)
    assert t.mfu_of(0.0, None) is None
    t.close()


def test_fleet_telemetry_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; import distributed_machine_learning_tpu_torch.telemetry, "
            "distributed_machine_learning_tpu_torch.runtime.serving, "
            "distributed_machine_learning_tpu_torch.cli.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'distributed_machine_learning_tpu')]; print(bad); sys.exit(bool(bad))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stdout + res.stderr
