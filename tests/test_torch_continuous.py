"""The port's continuous-batching engine vs the JAX package, on the CPU.

The tiny model of tests/test_continuous.py, its Flax weights converted to
the port.  Greedy streams out of the port's engine must equal the JAX
``generate()`` streams token for token (f32): a ragged batch, mid-flight
admission, admission control, EOS retirement with same-step backfill, the
int8 throughput lever.  A lever flip mid-drain mixes the levers inside one
request, which no ``generate()`` call does: there the JAX engine, under
the same scheduler, is the reference.  Also: the allocator and the regime
scheduler against their JAX originals, the swap fence, the refusal to run
on a missing card, and that the engine never imports jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.inference import continuous as ref_cont
from distributed_machine_learning_tpu.inference import kv_blocks as ref_kvb
from distributed_machine_learning_tpu.inference.generate import generate as ref_generate
from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
from distributed_machine_learning_tpu.runtime import scheduler as ref_sched
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.inference import kv_blocks
from distributed_machine_learning_tpu_torch.inference.continuous import (
    ContinuousEngine,
    EngineConfig,
)
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.runtime import scheduler
from distributed_machine_learning_tpu_torch.telemetry.registry import MetricsRegistry

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=32, d_model=16, n_layers=2, n_heads=4, n_kv_heads=2)


class _Lm:
    """The JAX model and weights, the port model, and memoised JAX
    ``generate()`` streams (each new prompt length compiles)."""

    def __init__(self):
        self.ref = RefLM(**CFG)
        self.params = self.flax_params(0)
        self.port = TransformerLM(**CFG, device="cpu")
        self.port.load_state_dict(flax_to_state_dict(self.params))
        self._streams = {}

    def flax_params(self, seed):
        return jax.device_get(self.ref.init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])

    def stream(self, prompt, n, params=None, **kw):
        key = (tuple(prompt), n, id(params), tuple(sorted(kw.items())))
        if key not in self._streams:
            out = ref_generate(self.ref, self.params if params is None else params,
                               np.asarray([prompt], np.int32), n, **kw)
            self._streams[key] = np.asarray(out)[0].tolist()
        return self._streams[key]

    def engine(self, scheduler=None, **cfg):
        return ContinuousEngine(self.port, EngineConfig(**cfg), device="cpu",
                                scheduler=scheduler)


@pytest.fixture(scope="module")
def lm():
    return _Lm()


def _serve(eng, prompts, max_new):
    """Submit ``prompts`` at once (``max_new``: an int, or one per prompt)
    and drain; the completions by rid."""
    for i, p in enumerate(prompts):
        n = max_new if isinstance(max_new, int) else max_new[i]
        eng.submit(f"r{i}", list(p), max_new=n)
    return {d["rid"]: d for d in eng.drain()}


def test_engine_ragged_batch_matches_jax_generate(lm):
    prompts = [[1, 2, 3, 4], [5, 6, 7], [9, 10, 11, 12, 13], [2, 4, 6, 8], [3, 3, 3]]
    done = _serve(lm.engine(max_lanes=3, block_size=4, num_blocks=32, max_len=32,
                            levers=("latency",)), prompts, 6)
    for i, p in enumerate(prompts):
        assert done[f"r{i}"]["tokens"] == lm.stream(p, 6)
        assert done[f"r{i}"]["finish"] == "length"


def test_engine_mid_flight_admission_matches_jax_generate(lm):
    eng = lm.engine(max_lanes=2, block_size=4, num_blocks=32, max_len=32,
                    levers=("latency",))
    eng.submit("a", [1, 2, 3, 4], max_new=8)
    for _ in range(3):
        eng.step()
    assert eng.in_flight() == 1
    eng.submit("b", [5, 6, 7], max_new=8)  # joins mid-flight
    done = {d["rid"]: d for d in eng.drain()}
    assert done["a"]["tokens"] == lm.stream([1, 2, 3, 4], 8)
    assert done["b"]["tokens"] == lm.stream([5, 6, 7], 8)


def test_engine_admission_control_queues_then_serves(lm):
    # 6 blocks of 4 slots; each request pledges 2 blocks: 3 of 5 fit at once.
    eng = lm.engine(max_lanes=4, block_size=4, num_blocks=6, max_len=8,
                    levers=("latency",))
    prompts = [[1 + i, 2 + i, 3, 4] for i in range(5)]
    for i, p in enumerate(prompts):
        eng.submit(f"r{i}", p, max_new=4)
    eng.step()
    assert eng.in_flight() == 3 and eng.queued() == 2
    done = {d["rid"]: d for d in eng.drain()}
    for i, p in enumerate(prompts):
        assert done[f"r{i}"]["tokens"] == lm.stream(p, 4)
    eng.allocator.check_invariants()
    assert eng.allocator.free_blocks() == 6


def test_engine_eos_retires_and_backfills_same_step(lm):
    a, b = [9, 10, 11, 12], [1, 2, 3]
    gen = lm.stream(a, 10)[len(a):]
    # EOS: a token the stream first emits in a decode step (not at prefill).
    cut = next(i for i in range(2, len(gen)) if gen[i] not in gen[:i])
    eos = gen[cut]
    eng = lm.engine(max_lanes=1, block_size=4, num_blocks=8, max_len=32,
                    eos_id=eos, levers=("latency",))
    eng.submit("a", a, max_new=10)
    eng.submit("b", b, max_new=3)
    for _ in range(50):
        out = eng.step()
        if out:
            break
    assert [d["rid"] for d in out] == ["a"] and out[0]["finish"] == "eos"
    assert out[0]["tokens"] == a + gen[:cut + 1]
    assert eng.in_flight() == 1 and eng.queued() == 0  # b backfilled in that step
    done = eng.drain()
    want = lm.stream(b, 3)
    if eos in want[len(b):]:
        want = want[:want.index(eos, len(b)) + 1]
    assert done[0]["rid"] == "b" and done[0]["tokens"] == want


def test_engine_throughput_lever_matches_int8_generate(lm):
    sched = scheduler.RegimeScheduler(scheduler.RegimeConfig(
        thin_width=0, wide_width=1, dwell_steps=1))
    eng = lm.engine(scheduler=sched, max_lanes=2, block_size=4, num_blocks=16,
                    max_len=16, levers=("latency", "throughput"))
    done = _serve(eng, [[1, 2, 3, 4], [7, 1, 5, 2]], 4)
    assert sched.flips >= 1
    for i, p in enumerate([[1, 2, 3, 4], [7, 1, 5, 2]]):
        assert done[f"r{i}"]["lever"] == "throughput"
        assert done[f"r{i}"]["tokens"] == lm.stream(p, 4, quantize="int8")


def test_engine_lever_flip_mid_drain_matches_jax_engine(lm):
    """Pressure 6 flips to throughput after two steps, with requests in
    flight that prefilled on latency, and back to latency while the longest
    request finishes alone."""
    prompts = [[1 + i, 4, 2 + i, 3] for i in range(6)]
    cfg = dict(max_lanes=2, block_size=4, num_blocks=16, max_len=16,
               levers=("latency", "throughput"))
    regime = dict(thin_width=1, wide_width=3, dwell_steps=2)
    ours = scheduler.RegimeScheduler(scheduler.RegimeConfig(**regime))
    theirs = ref_sched.RegimeScheduler(ref_sched.RegimeConfig(**regime))
    max_new = [3, 4, 5, 6, 7, 12]
    got = _serve(lm.engine(scheduler=ours, **cfg), prompts, max_new)
    want = _serve(ref_cont.ContinuousEngine(lm.ref, lm.params,
                                            ref_cont.EngineConfig(**cfg),
                                            scheduler=theirs), prompts, max_new)
    assert ours.flips == theirs.flips == 2
    assert {d["lever"] for d in got.values()} == {"latency", "throughput"}
    for rid, d in want.items():
        assert (got[rid]["tokens"], got[rid]["lever"]) == (d["tokens"], d["lever"])


def test_engine_swap_fence_refuses_in_flight(lm):
    params2 = lm.flax_params(7)
    eng = ContinuousEngine(lm.port.clone(), EngineConfig(
        max_lanes=2, block_size=4, num_blocks=16, max_len=32, levers=("latency",)),
        device="cpu", version=1)
    eng.swap_params(lm.port.state_dict())
    eng.submit("a", [1, 2, 3, 4], max_new=6)
    eng.step()
    with pytest.raises(RuntimeError, match="in flight"):
        eng.swap_params(flax_to_state_dict(params2), version=2)
    eng.pause_admission()
    done = eng.drain()
    assert done[0]["version"] == 1 and done[0]["tokens"] == lm.stream([1, 2, 3, 4], 6)
    eng.swap_params(flax_to_state_dict(params2), version=2)
    eng.resume_admission()
    eng.submit("b", [1, 2, 3, 4], max_new=6)
    done2 = eng.drain()
    assert done2[0]["version"] == 2
    assert done2[0]["tokens"] == lm.stream([1, 2, 3, 4], 6, params=params2)
    assert done2[0]["tokens"] != done[0]["tokens"]


def test_block_allocator_matches_jax():
    """One seeded admit/append/free sequence through both allocators:
    the same tables, positions and refusals after every op."""
    rng = np.random.default_rng(0)
    ours, theirs = kv_blocks.BlockAllocator(24, 4), ref_kvb.BlockAllocator(24, 4)
    live, seq = [], 0
    for _ in range(300):
        op = rng.integers(3)
        if op == 0 or not live:
            args = (seq, int(rng.integers(1, 12)), int(rng.integers(0, 10)))
            try:
                want = theirs.admit(*args)
            except ref_kvb.CacheExhausted:
                with pytest.raises(kv_blocks.CacheExhausted):
                    ours.admit(*args)
                continue
            assert ours.admit(*args) == want
            live.append(seq)
            seq += 1
            continue
        s = live[int(rng.integers(len(live)))]
        if op == 1:
            try:
                want = theirs.append(s)
            except ValueError:  # past the reservation
                with pytest.raises(ValueError, match="reservation"):
                    ours.append(s)
                continue
            assert ours.append(s) == want
        else:
            assert ours.free(s) == theirs.free(s)
            live.remove(s)
        assert ours.table(live[0]) == theirs.table(live[0]) if live else True
        assert ours.stats() == theirs.stats()
        ours.check_invariants()
    assert seq > 20


def test_regime_scheduler_matches_jax():
    rng = np.random.default_rng(1)
    cfg = dict(thin_width=2, wide_width=6, dwell_steps=3)
    ours = scheduler.RegimeScheduler(scheduler.RegimeConfig(**cfg),
                                     registry=MetricsRegistry())
    theirs = ref_sched.RegimeScheduler(ref_sched.RegimeConfig(**cfg))
    for _ in range(400):
        q, w = int(rng.integers(0, 8)), int(rng.integers(0, 5))
        assert ours.observe(q, w) == theirs.observe(q, w)
    assert ours.snapshot() == theirs.snapshot() and ours.flips > 2
    with pytest.raises(ValueError, match="dead band"):
        scheduler.RegimeConfig(thin_width=3, wide_width=3)


def test_engine_refuses_a_missing_card(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(lm.port, EngineConfig(levers=("latency",)))
    assert lm.engine(levers=("latency",)).device == torch.device("cpu")


def test_engine_telemetry_stamps_and_validation(lm):
    reg = MetricsRegistry()
    eng = ContinuousEngine(lm.port, EngineConfig(
        max_lanes=2, block_size=4, num_blocks=16, max_len=16, levers=("latency",)),
        device="cpu", registry=reg, name="e0")
    eng.warmup(prompt_lens=(3,))
    requests = [{"events": []} for _ in range(3)]
    for i, r in enumerate(requests):
        eng.submit(f"r{i}", [1 + i, 2, 3], max_new=4, request=r)
    assert len(eng.drain()) == 3
    assert [e["stage"] for e in requests[0]["events"]] == ["prefill", "decode"]
    assert requests[0]["events"][1]["dt"] >= 0 and requests[0]["events"][1]["by"] == "e0"
    snap = reg.snapshot()
    hists = {m["name"]: m["count"] for m in snap["histograms"]}
    assert hists == {"engine_prefill_s": 4, "engine_decode_s": 4, "engine_e2e_s": 4}
    counters = {m["name"]: m["value"] for m in snap["counters"]}
    assert counters == {"engine_tokens_total": 14, "engine_requests_total": 4}
    eng.submit("x", [1, 2], max_new=3)
    eng.step()
    assert eng.abort_all() == ["x"] and not eng.has_work()
    assert eng.allocator.free_blocks() == 16
    with pytest.raises(ValueError, match="empty"):
        eng.submit("a", [])
    with pytest.raises(ValueError, match="max_len"):
        eng.submit("a", list(range(1, 14)), max_new=8)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit("a", [1, 2], max_new=0)
    with pytest.raises(ValueError, match="lever"):
        eng.note_lever("warp")


def test_engine_never_imports_jax():
    code = (
        "import sys, torch\n"
        "import chip_smoke\n"
        "from distributed_machine_learning_tpu_torch.convert import init_params\n"
        "from distributed_machine_learning_tpu_torch.inference.continuous import (\n"
        "    ContinuousEngine, EngineConfig)\n"
        "from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM\n"
        "from distributed_machine_learning_tpu_torch.runtime.scheduler import RegimeScheduler\n"
        "m = TransformerLM(vocab_size=32, d_model=16, n_layers=1, n_heads=4, n_kv_heads=2)\n"
        "init_params(m)\n"
        "eng = ContinuousEngine(m, EngineConfig(max_lanes=2, block_size=4, num_blocks=8,\n"
        "    max_len=16), device='cpu', scheduler=RegimeScheduler())\n"
        "eng.submit('a', [1, 2, 3], max_new=3)\n"
        "assert len(eng.drain()) == 1\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))"
        " or m.split('.')[0] == 'distributed_machine_learning_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
