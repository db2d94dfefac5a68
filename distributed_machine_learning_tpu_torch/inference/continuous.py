"""Continuous-batching decode engine over a paged KV pool.

Counterpart of ``distributed_machine_learning_tpu/inference/continuous.py``
(``EngineConfig``, ``_Lane``, ``ContinuousEngine``), with its API and its
numbers.  Iteration-level scheduling:

* one *step* advances every in-flight sequence by one token, each at its
  own cache frontier, in one model call;
* newly admitted prompts prefill and join the very next step;
* a sequence that finishes (EOS or its own ``max_new``) retires mid-flight,
  its KV blocks free at once, and the freed lane backfills from the
  waiting queue in the same ``step()`` call.

KV residency is a shared paged pool: per layer, a ``[num_blocks + 1, Hkv,
block_size, D]`` tensor in the compute dtype whose rows are handed out by
:class:`~.kv_blocks.BlockAllocator` (the +1 row is a scratch block that
idle lanes point at, position 0, token 0).  A prompt prefills alone
through the model's ``start=0`` path into a dense ``[1, Hkv, nb·bs, D]``
cache (flash from ``flash_wins(Lp)``, dense below), whose pages are then
copied into the pool rows of the lane's table.

**One deliberate difference from the reference engine.**  The reference's
decode step gathers each lane's pages into a dense cache and runs the
batched-frontier einsum; its docstring notes that on the accelerator the
same pool and tables feed ``paged_flash_attention``.  Here the decode
step is the model's paged path: each lane writes its fresh K/V row into
its page, then attention reads the pool through the block tables with no
gather (``ops.decode_attention.paged_flash_attention``: the hand-written
kernel on CUDA, its plain version on the CPU).  The numbers are the
reference engine's: greedy token streams equal ``generate()``'s.

The **regime lever** (``runtime/scheduler.py``): each step the engine asks
its :class:`~..runtime.scheduler.RegimeScheduler`, or honours the router's
hint, which variant to run: ``"latency"`` (the model's own weights) or
``"throughput"`` (its int8 twin, ``ops.quant.quantize_lm``, whose
projections run the W8A16 kernel).  Both levers share the pool, so a flip
between steps is free; new weights (:meth:`ContinuousEngine.swap_params`)
land only with nothing in flight.

The engine runs on ``cuda`` unless built with ``device="cpu"``; the model
must lie on that device.  The host builds each step's tables and
positions and reads back one token per lane per step.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from distributed_machine_learning_tpu_torch import resolve_device
from distributed_machine_learning_tpu_torch.inference.generate import _sample
from distributed_machine_learning_tpu_torch.inference.kv_blocks import (
    BlockAllocator,
    CacheExhausted,
    blocks_needed,
)
from distributed_machine_learning_tpu_torch.models.transformer import PagedKV
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm
from distributed_machine_learning_tpu_torch.runtime.scheduler import (
    LATENCY,
    THROUGHPUT,
)
from distributed_machine_learning_tpu_torch.runtime.transport import stamp_stage
from distributed_machine_learning_tpu_torch.telemetry.registry import (
    default_latency_buckets,
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """``max_lanes`` is the decode batch width W (idle lanes ride as
    masked work); ``num_blocks * block_size`` is the shared cache budget in
    token slots; ``max_len`` caps ``prompt_len + max_new`` per request and
    fixes the width of the per-lane block tables."""

    max_lanes: int = 4
    block_size: int = 16
    num_blocks: int = 64
    max_len: int = 128
    max_new: int = 32              # default per-request cap
    eos_id: int | None = None
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    levers: tuple = (LATENCY, THROUGHPUT)

    def __post_init__(self):
        if self.max_lanes < 1:
            raise ValueError(f"max_lanes must be >= 1: {self.max_lanes}")
        if self.max_len > self.num_blocks * self.block_size:
            raise ValueError(
                f"max_len={self.max_len} exceeds the pool "
                f"({self.num_blocks} x {self.block_size} slots)")
        if not self.levers or any(l not in (LATENCY, THROUGHPUT) for l in self.levers):
            raise ValueError(f"unknown levers: {self.levers}")


@dataclasses.dataclass
class _Lane:
    rid: object
    prompt_len: int
    max_new: int
    tokens: list
    request: dict | None
    version: object
    lever: str
    t_submit: float
    t_ready: float        # prefill completed
    prefill_s: float


class ContinuousEngine:
    """One replica's iteration-level serving loop.

    ``submit()`` queues requests; ``step()`` advances the world by one
    decode iteration and returns the requests that finished.  ``model`` is
    a float :class:`~..models.transformer.TransformerLM` with its weights
    loaded, on ``device``; ``generator`` feeds sampling (greedy needs
    none)."""

    def __init__(self, model, cfg: EngineConfig | None = None, *,
                 registry=None, scheduler=None, name: str = "engine",
                 version=None, generator: torch.Generator | None = None,
                 device=None):
        self.cfg = cfg = cfg or EngineConfig()
        want = resolve_device(device)
        if model.device.type != want.type or (want.index is not None
                                               and model.device != want):
            raise ValueError(f"the model lies on {model.device}, the engine runs "
                             f"on {want}: build the model there")
        self.device = model.device
        if model.weight_quant is not None:
            raise ValueError("the engine takes the float model; the throughput "
                             "lever builds its int8 twin")
        if model.kv_cache_dtype is not None:
            raise ValueError("paged pools hold compute-dtype KV; int8 caches are the "
                             "batch-static path's lever (kv_cache_dtype must be None)")
        self._by = name
        self._scheduler = scheduler
        self._hint: str | None = None
        self.version = version
        self._generator = generator
        self._mb = blocks_needed(cfg.max_len, cfg.block_size)
        self._trash = cfg.num_blocks  # scratch page for idle lanes
        self.allocator = BlockAllocator(cfg.num_blocks, cfg.block_size)
        self._model = model.eval()
        self.models: dict = {}  # lever -> the model that serves it
        self._set_models()
        shape = (cfg.num_blocks + 1, model.n_kv_heads, cfg.block_size, model.head_dim)

        def pool():
            return torch.zeros(shape, dtype=model.compute_dtype, device=self.device)

        self.k_pools = [pool() for _ in model.blocks]
        self.v_pools = [pool() for _ in model.blocks]
        self._lanes: list[_Lane | None] = [None] * cfg.max_lanes
        self._waiting: list[_Lane] = []
        self._paused = False
        self.steps = 0
        self.completed_total = 0
        self._metrics = None
        if registry is not None:
            lat = default_latency_buckets()
            self._metrics = {
                "lanes": registry.gauge("engine_active_lanes"),
                "queue": registry.gauge("engine_queue_depth"),
                "free": registry.gauge("kv_free_blocks"),
                "avail": registry.gauge("kv_available_blocks"),
                "tokens": registry.counter("engine_tokens_total"),
                "done": registry.counter("engine_requests_total"),
                "prefill": registry.histogram("engine_prefill_s", buckets=lat),
                "decode": registry.histogram("engine_decode_s", buckets=lat),
                "e2e": registry.histogram("engine_e2e_s", buckets=lat),
            }

    # -- weights / levers ------------------------------------------------

    def _set_models(self) -> None:
        self.models = {
            lever: quantize_lm(self._model).eval() if lever == THROUGHPUT else self._model
            for lever in self.cfg.levers}

    def swap_params(self, state_dict: dict, version=None) -> None:
        """Install new float weights (a state_dict of the model): the
        hot-swap fence.  Refuses while any sequence is in flight, so no
        sequence mixes weight versions mid-stream."""
        if self.in_flight():
            raise RuntimeError(
                f"swap_params with {self.in_flight()} sequences in flight — "
                "drain the engine first (pause_admission + step until empty)")
        self._model.load_state_dict(state_dict)
        self._set_models()
        if version is not None:
            self.version = version

    def warmup(self, prompt_lens=(4,)) -> None:
        """Run one dummy request per prompt length through every lever's
        prefill and decode and drain it (first launches, kernel builds and
        library handles happen here, not in the first live step)."""
        hint, eos = self._hint, self.cfg.eos_id
        # EOS off for the dummies: an instant EOS would skip the decode step.
        object.__setattr__(self.cfg, "eos_id", None)
        try:
            for lever in self.cfg.levers:
                self._hint = lever
                for lp in prompt_lens:
                    lp = int(lp)
                    if lp + 2 > self.cfg.max_len:
                        raise ValueError(f"warmup prompt_len {lp} + 2 exceeds "
                                         f"max_len={self.cfg.max_len}")
                    self.submit(("__warmup__", lever, lp), [1] * lp, max_new=2)
                self.drain()
        finally:
            self._hint = hint
            object.__setattr__(self.cfg, "eos_id", eos)

    def note_lever(self, lever: str | None) -> None:
        """Router-stamped fleet-wide regime hint; overrides the local
        scheduler until cleared with ``None``."""
        if lever is not None and lever not in (LATENCY, THROUGHPUT):
            raise ValueError(f"unknown lever {lever!r}")
        self._hint = lever

    def _pick_lever(self) -> str:
        lever = self._hint
        if lever is None and self._scheduler is not None:
            lever = self._scheduler.observe(len(self._waiting), self.in_flight())
        if lever is None:
            lever = LATENCY
        if lever not in self.models:  # single-lever engines ignore regime
            lever = self.cfg.levers[0]
        return lever

    # -- admission -------------------------------------------------------

    def submit(self, rid, prompt, *, max_new: int | None = None,
               request: dict | None = None) -> None:
        """Queue one request (``prompt``: a list of token ids; ``request``:
        the fleet's request record, stamped with stage events).  Raises
        ``ValueError`` if the request can never fit."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        mn = self.cfg.max_new if max_new is None else int(max_new)
        if mn < 1:
            raise ValueError(f"max_new must be >= 1: {mn}")
        if len(prompt) + mn > self.cfg.max_len:
            raise ValueError(f"prompt ({len(prompt)}) + max_new ({mn}) exceeds "
                             f"max_len={self.cfg.max_len}")
        self._waiting.append(_Lane(
            rid=rid, prompt_len=len(prompt), max_new=mn, tokens=prompt,
            request=request, version=None, lever=LATENCY,
            t_submit=time.perf_counter(), t_ready=0.0, prefill_s=0.0))

    def pause_admission(self) -> None:
        self._paused = True

    def resume_admission(self) -> None:
        self._paused = False

    def abort_all(self) -> list:
        """Drop every queued and in-flight request without completing it
        (the retired-replica path); frees every pool block and returns the
        dropped rids."""
        dropped = [l.rid for l in self._lanes if l is not None]
        dropped += [l.rid for l in self._waiting]
        for lane in self._lanes:
            if lane is not None:
                self.allocator.free(lane.rid)
        self._lanes = [None] * self.cfg.max_lanes
        self._waiting.clear()
        return dropped

    # -- introspection ---------------------------------------------------

    def in_flight(self) -> int:
        return sum(1 for l in self._lanes if l is not None)

    def queued(self) -> int:
        return len(self._waiting)

    def has_work(self) -> bool:
        return self.in_flight() > 0 or (not self._paused and bool(self._waiting))

    # -- the iteration loop ----------------------------------------------

    def _stamp(self, lane: _Lane, stage: str, **extra) -> None:
        if lane.request is not None and isinstance(lane.request.get("events"), list):
            stamp_stage(lane.request, stage, self._by, **extra)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return _sample(logits.float(), self._generator, cfg.temperature,
                       cfg.top_k, cfg.top_p)

    @torch.inference_mode()
    def _prefill(self, lever: str, table: list[int], prompt: list[int]) -> int:
        """Prefill one prompt into its allocated pool blocks; returns the
        first generated token."""
        model, bs = self.models[lever], self.cfg.block_size
        nb = len(table)
        cache = model.init_cache(1, nb * bs)
        tokens = torch.tensor([prompt], dtype=torch.long, device=self.device)
        logits = model(tokens, cache=cache, start=0, last_only=True)
        rows = torch.tensor(table, dtype=torch.long, device=self.device)
        for pools, dense in ((self.k_pools, cache.keys), (self.v_pools, cache.values)):
            for pool, layer in zip(pools, dense):
                # [1, Hkv, nb·bs, D] -> the nb pages [nb, Hkv, bs, D].
                pool[rows] = layer[0].unflatten(1, (nb, bs)).transpose(0, 1)
        return int(self._sample(logits[:, -1])[0])

    def _admit(self, lever: str, completed: list) -> None:
        """Move waiting requests into free lanes while the allocator admits
        them; each admitted prompt prefills here and joins the next step."""
        while self._waiting and not self._paused:
            free = [i for i, l in enumerate(self._lanes) if l is None]
            if not free:
                return
            lane = self._waiting[0]
            try:
                table = self.allocator.admit(lane.rid, lane.prompt_len, lane.max_new)
            except CacheExhausted:
                return  # head-of-line waits for a retirement
            except ValueError:
                self._waiting.pop(0)
                raise
            self._waiting.pop(0)
            t0 = time.perf_counter()
            tok = self._prefill(lever, table, lane.tokens)
            lane.t_ready = time.perf_counter()
            lane.prefill_s = lane.t_ready - t0
            lane.version = self.version
            lane.lever = lever
            lane.tokens.append(tok)
            self._stamp(lane, "prefill", lever=lever)
            if self._metrics is not None:
                self._metrics["prefill"].observe(lane.prefill_s)
                self._metrics["tokens"].inc()
            if self._finished(lane, tok):
                self._retire(lane, completed)
            else:
                self._lanes[free[0]] = lane

    def _finished(self, lane: _Lane, tok: int) -> bool:
        if self.cfg.eos_id is not None and tok == self.cfg.eos_id:
            return True
        return len(lane.tokens) - lane.prompt_len >= lane.max_new

    def _retire(self, lane: _Lane, completed: list) -> None:
        self.allocator.free(lane.rid)
        now = time.perf_counter()
        decode_s = now - lane.t_ready
        e2e_s = now - lane.t_submit
        gen = len(lane.tokens) - lane.prompt_len
        eos = self.cfg.eos_id is not None and lane.tokens[-1] == self.cfg.eos_id
        self._stamp(lane, "decode", tokens=gen, lever=lane.lever)
        if self._metrics is not None:
            self._metrics["decode"].observe(decode_s)
            self._metrics["e2e"].observe(e2e_s)
            self._metrics["done"].inc()
        self.completed_total += 1
        completed.append({
            "rid": lane.rid, "tokens": list(lane.tokens),
            "prompt_len": lane.prompt_len, "generated": gen,
            "finish": "eos" if eos else "length", "lever": lane.lever,
            "version": lane.version, "prefill_s": lane.prefill_s,
            "decode_s": decode_s, "e2e_s": e2e_s, "request": lane.request,
        })

    def decode_inputs(self) -> PagedKV | None:
        """The first half of a decode step: claim the next slot of every
        in-flight lane and return the step's pools, tables [W, MB] and
        positions [W] on the device (idle lanes: the scratch block,
        position 0), or None with nothing in flight.  With
        :meth:`decode_logits`, lets a check run one step's inputs through
        two paths; ``step()`` runs both halves."""
        active = [(i, l) for i, l in enumerate(self._lanes) if l is not None]
        if not active:
            return None
        tables = [[self._trash] * self._mb for _ in range(self.cfg.max_lanes)]
        positions = [0] * self.cfg.max_lanes
        for i, lane in active:
            positions[i] = self.allocator.append(lane.rid)
            tbl = self.allocator.table(lane.rid)
            tables[i][:len(tbl)] = tbl
        return PagedKV(
            self.k_pools, self.v_pools,
            torch.tensor(tables, dtype=torch.int32, device=self.device),
            torch.tensor(positions, dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def decode_logits(self, lever: str, step: PagedKV) -> torch.Tensor:
        """The second half of a decode step: every lane's last token through
        the lever's model (each lane writes its K/V row into its page, then
        attends its own slots) → f32 logits [W, vocab]."""
        toks = [0] * self.cfg.max_lanes
        for i, lane in enumerate(self._lanes):
            if lane is not None:
                toks[i] = lane.tokens[-1]
        tokens = torch.tensor(toks, dtype=torch.long, device=self.device)[:, None]
        return self.models[lever](tokens, paged=step)[:, -1]

    def step(self) -> list[dict]:
        """One engine iteration; returns the requests that completed during
        it.  Safe to call with nothing in flight (admission still runs)."""
        completed: list[dict] = []
        lever = self._pick_lever()
        self._admit(lever, completed)
        step = self.decode_inputs()
        if step is not None:
            nxt = self._sample(self.decode_logits(lever, step)).tolist()
            for i, lane in enumerate(self._lanes):
                if lane is None:
                    continue
                tok = int(nxt[i])
                lane.tokens.append(tok)
                if self._metrics is not None:
                    self._metrics["tokens"].inc()
                if self._finished(lane, tok):
                    self._lanes[i] = None
                    self._retire(lane, completed)
            # Backfill freed lanes the same step: the next admitted prompt
            # prefills now and decodes from the next iteration.
            if completed:
                self._admit(lever, completed)
        self.steps += 1
        if self._metrics is not None:
            st = self.allocator.stats()
            self._metrics["lanes"].set(float(self.in_flight()))
            self._metrics["queue"].set(float(len(self._waiting)))
            self._metrics["free"].set(float(st["free"]))
            self._metrics["avail"].set(float(st["available"]))
        return completed

    def drain(self, max_steps: int = 100000) -> list[dict]:
        """Step until nothing is queued or in flight (pause admission first
        for a swap-style drain of the in-flight requests only)."""
        out: list[dict] = []
        for _ in range(max_steps):
            if not (self.in_flight() or (not self._paused and self._waiting)):
                break
            out.extend(self.step())
        return out
