"""Train-to-serve continuous deployment onto a live serving fleet.

Counterpart of ``distributed_machine_learning_tpu/runtime/deploy.py``.  A
:class:`DeployController` watches a training run's checkpoint directory
and rolls each new verified step onto the fleet (``runtime/serving.py``'s
router, ``runtime/serving_worker.py``'s replicas) with no dropped request:

1. **Watch**: ``latest_checkpoint`` walks the steps newest first through
   the verified chain (quarantined directories skipped, torn or
   digest-mismatched ones quarantined and counted).
2. **Restore and requantize**: :func:`load_serving_weights` restores the
   state (dp, or zero1/fsdp flat vectors unraveled through the model's
   parameters) onto the serving world (1), quantizes the parameters to int8
   with the serving quantizer (``ops/quant.py``'s ``quantize_lm_params``,
   what ``quantize_lm`` loads), then re-verifies the f32 bytes the
   quantizer consumed against the manifest's leaf digests.
3. **Fenced hot swap**, replica by replica, over the transport's
   versioned-weights channel: ``set_weights`` stages the version (the
   replica keeps serving old-version work), the worker drains and calls
   its ``on_swap`` (for an engine replica: ``ContinuousEngine.swap_params``
   with the controller's loaded weights, :attr:`DeployController.loaded`),
   then ``commit_weights`` moves the fence.
4. **Canary**: the router steers every Nth dispatch at the swapped
   replicas; the controller compares the canary's quality probe and
   latency with the stable version's over a window, with a deploy-scoped
   ``SLOEngine`` on the canary's outcomes.  The window and the latency
   gate count only the canary completions submitted after the slice
   opened: a request admitted before it waited in the canary replica's
   queue through the weight swap, and its latency is the swap's pause, not
   the new weights' service (under a loaded host that pause alone read
   3.8× the stable p50 and rolled a correct deploy back).
5. **Promote or roll back**: a clean window swaps the rest of the fleet
   (``canary_promotions``); a regression re-swaps every touched replica to
   the prior version (``canary_rollbacks``).  Every edge lands in the
   health ledger and in ``FaultEvents``.

The digest of the quantized weights (:func:`tree_digest`) is the deployed
version's identity in the port; it is not meant to equal the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from distributed_machine_learning_tpu_torch.runtime.faults import FaultEvents
from distributed_machine_learning_tpu_torch.train.checkpoint import (
    CheckpointVerifyError,
    _host_leaf,
    checkpoint_manifest,
    latest_checkpoint,
    quarantine_checkpoint,
    reshard_restore,
)


def _sha256(t) -> str:
    """sha256 of a tensor's raw bytes (as a checkpoint leaf digests them)."""
    return hashlib.sha256(memoryview(_host_leaf(t, copy=False)[2]).cast("B")).hexdigest()


def tree_digest(tree: dict) -> str:
    """sha256 over a state_dict's tensors in its order (dtype, shape, bytes
    of each): two deploys of bit-identical serving weights share it, and the
    swap history ties a served answer to the weights that made it."""
    h = hashlib.sha256()
    for t in tree.values():
        dtype, shape, arr = _host_leaf(t, copy=False)
        h.update(dtype.encode())
        h.update(str(shape).encode())
        h.update(memoryview(arr).cast("B"))
    return h.hexdigest()


def load_serving_weights(path, template_params: dict | None = None, *, events=None) -> dict:
    """Checkpoint → serving weights, through the whole verified chain.

    Restores the state at ``path`` onto world 1 (``reshard_restore``: file
    and leaf digests verified there, quarantine on a mismatch).  A dp
    checkpoint carries its parameters by name; a zero1/fsdp one (flat padded
    vectors) is cut to its logical prefix and unraveled through
    ``template_params`` (the model's parameters by name: their order and
    shapes are the port's flat order, which the flat layouts do not
    record).  The parameters are quantized to int8 (``quantize_lm_params``),
    then the post-requantize check: the sha256 of the f32 bytes the
    quantizer consumed, taken after it ran, against the manifest's leaf
    digests (dp: each ``params/<name>``; flat: the parameters raveled again
    in the port's order against the flat leaf's logical digest).  A mismatch
    quarantines the checkpoint and raises :class:`CheckpointVerifyError`.

    Returns ``{"params", "quantized", "meta", "spec"}``: the float
    state_dict (CPU), its int8 twin's, the ``set_weights`` payload
    ``{"step", "path", "digest", "layout"}`` (``digest``: of the quantized
    weights) and the ShardSpec."""
    import torch

    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm_params

    path = os.path.abspath(os.fspath(path))
    leaves = (checkpoint_manifest(path) or {}).get("leaves", {})
    state, spec = reshard_restore(path, world=1, events=events)
    if spec.layout == "dp":
        params = state.params
        with ThreadPoolExecutor(8) as pool:
            expected = ({k: leaves.get(f"params/{k}", {}).get("sha256") for k in params}
                        if leaves else dict(zip(params, pool.map(_sha256, params.values()))))
            quantized = quantize_lm_params(params)
            got = dict(zip(params, pool.map(_sha256, params.values())))
    else:
        if template_params is None:
            raise ValueError(f"restoring a {spec.layout} checkpoint for serving needs "
                             "template_params (the flat layouts don't record the unravel)")
        flat_key = "param_shards" if spec.layout == "fsdp" else "param_flat"
        vec = state.param_shard if spec.layout == "fsdp" else state.param_flat
        logical = vec[:spec.n_elems]
        params, off = {}, 0
        for name, t in template_params.items():
            params[name] = logical[off:off + t.numel()].view(t.shape)
            off += t.numel()
        if off != spec.n_elems:
            raise ValueError(f"template_params hold {off} elements, the checkpoint's flat "
                             f"vectors {spec.n_elems}")
        expected = {flat_key: leaves.get(flat_key, {}).get("sha256") or _sha256(logical)}
        quantized = quantize_lm_params(params)
        got = {flat_key: _sha256(torch.cat([t.reshape(-1) for t in params.values()]))}
    bad = sorted(k for k in got if got[k] != expected[k])
    if bad:
        quarantine_checkpoint(path, f"post-requantize digest mismatch ({bad[0]}: "
                                    f"{got[bad[0]][:12]}…)")
        if events is not None:
            events.ckpt_verify_failures += 1
        raise CheckpointVerifyError(
            f"checkpoint {path}: serving params failed post-requantize verification "
            f"({len(bad)} leaves, first {bad[0]}: got {got[bad[0]][:12]}…, want "
            f"{str(expected[bad[0]])[:12]}…)")
    meta = {"step": int(state.step), "path": path, "digest": tree_digest(quantized),
            "layout": spec.layout}
    return {"params": params, "quantized": quantized, "meta": meta, "spec": spec}


@dataclasses.dataclass
class DeployConfig:
    """Controller policy; ``cli/deploy.py`` maps its flags onto these."""

    checkpoint_dir: str = ""
    canary_replicas: int = 1     # how many replicas take the canary
    canary_every_n: int = 3      # traffic slice: every Nth dispatch
    canary_window: int = 12      # canary completions (submitted after the slice opened) to judge
    max_latency_ratio: float = 3.0  # canary p50 vs stable p50 gate
    max_bad_ratio: float = 0.0   # quality-probe failure ratio tolerated
    commit_timeout_s: float = 5.0   # per-replica wait for the worker's commit
    judge_timeout_s: float = 30.0   # canary window fill deadline
    poll_s: float = 0.01         # watcher cadence
    slo: tuple = ()              # canary-scoped objectives ("p99<=250ms",)
    burn_threshold: float = 2.0


class DeployController:
    """The deployment state machine: ``idle → swapping → canary →
    promoted | rolled_back``.

    Takes the fleet's transport and its ``ServingRouter``, registers itself
    as the router's ``on_complete`` hook (latency and weights version of
    every outcome) and drives swaps over the versioned-weights channel.
    ``quality_fn(outcome) -> bool`` is the deploy-time quality probe;
    ``now_fn`` a clock for the SLO windows (tests).

    :attr:`loaded` maps each version this controller loaded to
    :func:`load_serving_weights`' output (the candidate and the deployed
    version are kept; older ones are dropped): a replica's ``on_swap``
    reads the weights of the version it was staged from there.
    """

    def __init__(self, tx, router, cfg: DeployConfig, *,
                 events: FaultEvents | None = None, telemetry=None, quality_fn=None,
                 now_fn=None):
        self.tx = tx
        self.router = router
        self.cfg = cfg
        self.events = events if events is not None else router.events
        self._tel = telemetry
        self._quality = quality_fn
        self._now = now_fn if now_fn is not None else time.monotonic
        self._lock = threading.Lock()
        self._stats: dict[int, dict] = {}
        self._slo = None          # deploy-scoped engine, one per canary
        self._candidate: int | None = None  # version the canary judges
        self._opened: float | None = None   # monotonic time the canary slice opened
        self._canary_lat: list[float] = []  # latencies submitted after it opened
        self.state = "idle"
        self.deployed_version = 0
        self.deployed_meta: dict = {}
        self.history: list[dict] = []   # every committed swap, in order
        self.deploys: list[dict] = []   # one row per deploy() outcome
        self.loaded: dict[int, dict] = {}
        self._last_step: int | None = None
        self._seq = 0
        self._pending: dict | None = None
        router.on_complete = self._on_complete

    # -- the router's per-outcome feed -----------------------------------
    def _on_complete(self, outcome: dict) -> None:
        v = outcome.get("version")
        if v is None:
            return
        v = int(v)
        lat = outcome.get("latency_s")
        ok = True if self._quality is None else bool(self._quality(outcome))
        with self._lock:
            st = self._stats.get(v)
            if st is None:
                st = self._stats[v] = {"count": 0, "bad": 0, "lat": deque(maxlen=256)}
            st["count"] += 1
            if not ok:
                st["bad"] += 1
            if lat is not None:
                st["lat"].append(float(lat))
                if (v == self._candidate and self._opened is not None
                        and time.monotonic() - float(lat) >= self._opened):
                    self._canary_lat.append(float(lat))
            if self._slo is not None and v == self._candidate:
                self._slo.observe(latency_s=lat, error=not ok, now=self._now())

    def _stats_since(self, version: int, base: dict) -> dict:
        """Counts since the canary opened (``base``: the per-version tallies
        at deploy start); p50 over the recent-latency window."""
        st = self._stats.get(version) or {"count": 0, "bad": 0, "lat": deque()}
        b = base.get(version) or {"count": 0, "bad": 0}
        lats = sorted(st["lat"])
        return {"count": st["count"] - b["count"], "bad": st["bad"] - b["bad"],
                "p50": lats[len(lats) // 2] if lats else None}

    # -- one replica's two-phase swap ------------------------------------
    def _swap(self, rank: int, version: int, meta: dict, *, why: str) -> bool:
        """Stage ``version`` on ``rank`` and wait for the worker's commit.
        True iff the committed version reached ``version`` in time (a replica
        that dies mid-swap times out here; the caller rolls back)."""
        cur = self.tx.read_serving(rank).get("weights") or {}
        if int(cur.get("version", 0) or 0) == int(version):
            self.router.note_weights(rank, version)
            return True
        self.tx.set_weights(rank, version, meta)
        deadline = time.monotonic() + self.cfg.commit_timeout_s
        while time.monotonic() < deadline:
            rec = self.tx.read_serving(rank).get("weights") or {}
            if int(rec.get("version", 0) or 0) == int(version):
                self.router.note_weights(rank, version)
                self.events.weight_swaps += 1
                self.history.append({"rank": rank, "version": int(version),
                                     "step": meta.get("step"), "why": why,
                                     "digest": meta.get("digest")})
                self.tx.append_health_event("weight_swap", rank=rank, version=int(version),
                                            step=meta.get("step"), why=why)
                if self._tel is not None:
                    self._tel.tracer.instant("weight_swap", rank=rank, version=int(version))
                return True
            time.sleep(self.cfg.poll_s)
        return False

    def _live_ranks(self) -> list[int]:
        return sorted(self.router.audit()["weight_versions"])

    # -- the deploy state machine ----------------------------------------
    def deploy(self, path, *, wait: bool = True) -> dict:
        """Roll the checkpoint at ``path`` onto the fleet; returns the deploy
        row, ``{"outcome": "promoted" | "rolled_back", ...}``.
        ``wait=False`` stops after the canary swap (the caller then drives
        :meth:`judge`, e.g. to kill replicas mid-window)."""
        loaded = load_serving_weights(path, events=self.events)
        meta = loaded["meta"]
        self._seq += 1
        version = self._seq
        self.loaded[version] = loaded
        prev_version, prev_meta = self.deployed_version, self.deployed_meta
        ranks = self._live_ranks()
        canary = ranks[: max(1, self.cfg.canary_replicas)]
        rest = [r for r in ranks if r not in canary]
        with self._lock:
            self._candidate = version
            self._slo = self._make_slo()
            base = {v: {"count": st["count"], "bad": st["bad"]}
                    for v, st in self._stats.items()}
        self.state = "swapping"
        swapped: list[int] = []
        for rank in canary:
            if self._swap(rank, version, meta, why="canary"):
                swapped.append(rank)
            else:
                return self._rollback(swapped, version, prev_version, prev_meta,
                                      reason=f"replica {rank} failed to commit v{version}")
        with self._lock:
            self._opened = time.monotonic()
            self._canary_lat = []
        self.router.set_canary(canary, self.cfg.canary_every_n)
        self.state = "canary"
        self.tx.append_health_event("deploy_canary", version=version, step=meta.get("step"),
                                    ranks=list(canary), every_n=self.cfg.canary_every_n)
        ctx = {"version": version, "meta": meta, "canary": canary, "rest": rest,
               "swapped": swapped, "prev_version": prev_version, "prev_meta": prev_meta,
               "base": base}
        if not wait:
            self._pending = ctx
            return {"outcome": "canary", "version": version}
        return self.judge(ctx)

    def judge(self, ctx: dict | None = None) -> dict:
        """Fill the canary window, compare the versions, then promote or
        roll back."""
        if ctx is None:
            ctx = self._pending
        version, meta = ctx["version"], ctx["meta"]
        prev_version, prev_meta = ctx["prev_version"], ctx["prev_meta"]
        base = ctx["base"]
        deadline = time.monotonic() + self.cfg.judge_timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                cn = len(self._canary_lat)
            if cn >= self.cfg.canary_window:
                break
            time.sleep(self.cfg.poll_s)
        with self._lock:
            cstat = self._stats_since(version, base)
            lats = sorted(self._canary_lat)
            cstat["p50"] = lats[len(lats) // 2] if lats else None
            sstat = self._stats_since(prev_version, base)
            alerts = list(self._slo.alerts) if self._slo else []
        reason = None
        if cstat["count"] == 0:
            reason = "canary starved: no completions in the window"
        elif cstat["bad"] > self.cfg.max_bad_ratio * cstat["count"]:
            reason = (f"quality regression: {cstat['bad']}/{cstat['count']} canary "
                      "answers failed the probe")
        elif alerts:
            reason = (f"SLO burn on canary: {alerts[0]['slo']} "
                      f"(short burn {alerts[0]['short_burn']:.1f}x)")
        elif (cstat["p50"] is not None and sstat["p50"] is not None
              and sstat["p50"] > 0
              and cstat["p50"] > self.cfg.max_latency_ratio * sstat["p50"]):
            reason = (f"latency regression: canary p50 {cstat['p50']:.4f}s vs stable "
                      f"{sstat['p50']:.4f}s (> {self.cfg.max_latency_ratio:.1f}x)")
        if reason is not None:
            return self._rollback(ctx["swapped"], version, prev_version, prev_meta,
                                  reason=reason)
        for rank in ctx["rest"]:  # a clean window: promote the rest of the fleet
            if self._swap(rank, version, meta, why="promote"):
                ctx["swapped"].append(rank)
            else:
                return self._rollback(ctx["swapped"], version, prev_version, prev_meta,
                                      reason=f"replica {rank} failed to commit "
                                             f"v{version} during promote")
        self.router.clear_canary()
        self.state = "promoted"
        self.deployed_version = version
        self.deployed_meta = meta
        self.events.canary_promotions += 1
        self.tx.append_health_event("deploy_promote", version=version,
                                    step=meta.get("step"), canary=cstat, stable=sstat)
        row = {"outcome": "promoted", "version": version, "step": meta.get("step"),
               "canary": cstat, "stable": sstat}
        self.deploys.append(row)
        self._teardown_canary()
        return row

    def _rollback(self, swapped: list[int], version: int, prev_version: int,
                  prev_meta: dict, *, reason: str) -> dict:
        """Re-swap every touched replica to the prior version; counted and
        ledgered.  A replica that fails the rollback commit too (it died) is
        left to the router's beat-staleness eviction."""
        self.router.clear_canary()
        failed = [rank for rank in swapped
                  if not self._swap(rank, prev_version, prev_meta, why="rollback")]
        self.state = "rolled_back"
        self.events.canary_rollbacks += 1
        self.tx.append_health_event("deploy_rollback", version=version,
                                    to_version=prev_version, reason=reason,
                                    unrecovered=failed)
        row = {"outcome": "rolled_back", "version": version, "to_version": prev_version,
               "reason": reason, "unrecovered": failed}
        self.deploys.append(row)
        self._teardown_canary()
        return row

    def _teardown_canary(self) -> None:
        with self._lock:
            self._candidate = None
            self._opened = None
            self._slo = None
        self._pending = None
        self.loaded = {v: w for v, w in self.loaded.items() if v == self.deployed_version}

    def _make_slo(self):
        if not self.cfg.slo:
            return None
        from distributed_machine_learning_tpu_torch.telemetry.slo import SLOEngine

        return SLOEngine(self.cfg.slo, burn_threshold=self.cfg.burn_threshold,
                         now_fn=self._now)

    # -- the watcher -----------------------------------------------------
    def poll_once(self) -> dict | None:
        """One watcher iteration: deploy the newest verified checkpoint if it
        is newer than the last one deployed or attempted (a checkpoint that
        rolled back is not retried)."""
        if not self.cfg.checkpoint_dir:
            return None
        path = latest_checkpoint(self.cfg.checkpoint_dir, self.events)
        if path is None:
            return None
        step = int(os.path.basename(path)[5:])
        if self._last_step is not None and step <= self._last_step:
            return None
        self._last_step = step
        try:
            return self.deploy(path)
        except CheckpointVerifyError as exc:
            # load_serving_weights quarantined it; the next poll walks the
            # fallback chain past it.
            self.tx.append_health_event("deploy_verify_failed", step=step, error=str(exc))
            self._last_step = step - 1 if step > 0 else None
            return {"outcome": "verify_failed", "step": step, "error": str(exc)}

    def run(self, stop_event: threading.Event, interval_s: float = 0.1) -> None:
        """The watcher loop: the controller's own thread target."""
        while not stop_event.is_set():
            self.poll_once()
            stop_event.wait(interval_s)

    def summary(self) -> dict:
        """The deployment view ``tools/serve_status.py`` renders."""
        with self._lock:
            per_version = {v: {"count": st["count"], "bad": st["bad"]}
                           for v, st in sorted(self._stats.items())}
        return {"state": self.state, "deployed_version": self.deployed_version,
                "deployed_step": self.deployed_meta.get("step"),
                "swaps": len(self.history), "history": list(self.history),
                "deploys": list(self.deploys), "per_version": per_version}
