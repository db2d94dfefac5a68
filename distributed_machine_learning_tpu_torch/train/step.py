"""The VGG train and eval steps, one process per rank.

Counterpart of ``distributed_machine_learning_tpu/train/step.py``
(``_train_step_impl``, ``make_train_step``, ``make_eval_step``).  The
reference compiles forward, loss, ``jax.grad``, the sync strategy and the
SGD update into one program ``shard_map``-ed over its ranks; here each
rank runs the same sequence eagerly on its own batch:

1. augment (crop/flip from a generator seeded by (seed, rank, step)) or
   just normalize, forward in train mode, mean cross-entropy, backward;
   with ``accum_steps`` k the local batch is split into k equal
   microbatches, each forward and backward in turn, the gradients and
   losses summed and divided by k (BatchNorm's running statistics thread
   through the microbatches; the step keeps the last one's); the
   augmentation draws stay those of the whole batch, row for row;
2. the sync strategy over the ranks (``parallel/strategies.py``), the
   error-feedback residual of a stateful one held here, per rank;
3. BatchNorm's moved running statistics averaged over the ranks (sync BN;
   ``sync_bn=False`` keeps each rank's own, the reference part3's quirk);
4. optional global-norm clip, optional non-finite guard (a bad gradient
   skips the update, the statistics, the residual and the step counter);
5. the optimizer from the state's config, in place, at ``schedule(step)``
   when a schedule is given; the step counter;
6. the loss to print: the mean over the ranks, or this rank's own
   (``local_loss``).

``step(state, images_u8, labels) -> (state, loss)``; the state is updated
in place and returned.  World 1 (part1) runs no collective.
"""

from __future__ import annotations

import time

import torch

from distributed_machine_learning_tpu_torch.data.augment import augment_batch, normalize
from distributed_machine_learning_tpu_torch.parallel.strategies import NoSync
from distributed_machine_learning_tpu_torch.runtime.distributed import Comm
from distributed_machine_learning_tpu_torch.train.common import tree_all_finite
from distributed_machine_learning_tpu_torch.train.losses import (
    count_correct,
    cross_entropy_loss,
)
from distributed_machine_learning_tpu_torch.train.optimizers import update_fn_for_config

SEED = 69143  # part1/main.py:17


class SyncTimer:
    """Time of the sync inside each step: CUDA events around the strategy
    (device timeline: what the stream waited for the wire) on the card, the
    host clock on the CPU.  ``ms()`` resolves the recorded steps."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: list = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, begin) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append((begin, ev))
        else:
            self.spans.append((time.perf_counter() - begin) * 1e3)

    def ms(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.spans]
        return list(self.spans)


def make_train_step(model, strategy=None, comm: Comm | None = None, augment: bool = True,
                    sync_bn: bool = True, clip_norm: float | None = None,
                    guard_nonfinite: bool = False, local_loss: bool = False,
                    seed: int = SEED, sync_timer: SyncTimer | None = None,
                    accum_steps: int = 1, schedule=None):
    """Build ``step(state, images_u8, labels) -> (state, loss)`` for this
    rank (see the module docstring).  ``images_u8`` [b, 32, 32, 3] uint8 and
    ``labels`` [b] on the model's device.

    The returned function also carries ``sync_state()`` /
    ``set_sync_state(res)`` (a stateful strategy's residual, this rank's)
    and ``observe``: when set, ``observe(synced_grads, residual)`` is called
    every step right after the sync."""
    comm = comm or Comm()
    strategy = strategy or NoSync()
    if comm.world > 1 and isinstance(strategy, NoSync):
        raise ValueError("strategy 'none' (part1) cannot run on more than one rank: "
                         "gradients would not be synchronized and replicas would diverge")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    holder = {"res": None}

    def forward_backward(state, images_u8, labels):
        """Summed-then-averaged gradients in ``p.grad`` and the mean loss;
        BN's moved statistics recorded for ``model.new_batch_stats()``."""
        b = images_u8.shape[0]
        if b % accum_steps:
            raise ValueError(f"per-device batch {b} not divisible by "
                             f"accum_steps={accum_steps}")
        if augment:
            x = augment_batch(images_u8, seed, comm.rank, state.step)
        else:
            x = normalize(images_u8)
        model.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss = cross_entropy_loss(model(x, train=True), labels)
            loss.backward()
            return loss.detach(), None
        m = b // accum_steps
        # The buffers as they were, before the thread through the microbatches
        # moves them.
        saved = ([t.clone() for bn in model.bns for t in (bn.running_mean, bn.running_var)]
                 if len(model.bns) else None)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(accum_steps):
            micro = cross_entropy_loss(model(x[j * m:(j + 1) * m], train=True),
                                       labels[j * m:(j + 1) * m])
            micro.backward()  # autograd sums each microbatch's gradient into p.grad
            loss = loss + micro.detach()
            if saved is not None and j < accum_steps - 1:
                model.set_batch_stats(model.new_batch_stats())
        with torch.no_grad():
            for p in params:
                p.grad.div_(accum_steps)
        return loss / accum_steps, saved

    def step(state, images_u8, labels):
        loss, saved = forward_backward(state, images_u8, labels)
        stats = model.new_batch_stats()
        if saved is not None:
            model.set_batch_stats(saved)  # installed below only if the update runs
        grads = [p.grad for p in params]
        res = holder["res"]
        if comm.world > 1:
            begin = sync_timer.start() if sync_timer is not None else None
            if strategy.stateful:
                if res is None:
                    res = strategy.init_state(grads)
                grads, res = strategy.apply(grads, res, comm)
            else:
                grads = strategy(grads, comm)
            if sync_timer is not None:
                sync_timer.stop(begin)
        if step.observe is not None:
            step.observe(grads, res)
        with torch.no_grad():
            if stats and sync_bn and comm.world > 1:
                stats = [comm.all_reduce_(s).div_(comm.world) for s in stats]
            if clip_norm is not None:
                from distributed_machine_learning_tpu_torch.train.schedule import (
                    clip_by_global_norm,
                )

                grads = clip_by_global_norm(grads, clip_norm)
            if not guard_nonfinite or bool(tree_all_finite(grads)):
                update_fn_for_config(state.config)(
                    state.params, state.momentum, dict(zip(names, grads)), state.config,
                    lr=None if schedule is None else schedule(state.step), step=state.step)
                if stats:
                    model.set_batch_stats(stats)
                holder["res"] = res
                state.step += 1
            if comm.world > 1 and not local_loss:
                loss = comm.all_reduce_(loss.clone()).div_(comm.world)
        return state, loss

    step.observe = None
    step.sync_state = lambda: holder["res"]
    step.set_sync_state = lambda res: holder.__setitem__("res", res)
    return step


def make_eval_step(model, comm: Comm | None = None):
    """``eval_step(images_u8, labels) -> (batch mean loss, correct count)``:
    normalize only, BN from its running statistics (``test_model`` parity,
    ``part1/main.py:62-77``).

    With a ``comm`` of more than one rank (``--dist-eval``) the batch is
    sharded: rank r scores rows [r·n/W, (r+1)·n/W) and one all-reduce of
    (shard mean loss, shard correct count) gives the mean of the shard
    means and the summed count on every rank, the reference's
    ``pmean``/``psum``.  A batch whose length the world does not divide
    runs unsharded.  Each rank scores with its own BN statistics (under
    ``--unsync-bn`` they differ, as the reference's quirk-mode eval mixes
    per-device rows)."""

    @torch.no_grad()
    def single(images_u8, labels):
        logits = model(normalize(images_u8), train=False)
        return cross_entropy_loss(logits, labels), count_correct(logits, labels)

    if comm is None or comm.world == 1:
        return single

    @torch.no_grad()
    def eval_step(images_u8, labels):
        n, w = len(labels), comm.world
        if n % w:
            return single(images_u8, labels)
        lo, hi = comm.rank * n // w, (comm.rank + 1) * n // w
        loss, correct = single(images_u8[lo:hi], labels[lo:hi])
        both = comm.all_reduce_(torch.stack([loss, correct.float()]))
        return both[0] / w, both[1].round().long()

    return eval_step
