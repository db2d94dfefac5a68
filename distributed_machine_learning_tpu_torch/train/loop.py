"""Training/eval drivers with the reference's measurement protocol.

Counterpart of ``distributed_machine_learning_tpu/train/loop.py``
(``train_epoch``, ``evaluate``, ``evaluate_lm``): a hard cap at ``max_iters``, per-
iteration wall clock with iteration 0 excluded (where the kernels build
and the first launches land), the loss printed every 20 iterations, and
the same total/average summary lines.  Each step is timed to a host sync
on its loss: PyTorch returns before the device finishes.  A step with an
overlapped parameter gather (``parallel/fsdp.py``, ``overlap=True``) hands
its gather's seconds over through ``pop_gather_seconds()``; they are kept
as the timer's ``param_gather_s`` (the reference's row column of that
name).  No telemetry yet (ROADMAP A6).
"""

from __future__ import annotations

import math
from typing import Iterable

from distributed_machine_learning_tpu_torch.utils.logging import rank0_print
from distributed_machine_learning_tpu_torch.utils.timing import IterationTimer, percentile_stats

# Reference constants (part1/main.py:32-33, 49-50).
MAX_ITERS = 40
LOSS_PRINT_EVERY = 20


def train_epoch(train_step, state, batches: Iterable, place_batch=None,
                max_iters: int = MAX_ITERS,
                loss_print_every: int = LOSS_PRINT_EVERY,
                timer: IterationTimer | None = None, local_loss_rank: int | None = None):
    """One epoch, reference-style: returns ``(state, timer)``.

    ``place_batch(tokens, targets)`` moves a host batch onto the device;
    defaults to identity.  ``local_loss_rank``: every rank prints its own
    loss, tagged with this rank (the reference's per-rank print surface,
    ``part2/2a/main.py:58-61``); otherwise rank 0 prints."""
    timer = timer or IterationTimer(skip_first=1)
    pop_gather = getattr(train_step, "pop_gather_seconds", None)
    for batch_idx, (tokens, targets) in enumerate(batches):
        if batch_idx == max_iters:  # part1/main.py:32-33
            break
        timer.start()
        if place_batch is not None:
            tokens, targets = place_batch(tokens, targets)
        state, loss = train_step(state, tokens, targets)
        loss = loss.item()  # the host sync the step is timed to
        timer.stop()
        if pop_gather is not None:
            # The gather closed at this step's consume: step k reports step
            # k − 1's gather, as the reference's rows do.
            gather_s = pop_gather()
            if gather_s is not None:
                timer.param_gather_s.append(gather_s)
        if (batch_idx + 1) % loss_print_every == 0:  # part1/main.py:49-50
            if local_loss_rank is None:
                rank0_print(f"Loss at {batch_idx + 1}th batch is {loss}")
            else:
                rank0_print(f"Loss at {batch_idx + 1}th batch is {loss} "
                            f"(rank {local_loss_rank})", all_ranks=True)
    rank0_print(timer.summary())  # part1/main.py:57-58
    if timer.param_gather_s:
        p = percentile_stats(timer.param_gather_s)
        rank0_print(f"Param gather p50/max : {p['p50']:.6f}/{p['max']:.6f} seconds "
                    f"({len(timer.param_gather_s)} gathers)")
    return state, timer


def evaluate_lm(eval_step, params, batches: Iterable) -> tuple[float, float]:
    """Corpus-level LM eval: pooled mean NLL/token and perplexity
    (``eval_step`` from ``make_lm_eval_step``; batches of ``(tokens,
    targets)`` already on the device)."""
    total_nll = 0.0
    total_tokens = 0
    for tokens, targets in batches:
        nll, count = eval_step(params, tokens, targets)
        total_nll += float(nll)
        total_tokens += int(count)
    mean_nll = total_nll / max(total_tokens, 1)
    ppl = math.exp(min(mean_nll, 700.0))  # overflow guard for garbage models
    rank0_print(f"Eval: nll/token {mean_nll:.4f}, perplexity {ppl:.2f} "
                f"({total_tokens} tokens)")
    return mean_nll, ppl


def evaluate(eval_step, batches: Iterable, place_batch=None) -> tuple[float, float]:
    """Whole-test-set eval, ``test_model`` parity (``part1/main.py:62-77``):
    the mean of per-batch mean losses and top-1 accuracy, printed as the
    reference prints them.  Every rank evaluates everything (the reference's
    protocol); rank 0 prints."""
    total_loss, correct, total, num_batches = 0.0, 0, 0, 0
    for images, labels in batches:
        if place_batch is not None:
            images, labels = place_batch(images, labels)
        loss, c = eval_step(images, labels)
        total_loss += float(loss)
        correct += int(c)
        total += len(labels)
        num_batches += 1
    avg_loss = total_loss / max(num_batches, 1)
    accuracy = 100.0 * correct / max(total, 1)
    rank0_print("Test set: Average loss: {:.4f}, Accuracy: {}/{} ({:.0f}%)\n".format(
        avg_loss, correct, total, accuracy))
    return avg_loss, accuracy
