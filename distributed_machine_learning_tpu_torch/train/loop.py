"""Training/eval drivers with the reference's measurement protocol.

Counterpart of ``distributed_machine_learning_tpu/train/loop.py``
(``train_epoch``, ``evaluate_lm``): a hard cap at ``max_iters``, per-
iteration wall clock with iteration 0 excluded (where the kernels build
and the first launches land), the loss printed every 20 iterations, and
the same total/average summary lines.  Each step is timed to a host sync
on its loss: PyTorch returns before the device finishes.  No telemetry
yet (ROADMAP A6).
"""

from __future__ import annotations

import math
from typing import Iterable

from distributed_machine_learning_tpu_torch.utils.logging import rank0_print
from distributed_machine_learning_tpu_torch.utils.timing import IterationTimer

# Reference constants (part1/main.py:32-33, 49-50).
MAX_ITERS = 40
LOSS_PRINT_EVERY = 20


def train_epoch(train_step, state, batches: Iterable, place_batch=None,
                max_iters: int = MAX_ITERS,
                loss_print_every: int = LOSS_PRINT_EVERY,
                timer: IterationTimer | None = None):
    """One epoch, reference-style: returns ``(state, timer)``.

    ``place_batch(tokens, targets)`` moves a host batch onto the device;
    defaults to identity."""
    timer = timer or IterationTimer(skip_first=1)
    for batch_idx, (tokens, targets) in enumerate(batches):
        if batch_idx == max_iters:  # part1/main.py:32-33
            break
        timer.start()
        if place_batch is not None:
            tokens, targets = place_batch(tokens, targets)
        state, loss = train_step(state, tokens, targets)
        loss = loss.item()  # the host sync the step is timed to
        timer.stop()
        if (batch_idx + 1) % loss_print_every == 0:  # part1/main.py:49-50
            rank0_print(f"Loss at {batch_idx + 1}th batch is {loss}")
    rank0_print(timer.summary())  # part1/main.py:57-58
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
