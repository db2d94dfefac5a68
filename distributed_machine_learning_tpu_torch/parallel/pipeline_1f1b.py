"""The 1F1B pipeline schedule: one backward per forward, O(P) activations.

Counterpart of ``distributed_machine_learning_tpu/parallel/pipeline_1f1b.py``
(PipeDream-flush, the CLI's default schedule).  GPipe
(``parallel/pipeline.py``) runs every forward before any backward, so a
stage holds all M microbatches' activations; here, after P−1 warm-up ticks
of forwards, every tick runs one forward, then one backward, on each
stage:

- warm-up tick t (0..P−2): stage s forwards microbatch t − s;
- steady tick u (0..M+P−2): stage s forwards microbatch u + P−1−s, then
  backwards microbatch u − (P−1−s) (each where it exists; on the last stage
  the same microbatch, forwarded first).

A stage so holds at most 2(P−1−s)+1 microbatches' graphs, whatever M.  The
reference recomputes each span from its stored input under ``jax.vjp`` (a
scan body cannot keep a graph); the port keeps the forward's autograd graph
and runs ``torch.autograd.backward(y, grad)`` on it.  The bubble is GPipe's,
(P−1)/(M+P−1), and the update is GPipe's (the same gradients, summed over
the microbatches in another order): ``pipeline.make_pipeline_step`` runs
the table, the state and inputs are GPipe's.
"""

from __future__ import annotations

from distributed_machine_learning_tpu_torch.parallel.pipeline import (
    check_pipeline,
    make_pipeline_step,
)


def one_f_one_b_table(M: int, P: int) -> list:
    """Per stage, the ticks' ``(forward, backward)`` items ``(m, k)`` (k = s)
    of the 1F1B order (see the module note)."""
    table = []
    for s in range(P):
        ticks = []
        for t in range(P - 1):
            m = t - s
            ticks.append(((m, s) if 0 <= m < M else None, None))
        for u in range(M + P - 1):
            f, b = u + P - 1 - s, u - (P - 1 - s)
            ticks.append(((f, s) if 0 <= f < M else None, (b, s) if 0 <= b < M else None))
        table.append(ticks)
    return table


def make_pp_1f1b_lm_train_step(model, pipe, num_microbatches: int):
    """The 1F1B ``step(state, tokens_mb, targets_mb)``: a drop-in for
    ``make_pp_lm_train_step`` (the same state, inputs and update; O(P)
    activation memory instead of O(M))."""
    check_pipeline(model, pipe.world, num_microbatches)
    return make_pipeline_step(model, pipe, num_microbatches,
                              one_f_one_b_table(num_microbatches, pipe.world))
