"""Run summary banners: the parameter table part1 prints before training,
and the resilience event table.

Counterpart of ``model_summary`` and ``resilience_summary`` in
``distributed_machine_learning_tpu/utils/summary.py``: the reference prints
a torchsummary table (``part1/main.py:118``) whose ~9.2M-parameter total
its report leans on.  One row per module that owns parameters, with their
shapes and count, then the total and its f32 size.  The resilience table
lists every nonzero ``runtime/faults.FaultEvents`` counter of a run.
"""

from __future__ import annotations

from torch import nn


def model_summary(model: nn.Module, title: str = "Model") -> str:
    groups: dict = {}
    for name, p in model.named_parameters():
        owner = name.rsplit(".", 1)[0]
        groups.setdefault(owner, []).append(p)
    width = 24
    rows = [f"  {owner:<{width}} {sum(p.numel() for p in ps):>12,}  "
            f"[{' '.join('x'.join(str(d) for d in p.shape) for p in ps)}]"
            for owner, ps in groups.items()]
    total = sum(p.numel() for p in model.parameters())
    return "\n".join([
        f"{title} summary", "-" * 64, *rows, "-" * 64,
        f"  {'Total params':<{width}} {total:>12,}",
        f"  {'Size (fp32)':<{width}} {total * 4 / 2**20:>10.2f} MB",
        "-" * 64,
    ])


_EVENT_LABELS = {
    "skipped_steps": "updates skipped (non-finite grads)",
    "scaler_backoffs": "loss-scale halvings (overflow)",
    "scaler_growths": "loss-scale doublings",
    "loader_retries": "data-loader retries",
    "skipped_batches": "bad batches skipped",
    "stalls": "watchdog stalls declared",
    "restarts": "supervisor restarts",
    "preemptions": "preemption stops",
    "ckpt_kills": "injected mid-checkpoint kills",
    "rank_kills": "injected rank deaths",
    "rank_losses": "injected permanent rank losses",
    "rank_recoveries": "injected rank recoveries",
    "rank_stalls": "injected rank stalls",
    "ckpt_corruptions": "injected checkpoint corruptions",
    "peer_failures": "gang peers declared dead/stalled",
    "stragglers": "straggler advisories (slow ranks)",
    "gang_restarts": "gang coordinated restarts",
    "gang_shrinks": "gang shrinks to survivors",
    "gang_grows": "gang grows (joins/promotions admitted)",
    "spare_promotions": "warm spares promoted to live ranks",
    "spare_demotions": "live ranks demoted to spares",
    "reshard_restores": "restores resharded across world sizes",
    "ckpt_verify_failures": "checkpoints failing verification",
    "ckpt_fallbacks": "restores fell back past bad checkpoints",
    "transport_retries": "gang-transport ops retried (backoff)",
    "transport_timeouts": "gang-transport ops timed out/dropped",
    "replica_evictions": "serving replicas evicted (dead/slow)",
    "drains": "serving replicas drained gracefully",
    "request_rejects": "serving requests rejected (overload)",
    "weight_swaps": "replica weight hot-swaps committed",
    "canary_promotions": "deploys promoted after clean canary",
    "canary_rollbacks": "deploys rolled back (regression/burn)",
}


def resilience_summary(events, title: str = "Resilience") -> str:
    """The robustness counters table (``runtime/faults.FaultEvents``) in
    the same banner style as ``model_summary`` — printed at the end of a
    supervised/fault-injected run so recoveries are observable, not
    silent.  All-zero counters render as a one-line clean bill."""
    counts = events.as_dict()
    width = 36
    rows = [
        f"  {_EVENT_LABELS.get(name, name):<{width}} {count:>8,}"
        for name, count in counts.items()
        if count
    ]
    if not rows:
        return f"{title}: no fault events (clean run)"
    lines = [
        f"{title} summary",
        "-" * 64,
        *rows,
        "-" * 64,
        f"  {'Total events':<{width}} {sum(counts.values()):>8,}",
        "-" * 64,
    ]
    return "\n".join(lines)
