"""The interleaved pipeline schedule: v virtual stages a rank cut the bubble.

Counterpart of ``distributed_machine_learning_tpu/parallel/pipeline_interleaved.py``
(Megatron's virtual pipeline stages).  Each rank holds v non-contiguous
chunks of layers, chunk c of stage s being the global span c·P + s, so a
microbatch visits every rank v times and the bubble drops to
(P−1)/(v·M+P−1).  The forward ticks decode their work from u = t − s as the
reference's do (``pipeline.gpipe_table``: microbatches in groups of P,
i = u mod P, c = (u div P) mod v, g = u div (v·P)); the output of the last
rank's chunk c goes to the first rank's chunk c+1 (the one hop that wraps
around); the backward runs the forward ticks in reverse, as ``jax.grad`` of
the reference's tick loop does, so activation memory is O(v·M) per rank,
GPipe's.  The stacked layout stores each rank's chunks contiguously, chunk
after chunk (:func:`stack_interleaved`), under its own layout tag.
"""

from __future__ import annotations

import re

from distributed_machine_learning_tpu_torch.parallel.pipeline import (
    check_pipeline,
    gpipe_table,
    make_pipeline_step,
    stack_lm_params,
    unstack_lm_params,
)


def interleaved_layout_tag(num_stages: int, v: int) -> str:
    """The checkpoint layout tag of this stacking; the one encoder
    :func:`parse_interleaved_layout` inverts."""
    return f"pp-interleaved-P{num_stages}-v{v}"


def parse_interleaved_layout(tag) -> tuple[int, int] | None:
    """(num_stages, v) of an interleaved layout tag; None for another
    layout.  A tag that claims to be interleaved but does not parse raises:
    a contiguous unstack would load permuted layers."""
    tag = tag or ""
    m = re.fullmatch(r"pp-interleaved-P(\d+)-v(\d+)", tag)
    if m:
        return int(m.group(1)), int(m.group(2))
    if tag.startswith("pp-interleaved-"):
        raise ValueError(f"unrecognized interleaved pipeline layout tag {tag!r} (expected "
                         "'pp-interleaved-P<stages>-v<chunks>'); refusing to fall back to a "
                         "contiguous unstack, which would permute layer weights")
    return None


def _interleaved_order(n_layers: int, num_stages: int, v: int) -> list[int]:
    """Global layer indices in the interleaved stacking order: for each
    stage s, its v chunks (span c·P + s) in chunk order."""
    lc = n_layers // (num_stages * v)
    return [layer
            for s in range(num_stages)
            for c in range(v)
            for layer in range((c * num_stages + s) * lc, (c * num_stages + s + 1) * lc)]


def stack_interleaved(params: dict, n_layers: int, num_stages: int, v: int) -> dict:
    """Per-layer parameters → the interleaved pipeline layout."""
    return stack_lm_params(params, n_layers, _interleaved_order(n_layers, num_stages, v))


def unstack_interleaved(params: dict, n_layers: int, num_stages: int, v: int) -> dict:
    """The inverse of :func:`stack_interleaved`."""
    return unstack_lm_params(params, n_layers, _interleaved_order(n_layers, num_stages, v))


def check_interleaved(model, num_stages: int, v: int) -> None:
    if v < 1:
        raise ValueError(f"v (virtual stages per device) must be >= 1, got {v}")
    if model.n_layers % (num_stages * v):
        raise ValueError(f"n_layers={model.n_layers} must divide evenly into {num_stages} "
                         f"stages x {v} chunks")


def init_interleaved_state(model, pipe, v: int, seed: int = 69143, config=None):
    """The seeded replicated state as this rank's v chunks."""
    from distributed_machine_learning_tpu_torch.parallel.pipeline import init_pipeline_state

    check_interleaved(model, pipe.world, v)
    return init_pipeline_state(model, pipe, seed=seed, config=config, v=v)


def make_pp_interleaved_lm_train_step(model, pipe, num_microbatches: int, v: int):
    """The interleaved ``step(state, tokens_mb, targets_mb)`` (state from
    :func:`init_interleaved_state`); v = 1 is GPipe's schedule exactly."""
    check_interleaved(model, pipe.world, v)
    check_pipeline(model, pipe.world, num_microbatches)
    return make_pipeline_step(model, pipe, num_microbatches,
                              gpipe_table(num_microbatches, pipe.world, v))
