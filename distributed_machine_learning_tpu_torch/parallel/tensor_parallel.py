"""Tensor-parallel decode: the Megatron layout, one process per rank.

Counterpart of the decode half of
``distributed_machine_learning_tpu/parallel/tensor_parallel.py``
(``tp_decode_spec_for``, ``tp_decode_params``) and of
``inference/generate.py``'s ``tp_local_decode_clone``.  The reference
runs every rank inside one ``shard_map``; here each rank is a process
(``cli.generate --tp N`` spawns them) holding its slice of the weights:

- column-parallel (``qkv``, ``q``, ``kv``, ``fc_in``; each expert's
  ``w_in``/``b_in``): this rank's block of heads (of ``d_ff``) of the
  output features.  A fused projection's parts (q/k/v, k/v) are sliced
  each on its own, so the rank's local layout is the fused one at H/tp;
- row-parallel (``out``, ``fc_out``; each expert's ``w_out``): this rank's
  block of the input features, the bias divided by tp (the model's sum over
  the ranks adds it back), an int8 projection's per-output-channel scales
  whole (they commute with the sum);
- whole on every rank: the embedding, the LayerNorms, the head and the MoE
  router (every rank routes alike).

Int8 weights are quantized from the global model before they are sliced,
so each rank's scales are the global ones.  Training-time tensor
parallelism (``make_tp_lm_train_step``) is ROADMAP A5c.
"""

from __future__ import annotations

import torch

# Column-parallel projections: module name → the parts a fused output
# feature axis holds (each part is H·D, or d_ff, features).
_COLUMN = {"qkv": 3, "q": 1, "kv": 2, "fc_in": 1}
_ROW = ("out", "fc_out")


def check_tp_layout(model, tp: int) -> None:
    """The reference's divisibility rules of the Megatron decode layout."""
    if model.n_heads % tp:
        raise ValueError(f"n_heads={model.n_heads} must be divisible by tp={tp}")
    n_kv = model.config["n_kv_heads"]
    if n_kv is not None and n_kv % tp:
        raise ValueError(f"n_kv_heads={n_kv} must be divisible by tp={tp}")
    if model.d_ff % tp:
        raise ValueError(f"d_ff={model.d_ff} must be divisible by tp={tp}")


def _block(t: torch.Tensor, dim: int, parts: int, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``dim``, viewed as ``parts``
    equal parts each cut into ``tp`` blocks (block ``rank`` of every part,
    concatenated in part order)."""
    n = t.shape[dim]
    shape = (*t.shape[:dim], parts, tp, n // (parts * tp), *t.shape[dim + 1:])
    return t.reshape(shape).select(dim + 1, rank).flatten(dim, dim + 1).contiguous()


def tp_decode_params(state_dict: dict, tp: int, rank: int) -> dict:
    """Rank ``rank``'s local state_dict of a float or int8 (dense or MoE)
    model's ``state_dict`` under the layout of the module note."""
    out = {}
    for key, t in state_dict.items():
        module, _, leaf = key.rpartition(".")
        name = module.rpartition(".")[2]
        if name in _COLUMN:
            parts = _COLUMN[name]
            # weight [out, in]; w_q [in, out]; bias and scale [out].
            dim = 1 if leaf == "w_q" else 0
            out[key] = _block(t, dim, parts, tp, rank)
        elif name in _ROW:
            if leaf == "weight":  # [out, in]
                out[key] = _block(t, 1, 1, tp, rank)
            elif leaf == "w_q":  # [in, out]
                out[key] = _block(t, 0, 1, tp, rank)
            elif leaf == "bias":
                out[key] = t / tp
            else:  # the int8 scales, per output channel
                out[key] = t
        elif name == "moe" and leaf in ("w_in", "w_in_q"):  # [E, D, F]
            out[key] = _block(t, 2, 1, tp, rank)
        elif name == "moe" and leaf in ("b_in", "w_in_scale"):  # [E, F]
            out[key] = _block(t, 1, 1, tp, rank)
        elif name == "moe" and leaf in ("w_out", "w_out_q"):  # [E, F, D]
            out[key] = _block(t, 1, 1, tp, rank)
        elif name == "moe" and leaf == "b_out":
            out[key] = t / tp
        else:
            out[key] = t
    return out


def tp_local_decode_clone(model, comm, quantize: str | None):
    """``model``'s config at this rank's local width (heads, KV heads and
    ``d_ff`` ÷ tp, the global head width pinned, dense cached attention,
    ``tp_comm=comm``), with fresh weights, after the layout's checks."""
    tp = comm.world
    check_tp_layout(model, tp)
    n_kv = model.config["n_kv_heads"]
    return model.clone(n_heads=model.n_heads // tp,
                       n_kv_heads=None if n_kv is None else n_kv // tp,
                       d_ff=model.d_ff // tp, head_dim=model.head_dim,
                       attn_impl="dense", weight_quant=quantize, tp_comm=comm)


def tp_local_model(model, comm, quantize: str | None):
    """This rank's local-width decode model, its weights sliced from
    ``model`` (in its serving form: the int8 twin when ``quantize`` is
    "int8")."""
    from distributed_machine_learning_tpu_torch.inference.generate import (
        check_serving_form,
    )

    check_serving_form(model, quantize)
    local = tp_local_decode_clone(model, comm, quantize)
    local.load_state_dict(tp_decode_params(model.state_dict(), comm.world, comm.rank))
    dtype = next(model.parameters()).dtype  # weights stored in the compute dtype stay so
    return (local if dtype == torch.float32 else local.to(dtype)).eval()
