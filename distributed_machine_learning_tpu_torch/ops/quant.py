"""Weight-only int8 serving: the quantized projection and the converter.

Counterpart of ``distributed_machine_learning_tpu/ops/quant.py``
(``QuantDenseGeneral`` → :class:`QuantLinear`, ``quantize_lm_params``
with its dense and MoE expert layouts).
"""

from __future__ import annotations

import torch
from torch import nn

from distributed_machine_learning_tpu_torch.ops.quant_matmul import (
    int8_matmul,
    quantize_int8,
)

# Names of the projections a TransformerLM quantizes (every nn.Linear).
QUANT_MODULES = frozenset({"qkv", "q", "kv", "out", "fc_in", "fc_out", "lm_head"})


class QuantLinear(nn.Module):
    """Projection over int8 weights: ``w_q`` int8 [in, out] (the kernel's
    [D, K] layout), ``scale`` f32 [out], ``bias`` f32 [out].  The product
    runs through :func:`int8_matmul`; the bias is added after the cast to
    the compute dtype, as in the reference."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.compute_dtype = compute_dtype
        self.register_buffer("w_q", torch.zeros(
            (in_features, out_features), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            out_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = int8_matmul(x.reshape(-1, self.in_features), self.w_q, self.scale)
        y = y.reshape(*lead, self.out_features).to(self.compute_dtype)
        return y + self.bias.to(self.compute_dtype)


# An MoE block's expert leaves (models/moe.py): [E, D_in, D_out] kernels
# quantized per expert and per output channel; biases and the router pass.
EXPERT_KERNELS = ("w_in", "w_out")


def _quantize_experts(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[E, D_in, D_out] → (int8 [E, D_in, D_out], f32 scales [E, D_out]):
    :func:`quantize_int8` on each expert's kernel (the reference vmaps it)."""
    qs, scales = zip(*(quantize_int8(w[e]) for e in range(w.shape[0])))
    return torch.stack(qs), torch.stack(scales)


def quantize_lm_params(state_dict: dict) -> dict:
    """A float TransformerLM or MoETransformerLM state_dict → its
    ``weight_quant="int8"`` twin's: each projection's ``weight`` [out, in]
    becomes ``w_q`` [in, out] int8 + ``scale`` [out] (per-output-channel,
    :func:`quantize_int8`); an expert kernel ``moe.w_in``/``moe.w_out``
    becomes ``w_in_q``/``w_out_q`` + ``w_in_scale``/``w_out_scale`` (per
    expert, per output channel).  Biases, embeddings, LayerNorms and the
    f32 router pass through."""
    out = {}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        base = module.rpartition(".")[2]
        if base in QUANT_MODULES and leaf == "weight":
            q, scale = quantize_int8(value.t())
            out[f"{module}.w_q"] = q
            out[f"{module}.scale"] = scale
        elif base in QUANT_MODULES and leaf == "bias":
            out[key] = value.float()
        elif base == "moe" and leaf in EXPERT_KERNELS:
            out[f"{module}.{leaf}_q"], out[f"{module}.{leaf}_scale"] = (
                _quantize_experts(value))
        else:
            out[key] = value
    return out


def quantize_lm(model):
    """The int8 serving twin of a float TransformerLM or MoETransformerLM
    (same config, same device), with weights from
    :func:`quantize_lm_params`."""
    if model.weight_quant == "int8":
        return model
    qm = model.clone(weight_quant="int8")
    qm.load_state_dict(quantize_lm_params(model.state_dict()))
    return qm
