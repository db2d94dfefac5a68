"""Weight-only int8 serving: the quantized projection and the converter.

Counterpart of ``distributed_machine_learning_tpu/ops/quant.py`` for
dense models (``QuantDenseGeneral`` → :class:`QuantLinear`,
``quantize_lm_params``); the MoE expert layout waits for the MoE slice.
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


def quantize_lm_params(state_dict: dict) -> dict:
    """A float TransformerLM state_dict → its ``weight_quant="int8"``
    twin's: each projection's ``weight`` [out, in] becomes ``w_q`` [in, out]
    int8 + ``scale`` [out] (per-output-channel, :func:`quantize_int8`);
    biases, embeddings and LayerNorms pass through."""
    out = {}
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if module.rpartition(".")[2] in QUANT_MODULES and leaf == "weight":
            q, scale = quantize_int8(value.t())
            out[f"{module}.w_q"] = q
            out[f"{module}.scale"] = scale
        elif module.rpartition(".")[2] in QUANT_MODULES and leaf == "bias":
            out[key] = value.float()
        else:
            out[key] = value
    return out


def quantize_lm(model):
    """The int8 serving twin of a float TransformerLM (same config, same
    device), with weights from :func:`quantize_lm_params`."""
    if model.weight_quant == "int8":
        return model
    qm = model.clone(weight_quant="int8")
    qm.load_state_dict(quantize_lm_params(model.state_dict()))
    return qm
