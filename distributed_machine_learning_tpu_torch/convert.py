"""Weights between the Flax reference and the port, and a port-side init.

:func:`flax_to_state_dict` maps a reference ``TransformerLM`` params tree
(nested dicts of numpy arrays, as ``jax.device_get(params)`` gives them)
to the port's ``state_dict``; it takes the float tree and the int8 tree
of ``quantize_lm_params`` alike:

====================================  ===================================
Flax                                  port
====================================  ===================================
``embed/embedding`` [V, E]            ``embed.weight``
``block_i/ln{1,2}/{scale,bias}``      ``blocks.i.ln{1,2}.{weight,bias}``
``attn/qkv/kernel`` [E, 3, H, D]      ``attn.qkv.weight`` [3·H·D, E]
``attn/q/kernel`` [E, H, D]           ``attn.q.weight`` [H·D, E]
``attn/kv/kernel`` [E, 2, Hkv, D]     ``attn.kv.weight`` [2·Hkv·D, E]
``attn/out/kernel`` [H, D, E]         ``attn.out.weight`` [E, H·D]
``fc_in``/``fc_out``/``lm_head``      ``.weight`` = kernel [in, out]ᵀ
``ln_f``                              ``ln_f``
int8: ``w_q`` [D_in, K] + ``scale``   ``w_q`` [D_in, K] + ``scale``
====================================  ===================================

Biases are flattened to [out].  :func:`flax_adamw_state` maps the
reference's AdamW moments (params-shaped trees) with the same table.
:func:`flax_vgg_to_state_dict` maps a reference ``VGG``'s params and
batch_stats (``Conv_i`` kernels HWIO -> ``convs.i.weight`` OIHW,
``BatchNorm_i`` scale/bias/mean/var -> ``bns.i``, ``fc1`` kernel
transposed); :func:`flax_vgg_tree` maps a params-shaped tree of the port
(gradients, SGD buffers) the other way.  :func:`flax_resnet_to_state_dict`
maps a reference ``ResNet``'s params and batch_stats (every kernel HWIO ->
OIHW, every BN's scale/bias/mean/var, ``bn_down`` included, ``fc`` kernel
transposed).  :func:`flax_moe_to_state_dict` maps a reference
``MoETransformerLM`` (float or int8 tree): the dense table above for the
attention, the LayerNorms, the embedding and the head, and each block's
``moe`` module as ``blocks.i.moe``: ``router/kernel`` [D, E] →
``router.weight`` [E, D], the expert leaves (``w_in`` [E, D, F], ``b_in``,
``w_out`` [E, F, D], ``b_out``; int8: ``w_in_q``, ``w_in_scale``,
``w_out_q``, ``w_out_scale``) unchanged.
:func:`init_params` draws fresh weights for a port model (dense or MoE)
from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.ops.quant import QUANT_MODULES


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _projection(name: str, leaves: dict, prefix: str, out: dict) -> None:
    if "w_q" in leaves:
        out[f"{prefix}.w_q"] = _tensor(leaves["w_q"])
        out[f"{prefix}.scale"] = _tensor(leaves["scale"])
        out[f"{prefix}.bias"] = _tensor(leaves["bias"]).reshape(-1)
        return
    kernel = _tensor(leaves["kernel"])
    n_in = 2 if name == "out" else 1
    d_in = math.prod(kernel.shape[:n_in])
    out[f"{prefix}.weight"] = kernel.reshape(d_in, -1).t().contiguous()
    out[f"{prefix}.bias"] = _tensor(leaves["bias"]).reshape(-1)


def _layer_norm(leaves: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _tensor(leaves["scale"])
    out[f"{prefix}.bias"] = _tensor(leaves["bias"])


def flax_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Reference ``TransformerLM`` params (float or int8 tree) → the port's
    ``state_dict``, for ``TransformerLM.load_state_dict``; a block with a
    ``moe`` module maps as :func:`flax_moe_to_state_dict` says."""
    out: dict[str, torch.Tensor] = {
        "embed.weight": _tensor(params["embed"]["embedding"])}
    n_layers = sum(1 for k in params if k.startswith("block_"))
    for i in range(n_layers):
        blk = params[f"block_{i}"]
        pre = f"blocks.{i}"
        _layer_norm(blk["ln1"], f"{pre}.ln1", out)
        _layer_norm(blk["ln2"], f"{pre}.ln2", out)
        for name, leaves in blk["attn"].items():
            _projection(name, leaves, f"{pre}.attn.{name}", out)
        if "moe" in blk:
            _experts(blk["moe"], f"{pre}.moe", out)
            continue
        _projection("fc_in", blk["fc_in"], f"{pre}.fc_in", out)
        _projection("fc_out", blk["fc_out"], f"{pre}.fc_out", out)
    _layer_norm(params["ln_f"], "ln_f", out)
    _projection("lm_head", params["lm_head"], "lm_head", out)
    return out


def _experts(leaves: dict, prefix: str, out: dict) -> None:
    router = leaves["router"]
    out[f"{prefix}.router.weight"] = _tensor(router["kernel"]).t().contiguous()
    out[f"{prefix}.router.bias"] = _tensor(router["bias"])
    for name, value in leaves.items():
        if name != "router":
            out[f"{prefix}.{name}"] = _tensor(value)


def flax_moe_to_state_dict(params: dict) -> dict[str, torch.Tensor]:
    """Reference ``MoETransformerLM`` params (float or int8 tree) → the
    port's ``state_dict``, for ``MoETransformerLM.load_state_dict``."""
    return flax_to_state_dict(params)


def flax_adamw_state(moments: dict) -> dict[str, dict[str, torch.Tensor]]:
    """The reference's AdamW moments ``{"mu": tree, "nu": tree}`` (each
    shaped like the params tree, f32) → ``{"mu": state_dict, "nu":
    state_dict}``, the port's ``TrainState.momentum``: the moments are
    elementwise per parameter, so the parameter map carries them."""
    out = {which: flax_to_state_dict(moments[which]) for which in ("mu", "nu")}
    if out["mu"].keys() != out["nu"].keys():
        raise ValueError("mu and nu do not hold the same parameters")
    return out


@torch.no_grad()
def init_params(model, seed: int = 0) -> None:
    """Fresh f32 weights for a float port ``TransformerLM`` or
    ``MoETransformerLM``, in place, from
    ``torch.Generator(device).manual_seed(seed)``: projections (the router
    and each expert's kernels too) normal with std 1/sqrt(fan_in) and zero
    bias, the embedding normal with std 1/sqrt(vocab), LayerNorms at scale
    1 and bias 0."""
    if model.weight_quant is not None:
        raise ValueError("init_params fills a float model; quantize it after")
    gen = torch.Generator(device=model.device).manual_seed(seed)
    for name, p in model.named_parameters():
        module, _, leaf = name.rpartition(".")
        base = module.rpartition(".")[2]
        if name == "embed.weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=gen)
        elif (base in QUANT_MODULES or base == "router") and leaf == "weight":
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
        elif base == "moe" and leaf in ("w_in", "w_out"):  # [E, fan_in, fan_out]
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
        elif leaf == "weight":  # LayerNorm scale
            p.fill_(1.0)
        else:
            p.zero_()


def flax_vgg_to_state_dict(params: dict, batch_stats: dict | None = None
                           ) -> dict[str, torch.Tensor]:
    """A reference ``VGG``'s variables as the port's ``VGG`` state_dict."""
    out = {}
    n_conv = sum(1 for k in params if k.startswith("Conv_"))
    for i in range(n_conv):
        conv = params[f"Conv_{i}"]
        out[f"convs.{i}.weight"] = _tensor(conv["kernel"]).permute(3, 2, 0, 1).contiguous()
        out[f"convs.{i}.bias"] = _tensor(conv["bias"])
        if f"BatchNorm_{i}" in params:
            bn = params[f"BatchNorm_{i}"]
            out[f"bns.{i}.weight"] = _tensor(bn["scale"])
            out[f"bns.{i}.bias"] = _tensor(bn["bias"])
            stats = (batch_stats or {})[f"BatchNorm_{i}"]
            out[f"bns.{i}.running_mean"] = _tensor(stats["mean"])
            out[f"bns.{i}.running_var"] = _tensor(stats["var"])
    out["fc1.weight"] = _tensor(params["fc1"]["kernel"]).T.contiguous()
    out["fc1.bias"] = _tensor(params["fc1"]["bias"])
    return out


def flax_vgg_tree(named: dict) -> dict:
    """A port ``VGG``'s params-shaped tensors by name (parameters,
    gradients, momentum buffers) as the reference's nested numpy tree."""
    tree: dict = {}
    for name, t in named.items():
        if name.startswith("fc1."):
            continue
        a = t.detach().cpu().float().numpy()
        group, i, leaf = name.split(".")
        if group == "convs":
            key, leaf = f"Conv_{i}", {"weight": "kernel", "bias": "bias"}[leaf]
            a = a.transpose(2, 3, 1, 0) if leaf == "kernel" else a
        else:
            key, leaf = f"BatchNorm_{i}", {"weight": "scale", "bias": "bias"}[leaf]
        tree.setdefault(key, {})[leaf] = a
    tree["fc1"] = {"kernel": named["fc1.weight"].detach().cpu().float().numpy().T,
                   "bias": named["fc1.bias"].detach().cpu().float().numpy()}
    return tree


def flax_resnet_to_state_dict(params: dict, batch_stats: dict | None = None
                              ) -> dict[str, torch.Tensor]:
    """A reference ``ResNet``'s variables as the port's ``ResNet`` state_dict
    (the port names its modules as the Flax ones are named)."""
    out: dict[str, torch.Tensor] = {}

    def walk(p: dict, s: dict, prefix: str) -> None:
        for name, leaves in p.items():
            key = f"{prefix}{name}"
            if "kernel" in leaves and name == "fc":
                out[f"{key}.weight"] = _tensor(leaves["kernel"]).T.contiguous()
                out[f"{key}.bias"] = _tensor(leaves["bias"])
            elif "kernel" in leaves:
                out[key] = _tensor(leaves["kernel"]).permute(3, 2, 0, 1).contiguous()
            elif "scale" in leaves:
                out[f"{key}.weight"] = _tensor(leaves["scale"])
                out[f"{key}.bias"] = _tensor(leaves["bias"])
                out[f"{key}.running_mean"] = _tensor(s[name]["mean"])
                out[f"{key}.running_var"] = _tensor(s[name]["var"])
            else:
                walk(leaves, s.get(name, {}), f"{key}.")

    walk(params, batch_stats or {}, "")
    return out
