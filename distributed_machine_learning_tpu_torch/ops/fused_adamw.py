"""Fused AdamW update of one parameter leaf, in place: K7.

Counterpart of ``distributed_machine_learning_tpu/ops/pallas/fused_adamw.py``
(``fused_adamw_leaf``).  CUDA tensors go through the hand-written kernel
``csrc/fused_adamw.cu``: moment update, bias correction, weight decay,
parameter update and the cast back to the parameter's dtype in one pass,
each element read once and written once.  CPU tensors go through
:func:`fused_adamw_reference`, the same expressions in PyTorch.  Both
update ``p``, ``mu`` and ``nu`` in place, as the reference aliases its
outputs to its inputs.

Update rule (torch ``optim.AdamW`` semantics, ``t = step + 1``)::

    mu  = b1·mu + (1−b1)·g
    nu  = b2·nu + (1−b2)·g²
    p  −= lr · ( (mu/bc1) / (√(nu/bc2) + eps) + wd·p )

``lr`` and the bias corrections ``bc1 = 1−b1ᵗ`` / ``bc2 = 1−b2ᵗ`` are f32
host scalars, kernel arguments: no rebuild per step.  Parity contract (the
reference's): one update within 8 ulp of the plain version on params and
moments (FMA contraction is the kernel's one freedom).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from distributed_machine_learning_tpu_torch.ops import build

KERNEL = "fused_adamw"
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_float] * 9 + [ctypes.c_int, ctypes.c_void_p])


def _f32(x) -> float:
    """``x`` rounded to f32, as a Python float (exact in the kernel's and in
    torch's f32 arithmetic)."""
    return float(np.float32(x))


def fused_adamw_reference(p, mu, nu, g, lr, bc1, bc2, *, beta1: float,
                          beta2: float, eps: float,
                          weight_decay: float) -> None:
    """Plain PyTorch version of K7: the same update, in place, op by op in
    f32 (``p`` written back in its own dtype)."""
    lr, bc1, bc2 = _f32(lr), _f32(bc1), _f32(bc2)
    g32 = g.float()
    p32 = p.float()
    m = _f32(beta1) * mu + _f32(1.0 - beta1) * g32
    v = _f32(beta2) * nu + _f32(1.0 - beta2) * (g32 * g32)
    adam_term = (m / bc1) / (torch.sqrt(v / bc2) + _f32(eps))
    p32 = p32 - lr * (adam_term + _f32(weight_decay) * p32)
    p.copy_(p32)
    mu.copy_(m)
    nu.copy_(v)


def _launch(p, mu, nu, g, lr, bc1, bc2, beta1, beta2, eps, weight_decay) -> None:
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused AdamW kernel takes f32 or bf16 params, got {p.dtype}")
    if g.dtype != p.dtype:
        raise ValueError(f"fused AdamW kernel needs the gradient in the param's "
                         f"dtype {p.dtype}, got {g.dtype}")
    for name, t in (("mu", mu), ("nu", nu)):
        if t.dtype != torch.float32:
            raise ValueError(f"fused AdamW kernel needs f32 {name}, got {t.dtype}")
    for name, t in (("p", p), ("mu", mu), ("nu", nu), ("g", g)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device} does not match "
                             f"p {tuple(p.shape)} on {p.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused AdamW kernel needs {name} contiguous and "
                             f"16-byte aligned")
    fn = build.function(KERNEL, "fused_adamw", _ARGTYPES)
    status = fn(p.data_ptr(), mu.data_ptr(), nu.data_ptr(), g.data_ptr(),
                p.numel(), int(p.dtype == torch.bfloat16), _f32(lr), _f32(bc1),
                _f32(bc2), _f32(beta1), _f32(1.0 - beta1), _f32(beta2),
                _f32(1.0 - beta2), _f32(eps), _f32(weight_decay),
                8 * build.sm_count(p.device), build.stream_handle(p.device))
    build.check(status, KERNEL)
    build.count_launch(KERNEL)


def fused_adamw_leaf(p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                     g: torch.Tensor, lr, bc1, bc2, *, beta1: float,
                     beta2: float, eps: float, weight_decay: float) -> None:
    """One leaf's fused update, in place: ``p`` (f32 or bf16) keeps its
    dtype, ``mu``/``nu`` are f32.  On CUDA tensors: K7 (anything it does not
    take raises); on CPU tensors: :func:`fused_adamw_reference`.  A
    zero-size leaf is left as it is."""
    if p.numel() == 0:
        return
    update = _launch if p.is_cuda else fused_adamw_reference
    update(p, mu, nu, g, lr, bc1, bc2, beta1=beta1, beta2=beta2, eps=eps,
           weight_decay=weight_decay)
