"""Port of the flash backward (ops/flash_attention.py) vs the JAX kernels.

The same numpy inputs and cotangent go through ``jax.vjp`` of the reference
``flash_self_attention`` (Pallas in interpret mode on the CPU: ``_flash_fwd``
and ``_flash_bwd``) and through the port's autograd Function, which on CPU
tensors runs the plain versions of K1 (with its lse) and of K2/K3.  The
CUDA kernels are held against those plain versions on the card
(chip_smoke.py and tests/test_torch_kernels_cuda.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas import flash_attention as ref
from distributed_machine_learning_tpu_torch.ops import flash_attention as port

# f32: the same tile recurrences summed in another order; gradients of
# order 1 agree to ~1e-6.
F32_TOL = 1e-4
# bf16: both round P and dS to bf16 before their products and round the
# outputs, but an f32 dot differing in its last bits can flip one rounding;
# and the reference writes dk/dv per query head in bf16 and sums the group
# in bf16, where the port sums the group in f32 and rounds once (measured:
# 7e-4 of the largest value for MHA, 5e-3 for GQA's dk).  So allow 4 bf16
# spacings (2^-8 relative) of each tensor's largest value.
BF16_TOL = 2.0 ** -6
# lse (log2 space, ~log2 L): the same f32 sums in another order.
LSE_TOL = 1e-5


def _inputs(B, L, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, L, n, D)).astype(np.float32)
                   for n in (H, Hkv, Hkv, H))
    return q, k, v, do


def _pair(arrays, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


@pytest.mark.parametrize("L", [128, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_matches_reference_forward(dtype, L):
    """The plain K1's lse equals the Pallas forward's ([BH, 1, L], log2)."""
    q, k, v, _ = _inputs(1, L, 4, 2, 32, seed=L)
    (jq, jk, jv), (tq, tk, tv) = _pair((q, k, v), dtype)
    bq, bk = ref._fwd_blocks(L)
    _, want = ref._flash_fwd(ref._fold(jq), ref._fold(jk), ref._fold(jv), bq, bk,
                             kv_groups=2)
    _, got = port.flash_attention_reference(tq, tk, tv, return_lse=True)
    assert got.dtype == torch.float32 and got.shape == (1, 4, L)
    np.testing.assert_allclose(got.reshape(4, L).numpy(),
                               np.asarray(want).reshape(4, L), rtol=0, atol=LSE_TOL)


@pytest.mark.parametrize("L", [128, 512, 1100])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_vjp(dtype, H, Hkv, L):
    """dq, dk, dv of the port's ``flash_self_attention(...).backward(dO)``
    against ``jax.vjp`` of the reference, the same numpy dO (L 1100 takes
    the pad path on both sides)."""
    q, k, v, do = _inputs(1, L, H, Hkv, 32, seed=7 * L + H + Hkv)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _pair((q, k, v, do), dtype)
    _, vjp = jax.vjp(ref.flash_self_attention, jq, jk, jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
    port.flash_self_attention(tq, tk, tv).backward(tdo)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == tq.dtype and got.shape == w.shape
        tol = F32_TOL if dtype == "float32" else BF16_TOL * np.abs(w).max()
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0 if dtype != "float32"
                                   else F32_TOL, atol=tol)


def test_plain_backward_matches_dense_autograd():
    """The plain K2/K3 equal autograd of one-shot causal softmax attention
    (f32, summation order only), at a block size that makes several tiles."""
    q, k, v, do = map(torch.from_numpy, _inputs(2, 256, 4, 2, 16, seed=3))
    out, lse = port.flash_attention_reference(q, k, v, block=64, return_lse=True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    got = port.flash_attention_backward_reference(q, k, v, do, lse, delta, block=64)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / math.sqrt(16)
    s = s.masked_fill(torch.triu(torch.ones(256, 256, dtype=torch.bool), 1),
                      float("-inf"))
    torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                 v.repeat_interleave(2, 2)).backward(do)
    for g, w in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_backward_does_not_trace_the_forward_loop():
    """The graph holds one node for attention (the Function): the backward
    runs the plain K2/K3, not autograd through the forward's tile loop."""
    q, k, v = (torch.randn(1, 1024, n, 32, requires_grad=True) for n in (4, 2, 2))
    out = port.flash_self_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashCoreBackward"
    assert [type(f).__name__ for f, _ in out.grad_fn.next_functions] == [
        "AccumulateGrad"] * 3
