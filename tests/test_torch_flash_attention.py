"""Port of the flash forward (ops/flash_attention.py) vs the JAX kernel.

The same numpy inputs go through the reference ``flash_self_attention``
(Pallas in interpret mode on the CPU) and the port's wrapper, which on CPU
tensors runs the kernel's plain PyTorch version.  The CUDA kernel itself
is held against that plain version on the card (chip_smoke.py and
tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas import flash_attention as ref
from distributed_machine_learning_tpu_torch.ops import flash_attention as port

# f32: the same blockwise recurrence summed in another order, ~1e-6.
F32_TOL = 2e-5
# bf16: outputs are rounded to bf16 (relative spacing 2^-8) and P is
# rounded to bf16 before P·V on both sides; an f32 dot differing in its
# last bits can flip one such rounding, so allow two bf16 steps at |x|~1.
BF16_TOL = 1e-2


def _inputs(B, L, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, L, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, L, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("L", [128, 512, 1100])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_jax(dtype, H, Hkv, L):
    q, k, v = _inputs(1, L, H, Hkv, 32, seed=L + H + Hkv)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref.flash_self_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd))
    got = port.flash_self_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td))
    assert got.dtype == td and got.shape == (1, L, H, 32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_plain_flash_matches_dense_attention():
    """The blockwise recurrence equals one-shot causal softmax attention
    (f32, summation order only)."""
    q, k, v = _inputs(2, 256, 4, 2, 16, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = port.flash_attention_reference(tq, tk, tv, block=64)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk.repeat_interleave(2, 2)) / 4.0
    s = s.masked_fill(torch.triu(torch.ones(256, 256, dtype=torch.bool), 1),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                        tv.repeat_interleave(2, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


def test_length_policy_matches_reference():
    for L in list(range(1, 2200)) + [4096, 4097, 8192, 12345]:
        assert port.flash_wins(L) == ref.flash_wins(L), L
        assert port._needs_pad(L) == ref._needs_pad(L), L
        assert port._padded_len(L) == ref._padded_len(L), L


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 64, 4, 16)
    with pytest.raises(ValueError, match="multiple"):
        port.flash_self_attention(q, torch.zeros(1, 64, 3, 16),
                                  torch.zeros(1, 64, 3, 16))
    with pytest.raises(ValueError, match="one shape"):
        port.flash_self_attention(q, torch.zeros(1, 64, 2, 16),
                                  torch.zeros(1, 64, 4, 16))
