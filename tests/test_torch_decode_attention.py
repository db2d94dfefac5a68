"""Port of the flash-decode kernel (ops/decode_attention.py) vs the JAX one.

The reference ``cached_flash_attention`` runs its Pallas kernel in
interpret mode on the CPU; the port's wrapper runs the kernel's plain
PyTorch version on CPU tensors.  Slots past the position hold garbage on
purpose: both must ignore them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas import decode_attention as ref
from distributed_machine_learning_tpu_torch.ops import decode_attention as port

# f32: the same blockwise recurrence, summed in another order.
F32_TOL = 2e-5
# bf16 caches: P is rounded to bf16 before P·V and the output is bf16
# (spacing 2^-8 near 1); a last-bit difference in an f32 score can flip
# one rounding, so two bf16 steps.
BF16_TOL = 1e-2


def _inputs(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,pos", [
    (512, 0), (512, 127), (512, 128), (512, 511),
    (4096, 0), (4096, 511), (4096, 512), (4096, 4095),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_decode_matches_jax(dtype, S, pos):
    q, k, v = _inputs(2, S, 4, 2, 32, seed=S + pos)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref.cached_flash_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.int32(pos))
    got = port.cached_flash_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), pos)
    assert got.dtype == td and got.shape == (2, 1, 4, 32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_block_picker_and_dispatch_rule_match_reference():
    for S in list(range(1, 3000)) + [4096, 4608, 8192, 32768]:
        assert port.pick_block_s(S) == ref.pick_block_s(S), S
        assert port.decode_flash_qualifies(S) == ref.decode_flash_qualifies(S), S
    assert port.pick_block_s(4608) == 512


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 1, 4, 16)
    cache = torch.zeros(1, 2, 512, 16)
    with pytest.raises(ValueError, match="outside"):
        port.cached_flash_attention(q, cache, cache, 512)
    with pytest.raises(ValueError, match="single-token"):
        port.cached_flash_attention(torch.zeros(1, 2, 4, 16), cache, cache, 0)
    bad = torch.zeros(1, 2, 2208, 16)  # no 128-multiple divisor
    with pytest.raises(ValueError, match="tile"):
        port.cached_flash_attention(q, bad, bad, 5)
