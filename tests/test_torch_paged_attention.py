"""Port of the paged decode kernel K5 (ops/decode_attention.py) vs the JAX one.

The port's wrapper runs the kernel's plain version on CPU tensors; the
reference runs its gather formulation (``paged_attention_reference``) and
its Pallas kernel in interpret mode, as tests/test_decode_attention.py
does.  Each lane's pages are a shuffled, interleaved set of pool blocks;
entries past a lane's frontier hold other lanes' blocks; the last lane is
idle (every entry on the scratch block, position 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas import decode_attention as ref
from distributed_machine_learning_tpu_torch.ops import decode_attention as port

# f32: the same page-wise recurrence as the reference kernel, in log2 space
# and summed in another order than the reference's one-shot softmax.
F32_TOL = 1e-5
# bf16 pools: the port rounds P to bf16 before P·V (as the kernel does) and
# the reference does not; outputs are bf16 (spacing 2^-8 near 1): two bf16
# steps, as for K4.
BF16_TOL = 1e-2


def _case(bs, H, Hkv, D=32, seed=0):
    rng = np.random.default_rng(seed)
    positions = [0, bs - 1, bs, 3 * bs + 2, 0]  # the last lane is idle
    W, mb = len(positions), 4
    n_pool = 24
    perm = rng.permutation(n_pool)
    tables = rng.integers(0, n_pool, (W, mb)).astype(np.int32)  # garbage past frontiers
    take = 0
    for w, p in enumerate(positions[:-1]):
        n = p // bs + 1
        tables[w, :n] = perm[take:take + n]
        take += n
    tables[-1] = n_pool  # the scratch block
    pools = [rng.standard_normal((n_pool + 1, Hkv, bs, D)).astype(np.float32)
             for _ in range(2)]
    q = rng.standard_normal((W, 1, H, D)).astype(np.float32)
    return q, pools[0], pools[1], tables, np.asarray(positions, np.int32)


def _port(q, k, v, tables, positions, dtype=torch.float32):
    out = port.paged_flash_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(positions))
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("bs", [4, 16])
@pytest.mark.parametrize("H,Hkv", [(2, 2), (8, 2)], ids=["rep1", "rep4"])
def test_plain_paged_matches_jax_reference_and_kernel(bs, H, Hkv):
    q, k, v, tables, positions = _case(bs, H, Hkv, seed=bs + H)
    got = _port(q, k, v, tables, positions)
    args = [jnp.asarray(a) for a in (q, k, v, tables, positions)]
    for fn in (ref.paged_attention_reference, ref.paged_flash_attention):
        np.testing.assert_allclose(got, np.asarray(fn(*args)),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bs", [4, 16])
def test_plain_paged_bf16_matches_jax_reference(bs):
    q, k, v, tables, positions = _case(bs, 8, 2, seed=3)
    got = _port(q, k, v, tables, positions, torch.bfloat16)
    want = ref.paged_attention_reference(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(tables), jnp.asarray(positions))
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_paged_split_covers_the_table():
    assert port.paged_split(8, 4, 4160, 132) == (17, 245)
    assert port.paged_split(8, 4, 64, 132) == (1, 64)  # short tables: one block
    for W, Hkv, slots in ((1, 1, 5000), (8, 4, 4224), (64, 8, 128)):
        splits, chunk = port.paged_split(W, Hkv, slots, 132)
        assert splits * chunk >= slots and (splits - 1) * chunk < slots


def test_paged_wrapper_rejects_bad_inputs():
    q, k, v, tables, positions = (torch.from_numpy(a) for a in _case(4, 2, 2))
    with pytest.raises(ValueError, match="single-token"):
        port.paged_flash_attention(q.expand(-1, 2, -1, -1), k, v, tables, positions)
    with pytest.raises(ValueError, match="one shape"):
        port.paged_flash_attention(q, k, v[:-1], tables, positions)
    with pytest.raises(ValueError, match="int32"):
        port.paged_flash_attention(q, k, v, tables.long(), positions)
    with pytest.raises(ValueError, match="positions"):
        port.paged_flash_attention(q, k, v, tables, positions[:-1])
    with pytest.raises(ValueError, match="outside the tables"):
        port.paged_flash_attention(q, k, v, tables, positions + 16)
    with pytest.raises(ValueError, match="outside the pool"):
        port.paged_flash_attention(q, k, v, tables + 1, positions)
