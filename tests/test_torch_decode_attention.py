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


# K4's split of slots 0..pos across blocks (decode_split), on a card of
# 132 SMs at the served model's 4 KV heads: (B, pos) -> (splits, chunk).
@pytest.mark.parametrize("B,pos,want", [
    (1, 0, (1, 1)), (1, 127, (1, 128)), (1, 128, (1, 129)), (1, 255, (2, 128)),
    (1, 256, (2, 129)), (1, 4111, (32, 129)), (1, 32767, (66, 497)),
    (8, 0, (1, 1)), (8, 255, (2, 128)), (8, 4095, (8, 512)), (8, 4111, (8, 514)),
    (8, 32767, (8, 4096)),
])
def test_decode_split_block_counts(B, pos, want):
    splits, chunk = port.decode_split(B, 4, pos, 132)
    assert (splits, chunk) == want
    n = pos + 1
    assert splits * chunk >= n > (splits - 1) * chunk  # every slot, no empty chunk
    assert chunk >= min(n, port.DECODE_MIN_CHUNK)
    assert splits == 1 or B * 4 * splits <= 2 * 132  # one wave of ~2 blocks per SM


def test_decode_split_is_pure_and_covers_every_position():
    for B in (1, 2, 8, 64):
        for pos in range(0, 5000, 37):
            splits, chunk = port.decode_split(B, 4, pos, 132)
            assert port.decode_split(B, 4, pos, 132) == (splits, chunk)
            assert splits >= 1 and splits * chunk > pos >= (splits - 1) * chunk
    assert port.decode_split(64, 4, 4095, 132) == (1, 4096)  # 256 rows fill the card


def _split_merge(q, k, v, pos, k_scale=None, v_scale=None, n_sms=132):
    """K4's flash-decoding in plain numpy/PyTorch arithmetic: slots 0..pos cut
    into decode_split's chunks, each chunk's f32 partial (m, l, unnormalised
    acc) in log2 space (q in the cache dtype and p rounded to it for bf16/f32
    caches; int8 rows times their f32 scale, q and p in f32), merged in split
    order as the combine kernel does, out = acc / max(l, 1e-30)."""
    B, _, H, D = q.shape
    Hkv = k.shape[1]
    quant = k.dtype == torch.int8
    work = torch.float32 if quant else k.dtype
    qg = q.to(work).float().reshape(B, Hkv, H // Hkv, D)
    kf, vf = k.float(), v.float()
    if quant:
        kf, vf = kf * k_scale[..., None], vf * v_scale[..., None]
    splits, chunk = port.decode_split(B, Hkv, pos, n_sms)
    scale = (1.0 / np.sqrt(D)) * port.LOG2E
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min(pos, (i + 1) * chunk - 1)
        s = torch.einsum("bhrd,bhsd->bhrs", qg, kf[:, :, lo:hi + 1]) * scale
        m = s.amax(-1)
        p = torch.exp2(s - m[..., None])
        acc = torch.einsum("bhrs,bhsd->bhrd", p.to(work).float(), vf[:, :, lo:hi + 1])
        parts.append((m, p.sum(-1), acc))
    m = torch.stack([pm for pm, _, _ in parts]).amax(0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for pm, pl, pa in parts:
        a = torch.exp2(pm - m)
        l = l + pl * a
        acc = acc + pa * a[..., None]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype), splits, chunk


# Positions on and beside the chunk edges of decode_split at B 2 x Hkv 2:
# 127 / 128 (one chunk, the minimum and one past), 255 / 256 (two chunks
# of 128, of 129), 1151 (9 chunks of 128: pos is a chunk's last slot),
# 1152 (9 chunks of 129, the last one shorter), 2047 (16 chunks of 128).
SPLIT_POSITIONS = [127, 128, 255, 256, 1151, 1152, 2047]


@pytest.mark.parametrize("pos", SPLIT_POSITIONS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_split_merge_matches_jax(dtype, pos):
    """The split and its fixed-order merge, held against JAX's Pallas kernel
    in interpret mode on the same numpy inputs.  f32 (and int8 rows with f32
    q): summation order only, 1e-5 relative; bf16: P rounded to bf16 at
    another place, two bf16 steps (BF16_TOL)."""
    B, S, H, Hkv, D = 2, 2048, 4, 2, 32
    q, k, v = _inputs(B, S, H, Hkv, D, seed=pos)
    if dtype == "int8":
        rng = np.random.default_rng(pos + 1)
        k8 = rng.integers(-127, 128, (B, Hkv, S, D), dtype=np.int8)
        v8 = rng.integers(-127, 128, (B, Hkv, S, D), dtype=np.int8)
        ks = (rng.random((B, Hkv, S)) / 127).astype(np.float32)
        vs = (rng.random((B, Hkv, S)) / 127).astype(np.float32)
        want = ref.cached_flash_attention(jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8),
                                          jnp.int32(pos), jnp.asarray(ks), jnp.asarray(vs))
        got, splits, chunk = _split_merge(
            torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8), pos,
            torch.from_numpy(ks), torch.from_numpy(vs))
        tol = 1e-5
    else:
        jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
        td = torch.float32 if dtype == "float32" else torch.bfloat16
        want = ref.cached_flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                          jnp.asarray(v, jd), jnp.int32(pos))
        got, splits, chunk = _split_merge(torch.from_numpy(q).to(td), torch.from_numpy(k).to(td),
                                          torch.from_numpy(v).to(td), pos)
        tol = F32_TOL / 2 if dtype == "float32" else BF16_TOL
    assert splits > 1 or pos < 2 * port.DECODE_MIN_CHUNK
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))
