"""Port of the W8A16 GEMM (ops/quant_matmul.py) vs the JAX kernel, and the
int8 quantizer, which must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas import quant_matmul as ref
from distributed_machine_learning_tpu_torch.ops import quant_matmul as port


def test_quantize_int8_is_exact():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 960)).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero column gets scale 1
    wq, ws = ref.quantize_int8(jnp.asarray(w))
    tq, ts = port.quantize_int8(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
    assert ts[7] == 1.0


@pytest.mark.parametrize("R,D,K", [(13, 64, 960), (8, 128, 256), (40, 96, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_int8_matmul_matches_jax(dtype, R, D, K):
    rng = np.random.default_rng(R + D + K)
    x = rng.standard_normal((R, D)).astype(np.float32)
    q, s = port.quantize_int8(torch.from_numpy(
        rng.standard_normal((D, K)).astype(np.float32)))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref.int8_matmul(jnp.asarray(x, jd), jnp.asarray(q.numpy()),
                           jnp.asarray(s.numpy()))
    got = port.int8_matmul(torch.from_numpy(x).to(td), q, s)
    assert got.dtype == td and got.shape == (R, K)
    # Both sides multiply bf16-exact values and sum in f32 (in another
    # order): f32 outputs agree to f32 rounding of an O(sqrt(D))-sized sum;
    # bf16 outputs may differ by one bf16 step (2^-8 relative).
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_wrapper_rejects_shape_mismatch():
    q = torch.zeros(64, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="shape mismatch"):
        port.int8_matmul(torch.zeros(3, 32), q, torch.ones(128))
    with pytest.raises(ValueError, match="shape mismatch"):
        port.int8_matmul(torch.zeros(3, 64), q, torch.ones(64))


# K6's routes: decode R (8) on the skinny tile, prefill R (8 x 4096) and a
# ragged prefill R (8 x 4095) on the wgmma mainloop when K % 16 == 0 (every
# projection of the LM: 2048, and the vocabulary head 32000), and on the
# byte-staged tile for a byte-level head (257) or K 40.
@pytest.mark.parametrize("R", [8, 16, 17, 32768, 8 * 4095])
@pytest.mark.parametrize("K", [2048, 1024, 2064, 32000, 257, 40])
def test_int8_route(R, K):
    route = port.int8_route(R, 2048, K)
    want = "skinny" if R <= 16 else ("wgmma" if K % 16 == 0 else "tile")
    assert route == want and route in port.ROUTES
    assert all(port.int8_route(R, D, K) == route for D in (8, 512, 8192))  # D takes no part


def test_route_calls_count_only_kernel_launches():
    """The route counters move where the kernel launches, not on the CPU
    path (the plain version)."""
    port.reset_route_calls()
    x = torch.zeros(32, 64)
    q = torch.zeros(64, 32, dtype=torch.int8)
    port.int8_matmul(x, q, torch.ones(32))
    assert port.route_calls == dict.fromkeys(port.ROUTES, 0)


# K6's skinny route: the served LM's five projection shapes (D, K) of one
# decode step, at R 1-16, on a card of 132 SMs.
STEP_SHAPES = [(2048, 2048), (2048, 1024), (2048, 8192), (8192, 2048), (2048, 32000)]
SMEM_PER_SM = 228 * 1024  # shared memory of one H100 SM, 1 KB reserved a block


def _skinny_slices(D, splits):
    """The kernel's slices of the contraction in k16 blocks, per (split,
    warp): [kb0, kb0 + nk)."""
    nkb = -(-D // 16)
    per = -(-nkb // (splits * port.SKINNY_WARPS))
    return [(i * per, max(0, min(nkb - i * per, per)))
            for i in range(splits * port.SKINNY_WARPS)]


@pytest.mark.parametrize("D,K", STEP_SHAPES)
@pytest.mark.parametrize("R", list(range(1, 17)))
def test_skinny_splits_keep_weight_bytes_in_flight(R, D, K):
    """One launch a GEMM: the splits (blocks of one cluster) cover the
    contraction exactly once, each busy warp with at least two k16 blocks
    when split, and the resident blocks keep at least 32 KB of weights in
    flight per SM, or the whole matrix when it is smaller than that."""
    n_sms = 132
    splits = port.skinny_splits(R, D, K, n_sms)
    assert 1 <= splits <= port.SKINNY_MAX_SPLITS
    slices = _skinny_slices(D, splits)
    covered = sorted(b for kb0, nk in slices for b in range(kb0, kb0 + nk))
    assert covered == list(range(-(-D // 16)))
    if splits > 1:
        assert min(nk for _, nk in slices if nk) >= 2
    rows = 8 * -(-R // 8)
    stage = 16 * port.SKINNY_COLS + rows * 32
    block_smem = port.SKINNY_WARPS * port.SKINNY_STAGES * stage
    blocks = -(-K // port.SKINNY_COLS) * splits
    resident = min(blocks, n_sms * (SMEM_PER_SM // (block_smem + 1024)))
    # The slices are those of a whole cluster (splits blocks).
    per_cluster = sum(min(port.SKINNY_STAGES - 1, nk) for _, nk in slices) * 16 * port.SKINNY_COLS
    assert resident / splits * per_cluster >= min(D * K, 32 * 1024 * n_sms)


@pytest.mark.parametrize("R,D,K,want", [(8, 2048, 2048, 6), (8, 2048, 1024, 8),
                                        (8, 2048, 8192, 2), (8, 8192, 2048, 6),
                                        (8, 2048, 32000, 1), (16, 64, 2048, 1),
                                        (8, 256, 257, 1), (17, 2048, 2048, 1)])
def test_skinny_splits_of_the_step(R, D, K, want):
    """The decode step's splits; a depth too shallow to split, the
    byte-staged K % 16 != 0 case and R > 16 run unsplit."""
    assert port.skinny_splits(R, D, K, 132) == want


def _byte_perm(x, y, s):
    b = [(x >> 8 * i) & 0xFF for i in range(4)] + [(y >> 8 * i) & 0xFF for i in range(4)]
    return sum(b[(s >> 4 * i) & 7] << 8 * i for i in range(4))


def _bf16(bits):
    return float(np.array([bits << 16], np.uint32).view(np.float32)[0])


def _widen4(w):
    """biased_to_bf16x2 of both byte pairs of w: ((lo, hi), (lo, hi))."""
    out = []
    for sel in (0x4140, 0x4342):
        t = _byte_perm(w, 0x43434343, sel)
        mag, off = t & 0xFF7FFF7F, (t & 0x00800080) | 0xC300C300
        out.append(tuple(_bf16((mag >> sh) & 0xFFFF) + _bf16((off >> sh) & 0xFFFF)
                         for sh in (0, 16)))
    return out


@pytest.mark.parametrize("R", [1, 8, 13, 16])
def test_skinny_fragments_and_column_permutation(R):
    """The skinny kernel's index arithmetic for one warp and one k16 block,
    in Python: the A fragments built by byte permutes of the words of rows
    k and k+1 and widened by biased_to_bf16x2 hold q exactly, at m-tile j's
    physical columns 16g + 2j (row g) and 16g + 2j + 1 (row g + 8); the
    mma's products, written as the kernel writes its partial (16
    consecutive columns a row per thread), give x @ q."""
    rng = np.random.default_rng(R)
    q = rng.integers(-128, 128, (16, port.SKINNY_COLS)).astype(np.int8)
    x = rng.integers(-8, 8, (R, 16)).astype(np.float32)
    nt = -(-R // 8)
    xp = np.zeros((8 * nt, 16), np.float32)
    xp[:R] = x
    words = q.view(np.uint8).reshape(16, port.SKINNY_COLS // 4, 4)
    words = (words.astype(np.uint32) << np.array([0, 8, 16, 24], np.uint32)).sum(-1)
    A = np.zeros((8, 16, 16))  # m-tile j: A[m][k]
    for g in range(8):
        for t in range(4):
            rows = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
            for c in range(4):
                w0, w1, w2, w3 = (int(words[r, 4 * g + c]) for r in rows)
                for h, sel in ((0, 0x5140), (1, 0x7362)):
                    (a0, a1), (a2, a3) = (_widen4(_byte_perm(w0, w1, sel)),
                                          _widen4(_byte_perm(w2, w3, sel)))
                    j = 2 * c + h
                    A[j, g, 2 * t:2 * t + 2] = a0
                    A[j, g + 8, 2 * t:2 * t + 2] = a1
                    A[j, g, 2 * t + 8:2 * t + 10] = a2
                    A[j, g + 8, 2 * t + 8:2 * t + 10] = a3
    for j in range(8):
        cols = [16 * (m % 8) + 2 * j + m // 8 for m in range(16)]
        np.testing.assert_array_equal(A[j], q[:, cols].T.astype(np.float64))
    # C_j = A_j B with B[k][n] = x[n][k]; thread (g, t) holds c0..c3 of
    # m-tile j and n-tile n and writes row 8n + 2t + h, columns 16g + 2j
    # and 16g + 2j + 1 (c_h, c_{2+h}).
    part = np.zeros((8 * nt, port.SKINNY_COLS))
    for j in range(8):
        for n in range(nt):
            C = A[j] @ xp[8 * n:8 * n + 8].T
            for g in range(8):
                for t in range(4):
                    acc = [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]]
                    for h in range(2):
                        part[8 * n + 2 * t + h, 16 * g + 2 * j] = acc[h]
                        part[8 * n + 2 * t + h, 16 * g + 2 * j + 1] = acc[2 + h]
    np.testing.assert_array_equal(part[:R], x.astype(np.float64) @ q.astype(np.float64))
