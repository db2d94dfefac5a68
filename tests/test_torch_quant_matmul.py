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
