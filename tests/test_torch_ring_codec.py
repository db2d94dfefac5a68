"""The port's int8 ring codec (plain K8-K10) against the JAX package's.

The reference holds its codec to BITWISE parity (its scale is truncated to
16 significand bits, so every q·scale is exact and no rounding freedom is
left), and so does the port: q, scale, residual, decode and decode-add are
compared bit for bit with JAX's ``quantize_chunk_int8`` (XLA) and with the
Pallas kernels in interpret mode, as ``tests/test_pallas_fusion.py`` runs
them.  Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.ops import ring as tring
from distributed_machine_learning_tpu_torch.ops import ring_codec as trc


def _bits(x):
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({4: np.uint32, 2: np.uint16, 1: np.uint8}[a.dtype.itemsize])


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _jax_codec(v, acc):
    """Every JAX codec output for chunk ``v`` and accumulator ``acc``: the
    XLA recipe and the Pallas kernels (interpret mode)."""
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.ops.pallas import ring_codec as jrc

    jv, jacc = jnp.asarray(v), jnp.asarray(acc)
    q, scale = jrc.quantize_chunk_int8(jv)
    pq, pscale, perr = jrc.encode_int8_residual(jv)
    return {
        "q": q, "scale": scale, "pallas_q": pq, "pallas_scale": pscale,
        "pallas_err": perr,
        "err": jv - q.astype(jnp.float32) * scale,
        "decode": jrc.decode_int8(pq, pscale, v.shape[0]),
        "decode_add": jrc.decode_add_int8(pq, pscale, jacc),
    }


def _check_all(v, acc):
    want = _jax_codec(v, acc)
    tv = torch.from_numpy(v)
    q, scale, err = trc.encode_int8_residual(tv)  # CPU tensor: the plain version
    q2, scale2 = trc.encode_int8(tv)
    for name, got in (("q", q), ("q", q2)):
        _equal(got, want["q"], name)
        _equal(got, want["pallas_q"], "pallas " + name)
    for got in (scale, scale2):
        _equal(got, want["scale"], "scale")
        _equal(got, want["pallas_scale"], "pallas scale")
    _equal(err, want["err"], "residual")
    _equal(err, want["pallas_err"], "pallas residual")
    _equal(trc.decode_int8(q, scale, v.shape[0]), want["decode"], "decode")
    tacc = torch.from_numpy(acc.copy())
    out = trc.decode_add_int8(q, scale, tacc)
    assert out.data_ptr() == tacc.data_ptr()  # in place, as K9
    _equal(tacc, want["decode_add"], "decode_add")


@pytest.mark.parametrize("length", [1, 127, 4096, 4097, 131_075])
def test_codec_bitwise_vs_jax(length):
    rng = np.random.default_rng(length)
    v = (rng.standard_normal(length) * rng.choice([1e-3, 1.0, 40.0])).astype(np.float32)
    acc = rng.standard_normal(length).astype(np.float32)
    _check_all(v, acc)


def test_codec_zero_chunk_and_nan_bitwise():
    rng = np.random.default_rng(3)
    zero = np.zeros(4097, np.float32)
    zero[::7] = -0.0
    _check_all(zero, rng.standard_normal(4097).astype(np.float32))
    v = rng.standard_normal(4097).astype(np.float32)
    v[1000] = np.nan  # the amax is NaN: scale 1, the NaN quantizes to 0
    _check_all(v, rng.standard_normal(4097).astype(np.float32))
    _, scale = trc.encode_int8(torch.from_numpy(v))
    assert float(scale) == 1.0
    v[1000], v[5] = 3.0, np.inf  # an inf amax: scale inf, every q 0
    _check_all(v, rng.standard_normal(4097).astype(np.float32))


def test_truncate_and_chunk_scale_vs_jax():
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.ops.pallas import ring_codec as jrc

    amax = np.random.default_rng(0).random(64).astype(np.float32) * 100
    amax[:3] = [0.0, np.nan, np.inf]
    for a in amax:
        want = jrc.chunk_scale(jnp.float32(a))
        _equal(trc.chunk_scale(torch.tensor(a)), want, f"chunk_scale({a})")
        _equal(trc.truncate_scale(torch.tensor(a)), jrc.truncate_scale(jnp.float32(a)),
               f"truncate_scale({a})")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_int8_scheme_seams_vs_jax(impl):
    """``Int8Scheme(impl)``'s encode/encode_with_residual/decode/decode_add
    equal the JAX scheme's bit for bit, for both impls."""
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.ops.ring import Int8Scheme as JInt8

    rng = np.random.default_rng(11)
    v = rng.standard_normal(1237).astype(np.float32)
    acc = rng.standard_normal(1237).astype(np.float32)
    js, ts = JInt8(impl), tring.Int8Scheme(impl)
    jenc, jerr = js.encode_with_residual(jnp.asarray(v))
    tenc, terr = ts.encode_with_residual(torch.from_numpy(v))
    for a, b, name in ((tenc[0], jenc[0], "q"), (tenc[1], jenc[1], "scale"),
                       (terr, jerr, "residual")):
        _equal(a, b, name)
    for a, b in zip(ts.encode(torch.from_numpy(v)), js.encode(jnp.asarray(v))):
        _equal(a, b, "encode")
    _equal(ts.decode(tenc, 1237), js.decode(jenc, 1237), "decode")
    tacc = torch.from_numpy(acc.copy())
    ts.decode_add(tenc, tacc)
    _equal(tacc, js.decode_add(jenc, jnp.asarray(acc), 1237), "decode_add")


@pytest.mark.parametrize("n", [1, 15, 17, 1000, 4099])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_decode_rows_bitwise_vs_jax(world, n):
    """The plain batched K10 writes JAX's ``decode_int8`` of each payload,
    bit for bit, into its row of a strided ``out`` (rows in the ring's
    order: the owner's, then each arrival's) and leaves every other element
    alone."""
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.ops.pallas import ring_codec as jrc

    rng = np.random.default_rng(world * 10_000 + n)
    chunks = [(rng.standard_normal(n) * rng.choice([1e-3, 1.0, 40.0])).astype(np.float32)
              for _ in range(world)]
    payloads = [trc.encode_int8(torch.from_numpy(v)) for v in chunks]
    stride = -(-n // 16) * 16 + 16
    sentinel = np.arange(world * stride, dtype=np.uint32).view(np.float32).reshape(world, stride)
    own = world - 1
    rows = [own] + [(own - 1 - s) % world for s in range(world - 1)]
    out = torch.from_numpy(sentinel.copy())
    assert trc.decode_rows_int8(payloads, out, rows, n) is out
    want = sentinel.copy()
    for (q, scale), i in zip(payloads, rows):
        want[i, :n] = np.asarray(jrc.decode_int8(jnp.asarray(q.numpy()),
                                                 jnp.asarray(scale.numpy()), n))
    _equal(out, want, f"decode_rows world={world} n={n}")


@pytest.mark.parametrize("name", ["none", "bf16", "topk"])
def test_wire_scheme_decode_rows_is_per_row_decode(name):
    """``decode_rows`` of the schemes without a kernel is their per-row
    ``decode``, row for row; nothing else of ``out`` moves."""
    scheme = tring.get_wire_scheme(name)
    rng = np.random.default_rng(7)
    n, rows = 37, [2, 0, 1]
    payloads = [scheme.encode(torch.from_numpy(rng.standard_normal(n).astype(np.float32)))
                for _ in rows]
    out = torch.full((3, 48), -5.0)
    scheme.decode_rows(payloads, out, rows, n)
    want = torch.full((3, 48), -5.0)
    for payload, i in zip(payloads, rows):
        want[i, :n] = scheme.decode(payload, n)
    _equal(out, want.numpy(), f"{name} decode_rows")


def test_wire_bytes_vs_jax():
    from distributed_machine_learning_tpu.ops import ring as jring

    for name in jring.WIRE_SCHEMES:
        js, ts = jring.get_wire_scheme(name), tring.get_wire_scheme(name)
        assert ts.name == js.name
        for length in (1, 1000, 3_276_800):
            assert ts.payload_bytes(length) == js.payload_bytes(length)
        for n, world, bucket in ((9_225_610, 2, 25 * 2**20), (9_231_114, 4, 25 * 2**20),
                                 (34_000, 4, 4096), (5, 2, 4)):
            want = jring.ring_wire_bytes(n, world, bucket_bytes=bucket, scheme=js)
            assert tring.ring_wire_bytes(n, world, bucket, ts) == want
            assert tring.ring_wire_bytes_by_axis(n, world, bucket, ts) == \
                jring.ring_wire_bytes_by_axis(n, world, bucket_bytes=bucket, scheme=js)
    assert tring._bucket_bounds(9_231_114, 25 * 2**20, 4) == \
        jring._bucket_bounds(9_231_114, 25 * 2**20, 4) == \
        [(0, 6_553_600), (6_553_600, 9_231_114)]


# K8's launch plan on an H100 (132 SMs, 227 KB of shared memory a block at
# one block an SM, 113 KB at two): the path's chunk lengths, edges, and the
# whole VGG gradient as one chunk (past what shared memory can stage).
@pytest.mark.parametrize("n", [1, 3, 4, 4097, 669_379, 1_638_400, 3_276_800, 9_231_114])
def test_encode_plan_covers_the_chunk(n):
    for blocks_per_sm, smem in ((1, 232_448), (2, 115_200)):
        plan = trc.encode_plan(n, 132, smem, blocks_per_sm)
        assert 1 <= plan.grid <= 132 * blocks_per_sm
        assert plan.slice % 4 == 0 and plan.staged % 4 == 0 and plan.staged <= plan.slice
        assert plan.staged * 4 <= smem
        slices = trc.encode_slices(plan, n)
        assert [s[0] for s in slices] == [b * plan.slice for b in range(plan.grid)]
        assert slices[-1][2] == n  # the tail is the last block's
        edges = [0] + [e for s in slices for e in (s[0], s[2])] + [n]
        assert edges[0::2] == edges[1::2]  # owned once each, in order, no gap
        assert all(s[0] <= s[1] <= s[2] for s in slices)
        assert (n // 4 > 132 * blocks_per_sm * (smem // 16)) == (plan.staged < plan.slice)
