"""The port's int8 KV cache for serving vs the JAX package, on the CPU.

The same numpy inputs (or the same converted weights) go through both:
the quantized cache write (bit for bit), the cache after an f32 prefill,
the plain version of K4's int8 mode against the reference's Pallas kernel
in interpret mode, the scale-folding einsum, and greedy generation with an
int8 cache under the default dispatch and under the tiered switch.  Also:
the engine refuses int8 KV, the CLI serves with ``--kv-cache-dtype int8``,
and the wrapper refuses what it cannot take.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_machine_learning_tpu.inference.generate  # noqa: F401
import distributed_machine_learning_tpu.models.transformer as ref_tf
from distributed_machine_learning_tpu.ops.pallas import decode_attention as ref_da
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.inference import generate as port_gen
from distributed_machine_learning_tpu_torch.models import transformer as port_tf
from distributed_machine_learning_tpu_torch.ops import decode_attention as port_da

# The reference package's __init__ re-exports a function named generate,
# which shadows the module attribute: take the module from sys.modules.
ref_gen = sys.modules["distributed_machine_learning_tpu.inference.generate"]
VOCAB = 64
# f32 attention: the same arithmetic per element, summed in another order.
F32_TOL = 2e-5
# A bf16 output (or bf16 P before P·V) can flip one rounding on a last-bit
# difference of an f32 score: two bf16 spacings near 1.
BF16_TOL = 1e-2


def _ref_quantize(t):
    """The reference model's int8 write (models/transformer.py ``_write``),
    verbatim: f32 amax over D, scale amax/127 (1 where 0), round, clip."""
    amax = jnp.max(jnp.abs(t.astype(jnp.float32)), axis=-1)
    s = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(t.astype(jnp.float32) / s[..., None]), -127, 127)
    return q.astype(jnp.int8), s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_write_matches_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    t = rng.standard_normal((2, 3, 17, 64)).astype(np.float32) * 3.0
    t[0, 0, 0] = 0.0  # an all-zero row: scale 1, codes 0
    # Exact ties at a power-of-two scale (amax 127·2^-3 → s = 2^-3): t/s
    # lands on .5 and must round half to even, as jnp.round does.
    t[1, 2, 5, :6] = np.array([127, 0.5, 1.5, -2.5, 3.5, -0.5]) * 2.0 ** -3
    t[1, 2, 5, 6:] = 0.0
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want_q, want_s = _ref_quantize(jnp.asarray(t, jd))
    got_q, got_s = port_tf.quantize_kv(torch.from_numpy(t).to(td))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    np.testing.assert_array_equal(got_q.numpy()[1, 2, 5, :6], [127, 0, 2, -2, 4, 0])


def _pair(n_kv_heads=2, n_layers=2, d_model=32, n_heads=4, seed=11,
          tiered=False):
    ref = ref_tf.TransformerLM(vocab_size=VOCAB, d_model=d_model, n_layers=n_layers,
                               n_heads=n_heads, n_kv_heads=n_kv_heads,
                               kv_cache_dtype=jnp.int8)
    params = jax.device_get(ref.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    port = port_tf.TransformerLM(vocab_size=VOCAB, d_model=d_model, n_layers=n_layers,
                                 n_heads=n_heads, n_kv_heads=n_kv_heads,
                                 kv_cache_dtype=torch.int8,
                                 int8_tiered_dispatch=tiered, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return ref, params, port.eval()


def test_int8_cache_after_prefill_matches_reference():
    """f32 model, 9-token prompt into a 512-slot int8 cache.  K/V come out
    of two frameworks' f32 projections and RoPE, which sum in other orders,
    so a code may sit one step apart where t/s lands near a rounding tie,
    and a scale (amax/127, the write itself is bit for bit: the test above)
    carries its amax's difference: a few f32 ulps, more where a projection's
    dot cancels (1.3e-6 relative read on one scale of 2048), so rtol 1e-5."""
    ref, params, port = _pair()
    prompt = np.random.default_rng(1).integers(0, VOCAB, (2, 9))
    dm = ref.clone(attn_impl="dense", decode=True)
    cache = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda: dm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((2, 512), jnp.int32),
                                       train=False))["cache"])
    _, vars_ = dm.apply({"params": params, "cache": cache},
                        jnp.asarray(prompt, jnp.int32), train=False, mutable=["cache"])
    got = port.init_cache(2, 512)
    with torch.no_grad():
        port(torch.from_numpy(prompt), cache=got, start=0)
    for i in range(2):
        layer = vars_["cache"][f"block_{i}"]["attn"]
        for name, rows, scales in (("key", got.keys[i], got.key_scales[i]),
                                   ("value", got.values[i], got.value_scales[i])):
            want_rows = np.asarray(layer[f"cached_{name}"]).astype(np.int32)
            want_scales = np.asarray(layer[f"cached_{name}_scale"])
            assert rows.dtype == torch.int8 and scales.dtype == torch.float32
            assert np.abs(rows.numpy().astype(np.int32) - want_rows).max() <= 1
            np.testing.assert_allclose(scales.numpy(), want_scales, rtol=1e-5)
            assert not rows[:, :, 9:].any() and not scales[:, :, 9:].any()


def _int8_inputs(B, S, H, Hkv, D, seed):
    """q and an int8 cache quantized from random K/V by the reference's
    write; every slot holds data, so slots past ``pos`` are garbage the
    kernel must not see."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kq, ks = _ref_quantize(jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.float32))
    vq, vs = _ref_quantize(jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.float32))
    return q, *(np.array(a) for a in (kq, ks, vq, vs))


@pytest.mark.parametrize("S,pos", [
    (512, 0), (512, 127), (512, 128), (512, 511),
    (4096, 0), (4096, 2047), (4096, 2048), (4096, 4095),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_int8_decode_matches_reference_kernel(dtype, S, pos):
    """The plain K4-int8 against the Pallas kernel (interpret mode), q in
    f32 or bf16; 2048-slot blocks at S 4096 put block edges at 2047/2048."""
    q, kq, ks, vq, vs = _int8_inputs(2, S, 4, 2, 32, seed=S + pos)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = ref_da.cached_flash_attention(
        jnp.asarray(q, jd), jnp.asarray(kq), jnp.asarray(vq), jnp.int32(pos),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = port_da.cached_flash_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kq), torch.from_numpy(vq), pos,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert got.dtype == td and got.shape == (2, 1, 4, 32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("q_dtype,cache_dtype", [("float32", "bfloat16"),
                                                 ("bfloat16", "float32")])
def test_plain_decode_with_a_cache_dtype_other_than_q(q_dtype, cache_dtype):
    """q is cast to the cache dtype and the output comes back in q's, as
    the reference's kernel does (bf16 involved: BF16_TOL)."""
    rng = np.random.default_rng(7)
    B, S, H, Hkv, D, pos = 2, 512, 4, 2, 32, 300
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, H, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    j = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    t = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    want = ref_da.cached_flash_attention(
        jnp.asarray(q, j[q_dtype]), jnp.asarray(k, j[cache_dtype]),
        jnp.asarray(v, j[cache_dtype]), jnp.int32(pos))
    got = port_da.cached_flash_attention(
        torch.from_numpy(q).to(t[q_dtype]), torch.from_numpy(k).to(t[cache_dtype]),
        torch.from_numpy(v).to(t[cache_dtype]), pos)
    assert got.dtype == t[q_dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("positions", [[37], [5, 6, 7]])
def test_scale_folding_einsum_matches_reference(positions):
    q, kq, ks, vq, vs = _int8_inputs(2, 128, 4, 2, 32, seed=3)
    q = np.random.default_rng(4).standard_normal((2, len(positions), 4, 32)).astype(np.float32)
    want = ref_tf._cached_attention_quant(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        jnp.asarray(positions, jnp.int32))
    got = port_tf._cached_attention_quant(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(ks),
        torch.from_numpy(vq), torch.from_numpy(vs), torch.tensor(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def _count_kernel_calls(monkeypatch):
    calls = []
    real = port_tf.cached_flash_attention

    def counted(q, k, v, pos, **scales):
        calls.append((int(pos), k.dtype))
        return real(q, k, v, pos, **scales)

    monkeypatch.setattr(port_tf, "cached_flash_attention", counted)
    return calls


def test_greedy_int8_cache_default_dispatch_matches_reference(monkeypatch):
    """Every decode step takes the scale-folding einsum on both sides."""
    ref, params, port = _pair()
    calls = _count_kernel_calls(monkeypatch)
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 7))
    want = np.asarray(ref_gen.generate(ref, params, jnp.asarray(prompt, jnp.int32), 12))
    got = port_gen.generate(port, torch.from_numpy(prompt), 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert calls == []


def test_greedy_int8_cache_tiered_dispatch_matches_reference(monkeypatch):
    """The tiered switch on both sides (the reference's module flag set for
    this test and restored), 120 new tokens after a 6-token prompt in a
    512-slot cache: positions 6-125 cross the break-even at
    100·p < 19·512 (p <= 97), so the kernel's int8 mode serves the early
    steps and the einsum the late ones."""
    ref, params, port = _pair(tiered=True)
    calls = _count_kernel_calls(monkeypatch)
    prompt = np.random.default_rng(6).integers(0, VOCAB, (1, 6))
    ref_tf._INT8_TIERED_DISPATCH = True
    try:
        want = np.asarray(ref_gen.generate(ref, params, jnp.asarray(prompt, jnp.int32), 120))
    finally:
        ref_tf._INT8_TIERED_DISPATCH = False
    got = port_gen.generate(port, torch.from_numpy(prompt), 120).numpy()
    np.testing.assert_array_equal(got, want)
    taken = sorted({p for p, _ in calls})
    assert taken == list(range(6, 98)) and len(calls) == 2 * len(taken)
    assert {d for _, d in calls} == {torch.int8}


def test_engine_refuses_int8_kv():
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )

    _, _, port = _pair()
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ContinuousEngine(port, EngineConfig(max_lanes=2, block_size=4, num_blocks=8,
                                            max_len=16), device="cpu")


@pytest.mark.parametrize("quant", [[], ["--quant", "int8"]], ids=["bf16", "w8"])
def test_cli_generate_with_int8_kv_cache(quant, capsys):
    from distributed_machine_learning_tpu_torch.cli import generate as cli

    cli.main(["--random-init", "--device", "cpu", "--kv-cache-dtype", "int8",
              "--max-new-tokens", "6", "--temperature", "0", "--d-model", "32",
              "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
              "--prompt", "The "] + quant)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("WARNING: --random-init") and out[-1].startswith("The ")


def test_wrapper_refuses_what_it_cannot_take():
    q = torch.zeros(1, 1, 4, 16)
    k8 = torch.zeros(1, 2, 512, 16, dtype=torch.int8)
    scales = torch.ones(1, 2, 512)
    with pytest.raises(ValueError, match="k_scale"):
        port_da.cached_flash_attention(q, k8, k8, 3)
    with pytest.raises(ValueError, match="k_scale"):
        port_da.cached_flash_attention(q, k8, k8, 3, k_scale=scales)
    with pytest.raises(ValueError, match=r"v_scale must be \[B, Hkv, S\]"):
        port_da.cached_flash_attention(q, k8, k8, 3, k_scale=scales,
                                       v_scale=torch.ones(1, 2, 256))
    with pytest.raises(ValueError, match="go with int8 caches"):
        cache = torch.zeros(1, 2, 512, 16)
        port_da.cached_flash_attention(q, cache, cache, 3, k_scale=scales, v_scale=scales)
    assert port_da.pick_block_s(4608, port_da.INT8_BLOCK_TARGET) == 1536
    for S in (512, 1536, 4096, 4608, 32768):
        assert (port_da.pick_block_s(S, 2048) == ref_da.pick_block_s(S, target=2048)), S
