"""Port TransformerLM (models/transformer.py + convert.py) vs the Flax model.

Weights are initialized by the reference, converted with
``convert.flax_to_state_dict`` and loaded into the port; the same numpy
tokens go through both.  Everything here is f32 on the CPU, where the
point is the algorithm: logits agree to f32 summation-order noise through
two layers, 1e-4 absolute on logits of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.models.transformer import (
    TransformerLM as RefLM,
)
from distributed_machine_learning_tpu.models.transformer import (
    apply_rope as ref_rope,
)
from distributed_machine_learning_tpu.ops.quant import (
    quantize_lm_params as ref_quantize,
)
from distributed_machine_learning_tpu_torch.convert import (
    flax_to_state_dict,
    init_params,
)
from distributed_machine_learning_tpu_torch.models.transformer import (
    TransformerLM,
    apply_rope,
)
from distributed_machine_learning_tpu_torch.ops.quant import (
    quantize_lm,
    quantize_lm_params,
)

VOCAB = 257
LOGIT_TOL = 1e-4


def _pair(n_kv_heads, attn_impl="dense", d_model=32, n_layers=2, n_heads=4):
    ref = RefLM(vocab_size=VOCAB, d_model=d_model, n_layers=n_layers,
                n_heads=n_heads, n_kv_heads=n_kv_heads, attn_impl=attn_impl)
    params = jax.device_get(ref.init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"])
    port = TransformerLM(vocab_size=VOCAB, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads,
                         n_kv_heads=n_kv_heads, attn_impl=attn_impl,
                         device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return ref, params, port


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_convert_round_trip(n_kv_heads):
    _, params, port = _pair(n_kv_heads)
    sd = flax_to_state_dict(params)
    back = port.state_dict()
    assert set(back) == set(sd)
    for key, value in sd.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    name = "qkv" if n_kv_heads is None else "kv"
    kernel = np.asarray(params["block_1"]["attn"][name]["kernel"])
    np.testing.assert_array_equal(
        sd[f"blocks.1.attn.{name}.weight"].numpy(),
        kernel.reshape(kernel.shape[0], -1).T)
    out_kernel = np.asarray(params["block_0"]["attn"]["out"]["kernel"])
    np.testing.assert_array_equal(sd["blocks.0.attn.out.weight"].numpy(),
                                  out_kernel.reshape(-1, 32).T)


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_int8_tree_converts_like_port_quantizer(n_kv_heads):
    """The reference's int8 tree, converted, equals the port quantizing the
    converted float weights: bit for bit."""
    _, params, port = _pair(n_kv_heads)
    from_ref = flax_to_state_dict(jax.device_get(ref_quantize(params)))
    from_port = quantize_lm_params(port.state_dict())
    assert set(from_ref) == set(from_port)
    for key, value in from_ref.items():
        torch.testing.assert_close(from_port[key], value, rtol=0, atol=0)
    quantize_lm(port).load_state_dict(from_ref)  # strict key/shape check


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    pos = np.arange(100, 140)
    want = ref_rope(jnp.asarray(x), jnp.asarray(pos))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("L,attn_impl", [(16, "dense"), (512, "auto")],
                         ids=["dense", "flash"])
@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_logits_match_reference(n_kv_heads, L, attn_impl):
    """At L=512 ``auto`` takes the flash branch on both sides."""
    ref, params, port = _pair(n_kv_heads, attn_impl)
    tokens = np.random.default_rng(L).integers(0, VOCAB, (2, L))
    want = ref.apply({"params": params}, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (2, L, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_cached_decode_matches_full_forward(n_kv_heads):
    """Prefill + one-token decode steps through the cache give the logits
    of the full causal pass (cache, RoPE offsets and positions line up)."""
    _, _, port = _pair(n_kv_heads)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, VOCAB, (2, 12)))
    with torch.no_grad():
        full = port(tokens)
        cache = port.init_cache(2, 512)
        steps = [port(tokens[:, :8], cache=cache, start=0)]
        for i in range(8, 12):
            steps.append(port(tokens[:, i:i + 1], cache=cache, start=i))
    torch.testing.assert_close(torch.cat(steps, 1), full, rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_out_of_slice_features_raise():
    # Every attention of the reference is ported (ulysses too); an unknown
    # one is refused.
    with pytest.raises(ValueError, match="unknown attn_impl='sparse'"):
        TransformerLM(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=4,
                      device="cpu", attn_impl="sparse")
    # The int8 KV cache is ported (tests/test_torch_kv_int8.py); a cache
    # dtype outside the reference's set is refused.
    for dtype in ("int8", torch.float16):
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            TransformerLM(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=4,
                          device="cpu", kv_cache_dtype=dtype)
    port = TransformerLM(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=4,
                         device="cpu")
    init_params(port, seed=0)
    # Multi-token decode continuation is ported (speculative decoding's
    # verify pass): 3 tokens at start 4 attend the whole cache and give the
    # full causal pass's logits at those positions (f32 summation order).
    cache = port.init_cache(1, 512)
    tokens = torch.arange(7, dtype=torch.long)[None] % VOCAB
    with torch.no_grad():
        port(tokens[:, :4], cache=cache, start=0)
        cont = port(tokens[:, 4:], cache=cache, start=4)
        full = port(tokens)
    torch.testing.assert_close(cont, full[:, 4:], rtol=1e-5, atol=1e-5)
