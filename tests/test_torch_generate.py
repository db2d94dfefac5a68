"""The port's serving slice as a whole vs the JAX package, on the CPU.

Greedy generation is the cross-framework contract: the same converted
weights and prompt must give the same tokens, token for token, in f32 —
for MHA and GQA, dense prefill and flash prefill, the decode kernel's
path (cache >= 4096 slots), EOS early exit, the ragged serving step and
int8 weights.  Also: the entry points refuse to fall back to the CPU, and
the port never imports jax.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributed_machine_learning_tpu.inference.generate  # noqa: F401
from distributed_machine_learning_tpu.models.transformer import (
    TransformerLM as RefLM,
)
from distributed_machine_learning_tpu.ops.quant import (
    quantize_lm_params as ref_quantize,
)
from distributed_machine_learning_tpu_torch import resolve_device
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.inference import generate as port_gen
from distributed_machine_learning_tpu_torch.models.transformer import (
    TransformerLM,
)
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

# The reference package's __init__ re-exports a function named generate,
# which shadows the module attribute: take the module from sys.modules.
ref_gen = sys.modules["distributed_machine_learning_tpu.inference.generate"]
VOCAB = 257
REPO = Path(__file__).resolve().parents[1]


def _pair(n_kv_heads=2, n_layers=2, d_model=32, n_heads=4, seed=11):
    ref = RefLM(vocab_size=VOCAB, d_model=d_model, n_layers=n_layers,
                n_heads=n_heads, n_kv_heads=n_kv_heads)
    params = jax.device_get(ref.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    port = TransformerLM(vocab_size=VOCAB, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads,
                         n_kv_heads=n_kv_heads, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return ref, params, port


def _prompt(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, L))


def _both(ref, params, port, prompt, max_new, **kw):
    want = np.asarray(ref_gen.generate(ref, params, jnp.asarray(prompt, jnp.int32),
                                       max_new, **kw))
    got = port_gen.generate(port, torch.from_numpy(prompt), max_new, **kw)
    return want, got.numpy()


@pytest.mark.parametrize("n_kv_heads", [None, 2], ids=["mha", "gqa"])
def test_greedy_dense_prefill_matches_reference(n_kv_heads):
    ref, params, port = _pair(n_kv_heads)
    want, got = _both(ref, params, port, _prompt(2, 7), 6)
    assert got.shape == (2, 13)
    np.testing.assert_array_equal(got, want)


def test_greedy_flash_prefill_matches_reference():
    """A 512-token prompt takes the flash branch on both sides."""
    ref, params, port = _pair(2)
    want, got = _both(ref, params, port, _prompt(1, 512, seed=1), 4)
    np.testing.assert_array_equal(got, want)


def test_greedy_with_decode_kernel_path_matches_reference():
    """A 4090-token prompt: padded flash prefill and a 4608-slot cache, so
    every decode step takes cached_flash_attention on both sides."""
    ref, params, port = _pair(2, n_layers=1, d_model=16, n_heads=2)
    want, got = _both(ref, params, port, _prompt(1, 4090, seed=2), 3)
    np.testing.assert_array_equal(got, want)


def test_eos_early_exit_matches_reference():
    ref, params, port = _pair(2)
    prompt = _prompt(1, 5, seed=3)
    full = port_gen.generate(port, torch.from_numpy(prompt), 8).numpy()
    eos = int(full[0, 5 + 2])  # the third generated token
    want, got = _both(ref, params, port, prompt, 8, eos_id=eos)
    np.testing.assert_array_equal(got, want)
    first = 5 + int(np.argmax(full[0, 5:] == eos))
    np.testing.assert_array_equal(got[0, :first + 1], full[0, :first + 1])
    assert (got[0, first:] == eos).all()


def test_serving_step_ragged_matches_reference():
    ref, params, port = _pair(2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (3, 5, 3, 6)]
    want = ref_gen.make_serving_step(ref, params, 4)(prompts)
    got = port_gen.make_serving_step(port, 4)(prompts)
    assert got == want
    with pytest.raises(ValueError, match="empty"):
        port_gen.make_serving_step(port, 4)([[1], []])


def test_int8_generate_matches_reference():
    ref, params, port = _pair(2)
    prompt = _prompt(2, 9, seed=5)
    # int8 logits: both sides round the projection inputs to bf16 inside
    # the W8A16 product; an f32 last-bit difference upstream can flip one
    # such rounding (2^-8 relative on that input), so 1e-2 on logits.
    q_params = ref_quantize(params)
    dm = ref.clone(attn_impl="dense", decode=True, weight_quant="int8")
    cache = dm.init(jax.random.PRNGKey(0), jnp.zeros((2, 512), jnp.int32))["cache"]
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
    want_logits, _ = dm.apply({"params": q_params, "cache": cache},
                              jnp.asarray(prompt, jnp.int32), mutable=["cache"])
    qm = quantize_lm(port)
    with torch.no_grad():
        got_logits = qm(torch.from_numpy(prompt), cache=qm.init_cache(2, 512))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-2, atol=1e-2)
    want, got = _both(ref, params, port, prompt, 6, quantize="int8")
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded_and_topk1_is_greedy():
    _, _, port = _pair(2)
    prompt = torch.from_numpy(_prompt(2, 5, seed=6))
    a = port_gen.generate(port, prompt, 6, temperature=0.9, top_p=0.9,
                          generator=torch.Generator().manual_seed(3))
    b = port_gen.generate(port, prompt, 6, temperature=0.9, top_p=0.9,
                          generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    greedy = port_gen.generate(port, prompt, 6)
    top1 = port_gen.generate(port, prompt, 6, temperature=0.7, top_k=1)
    torch.testing.assert_close(top1, greedy, rtol=0, atol=0)


def test_warp_logits_matches_reference():
    logits = np.random.default_rng(7).standard_normal((3, 50)).astype(np.float32)
    for kw in ({"top_k": 5, "top_p": None}, {"top_k": None, "top_p": 0.6},
               {"top_k": 10, "top_p": 0.8}):
        want = ref_gen.warp_logits(jnp.asarray(logits), 0.7, **kw)
        got = port_gen.warp_logits(torch.from_numpy(logits), 0.7, **kw)
        np.testing.assert_array_equal(np.isinf(got.numpy()),
                                      np.isinf(np.asarray(want)))


def test_make_generate_fn_refuses_mismatched_quantization():
    _, _, port = _pair(2)
    with pytest.raises(ValueError, match="quantize_lm"):
        port_gen.make_generate_fn(port, 4, quantize="int8")


def test_resolve_device_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import distributed_machine_learning_tpu_torch.cli.generate as g\n"
        "g.main(['--random-init', '--device', 'cpu', '--max-new-tokens', '3',"
        " '--d-model', '32', '--n-layers', '1', '--n-heads', '4',"
        " '--n-kv-heads', '2', '--quant', 'int8'])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))"
        " or m.split('.')[0] == 'distributed_machine_learning_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
