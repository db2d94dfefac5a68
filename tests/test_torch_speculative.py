"""Speculative decoding and the model's continuation and per-row frontiers,
the port vs the JAX package, on the CPU.

The same weights (the reference's init, converted) and prompts go through
JAX's ``make_speculative_generate_fn`` and the port's.  Greedy speculative
streams are token-exact in f32 against both JAX's and the port's vanilla
greedy, at batch 1 (a scalar frontier) and batched (per-row frontiers),
with bf16-free f32 caches, int8 caches and int8 targets.  The sampled rule
(``sampled_acceptance``) is held against JAX's on identical inputs and a
NumPy oracle; the served distribution against the exact warped target law
and plain sampling at JAX's TV thresholds.  Tensor-parallel targets are in
``tests/test_torch_tp_decode.py``; MoE targets in ``test_torch_moe.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.inference import speculative as ref_spec
from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
from distributed_machine_learning_tpu.ops.quant import quantize_lm_params as ref_quantize
from distributed_machine_learning_tpu.train.lm_step import init_lm_state
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.inference.generate import (
    make_generate_fn,
    warp_logits,
)
from distributed_machine_learning_tpu_torch.inference.speculative import (
    make_speculative_generate_fn,
    sampled_acceptance,
)
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

VOCAB = 48
TARGET = dict(d_model=32, n_layers=3, n_heads=4)
DRAFT = dict(d_model=16, n_layers=1, n_heads=2)


def _pair(shape, seed=0, vocab=VOCAB, **kw):
    """A reference model, its params (the reference's init) and the port's
    twin holding the same weights."""
    ref = RefLM(vocab_size=vocab, **shape, **kw)
    params = jax.device_get(init_lm_state(ref, seed=seed).params)
    port_kw = {k: (torch.int8 if v is jnp.int8 else v) for k, v in kw.items()}
    port = TransformerLM(vocab_size=vocab, **shape, **port_kw, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return ref, params, port.eval()


def _models(**kw):
    return _pair(TARGET, 0, **kw), _pair(DRAFT, 7, **kw)


def _prompt(B, L, seed=0, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab, (B, L))


def _ref_spec(t, d, prompt, new, gamma, key=0, **kw):
    fn = ref_spec.make_speculative_generate_fn(t[0], d[0], new, gamma=gamma, **kw)
    return np.asarray(fn(t[1], d[1], jnp.asarray(prompt, jnp.int32),
                         jax.random.PRNGKey(key)))


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_greedy_speculative_equals_vanilla_and_reference(gamma):
    """Any draft, here an unrelated random one, gives exactly the target's
    greedy stream: the port's vanilla loop and JAX's speculative program."""
    t, d = _models()
    prompt = _prompt(1, 6)
    fn = make_speculative_generate_fn(t[2], d[2], 12, gamma=gamma)
    got = fn(torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, make_generate_fn(t[2], 12)(torch.from_numpy(prompt)))
    np.testing.assert_array_equal(got, _ref_spec(t, d, prompt, 12, gamma))
    assert fn.stats["rows"] == 1 and fn.stats["rounds"] >= 1


def test_target_as_draft_accepts_every_proposal():
    """draft = target: every proposal accepted, the bonus path each round."""
    t, _ = _models()
    prompt = torch.from_numpy(_prompt(1, 5, seed=1))
    fn = make_speculative_generate_fn(t[2], t[2], 10, gamma=4)
    np.testing.assert_array_equal(fn(prompt), make_generate_fn(t[2], 10)(prompt))
    assert fn.stats["accepted"] == 4 * fn.stats["rounds"], fn.stats


@pytest.mark.parametrize("gamma", [2, 4])
def test_batched_greedy_per_row_frontiers(gamma):
    """Batch 8, distinct prompts: each row commits its own count a round
    (per-row frontiers), yet every row is its vanilla greedy stream."""
    t, d = _models()
    prompt = _prompt(8, 6, seed=2)
    got = make_speculative_generate_fn(t[2], d[2], 12, gamma=gamma)(
        torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, make_generate_fn(t[2], 12)(torch.from_numpy(prompt)))
    np.testing.assert_array_equal(got, _ref_spec(t, d, prompt, 12, gamma))


def test_batched_equals_rowwise_single():
    """Frozen rows cannot leak into live rows: the batched program serves
    each row as the batch-1 program serves it alone."""
    t, d = _models()
    prompts = torch.from_numpy(_prompt(4, 5, seed=3))
    fn = make_speculative_generate_fn(t[2], d[2], 9, gamma=3)
    batched = fn(prompts)
    for b in range(4):
        np.testing.assert_array_equal(batched[b:b + 1], fn(prompts[b:b + 1]))


@pytest.mark.parametrize("B", [1, 4])
def test_sampled_speculative_runs_and_stays_in_vocab(B):
    t, d = _models()
    prompt = torch.from_numpy(_prompt(B, 5, seed=4))
    fn = make_speculative_generate_fn(t[2], d[2], 10, gamma=3, temperature=0.8,
                                      top_k=20, top_p=0.9)
    out = fn(prompt, torch.Generator().manual_seed(3))
    again = fn(prompt, torch.Generator().manual_seed(3))
    assert out.shape == (B, 15)
    assert (out >= 0).all() and (out < VOCAB).all()
    torch.testing.assert_close(out[:, :5], prompt, rtol=0, atol=0)
    torch.testing.assert_close(out, again, rtol=0, atol=0)  # seeded


def _oracle_acceptance(d, q, p, u):
    """The Leviathan rule as the paper states it, row by row (the JAX
    test's oracle)."""
    B, gamma = d.shape
    n_accs, resids = [], []
    for b in range(B):
        n = 0
        while n < gamma and u[b, n] * q[b, n, d[b, n]] < p[b, n, d[b, n]]:
            n += 1
        r = (np.maximum(p[b, n] - q[b, n], 0.0) if n < gamma else p[b, gamma].copy())
        n_accs.append(n)
        resids.append(r / max(r.sum(), 1e-30))
    return np.asarray(n_accs), np.stack(resids)


def test_sampled_acceptance_matches_reference_and_oracle():
    """Identical inputs through JAX's ``sampled_acceptance``, the port's and
    the oracle: the accepted counts exactly, the residuals to f32 rounding
    (rtol 1e-5, atol 1e-6, the JAX test's limits), with all-accept rows and
    the rule's arithmetic (accepted mass + rejected mass × residual = p)."""
    rng = np.random.default_rng(5)
    B, gamma, V = 64, 4, 12
    q = rng.random((B, gamma, V)).astype(np.float32)
    q /= q.sum(-1, keepdims=True)
    p = rng.random((B, gamma + 1, V)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    p[:8, :gamma] = q[:8]  # draft == target: p/q = 1 > u
    d = rng.integers(0, V, (B, gamma))
    u = rng.random((B, gamma)).astype(np.float32)
    n_acc, resid = sampled_acceptance(*map(torch.from_numpy, (d, q, p, u)))
    want_n, want_r = jax.jit(ref_spec.sampled_acceptance)(
        jnp.asarray(d, jnp.int32), jnp.asarray(q), jnp.asarray(p), jnp.asarray(u))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(resid.numpy(), np.asarray(want_r), rtol=1e-5, atol=1e-6)
    n_ref, r_ref = _oracle_acceptance(d, q, p, u)
    np.testing.assert_array_equal(n_acc.numpy(), n_ref)
    np.testing.assert_allclose(resid.numpy(), r_ref, rtol=1e-5, atol=1e-6)
    assert (n_acc.numpy()[:8] == gamma).all()
    p0, q0 = p[8:, 0], q[8:, 0]
    accept = np.minimum(p0, q0)
    r0 = np.maximum(p0 - q0, 0.0)
    r0 /= r0.sum(-1, keepdims=True)
    np.testing.assert_allclose(accept + (1.0 - accept.sum(-1, keepdims=True)) * r0, p0,
                               rtol=1e-5, atol=1e-6)


def _tv(a, b):
    return 0.5 * float(np.abs(a - b).sum())


def test_sampled_speculative_preserves_distribution():
    """8192 iid speculative streams (one prompt on per-row frontiers) vs the
    exact warped target law at the first token and plain sampled decoding
    later, at JAX's thresholds (TV 0.06 and 0.09; E[TV] ≈ 0.03 at n 8192
    and an effective support of ≲ 12)."""
    V, temperature, top_k, top_p = 16, 0.9, 12, 0.9
    _, _, target = _pair(dict(d_model=16, n_layers=1, n_heads=2), 0, vocab=V)
    _, _, draft = _pair(dict(d_model=8, n_layers=1, n_heads=2), 7, vocab=V)
    n, new = 8192, 4
    prompt1 = torch.tensor([[3, 7, 1]])
    prompt = prompt1.repeat(n, 1)
    spec = make_speculative_generate_fn(target, draft, new, gamma=3,
                                        temperature=temperature, top_k=top_k, top_p=top_p)
    out_s = spec(prompt, torch.Generator().manual_seed(0))[:, 3:].numpy()
    plain = make_generate_fn(target, new, temperature=temperature, top_k=top_k,
                             top_p=top_p)
    out_p = plain(prompt, torch.Generator().manual_seed(1))[:, 3:].numpy()
    with torch.no_grad():
        logits = target(prompt1)[0, -1]
    p0 = torch.softmax(warp_logits(logits, temperature, top_k, top_p), -1).numpy()
    hist_s = np.bincount(out_s[:, 0], minlength=V) / n
    assert _tv(hist_s, p0) < 0.06, (hist_s, p0)
    assert hist_s[p0 <= 0].sum() == 0.0  # warped-out tokens never emitted
    for j in range(1, new):
        hj_s = np.bincount(out_s[:, j], minlength=V) / n
        hj_p = np.bincount(out_p[:, j], minlength=V) / n
        assert _tv(hj_s, hj_p) < 0.09, j


def test_batched_greedy_speculative_int8_kv_cache():
    """Per-row frontiers with int8 caches: per-row rows and scales written
    together, the scale-folding einsum; equal to vanilla int8-KV greedy and
    to JAX's speculative program."""
    t, d = _models(kv_cache_dtype=jnp.int8)
    prompt = _prompt(4, 6, seed=6)
    got = make_speculative_generate_fn(t[2], d[2], 10, gamma=3)(
        torch.from_numpy(prompt)).numpy()
    np.testing.assert_array_equal(got, make_generate_fn(t[2], 10)(torch.from_numpy(prompt)))
    np.testing.assert_array_equal(got, _ref_spec(t, d, prompt, 10, 3))


def test_greedy_speculative_with_int8_target_and_draft():
    t, d = _models()
    prompt = _prompt(1, 5, seed=7)
    qt, qd = quantize_lm(t[2]), quantize_lm(d[2])
    got = make_speculative_generate_fn(qt, qd, 10, gamma=3, quantize="int8",
                                       draft_quantize="int8")(torch.from_numpy(prompt))
    np.testing.assert_array_equal(
        got, make_generate_fn(qt, 10, quantize="int8")(torch.from_numpy(prompt)))
    ref = ref_spec.make_speculative_generate_fn(t[0], d[0], 10, gamma=3, quantize="int8",
                                                draft_quantize="int8")
    want = ref(ref_quantize(t[1]), ref_quantize(d[1]), jnp.asarray(prompt, jnp.int32),
               jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_speculative_guards():
    t, d = _models()
    with pytest.raises(ValueError, match="gamma"):
        make_speculative_generate_fn(t[2], d[2], 8, gamma=0)
    with pytest.raises(ValueError, match="max_new_tokens"):
        make_speculative_generate_fn(t[2], d[2], 0)
    other = TransformerLM(vocab_size=VOCAB + 1, **DRAFT, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        make_speculative_generate_fn(t[2], other, 8)
    with pytest.raises(ValueError, match="quantize"):
        make_speculative_generate_fn(t[2], d[2], 8, quantize="int4")
    with pytest.raises(ValueError, match="quantize_lm"):  # the float model for int8
        make_speculative_generate_fn(t[2], d[2], 8, quantize="int8")


def _ref_decode_logits(ref, params, prompt, cont, idx, **flags):
    """JAX's decode clone: prefill ``prompt``, set the frontier to ``idx``
    (a scalar or one a row), then apply ``cont``.  Returns its logits and
    the cache after the prefill."""
    dm = ref.clone(attn_impl="dense", decode=True, **flags)
    B = prompt.shape[0]
    cache = dm.init(jax.random.PRNGKey(0), jnp.zeros((B, 512), jnp.int32))["cache"]
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
    _, v = dm.apply({"params": params, "cache": cache}, jnp.asarray(prompt, jnp.int32),
                    mutable=["cache"])
    cache = dict(v["cache"])
    cache["idx"] = jnp.asarray(idx, jnp.int32)
    logits, _ = dm.apply({"params": params, "cache": cache}, jnp.asarray(cont, jnp.int32),
                         mutable=["cache"])
    return np.asarray(logits), v["cache"]


def _load_ref_cache(cache, ref_cache) -> None:
    """The reference's prefilled cache contents into the port's cache."""
    for i in range(len(cache.keys)):
        layer = ref_cache[f"block_{i}"]["attn"]
        for name, rows, scales in (("key", cache.keys, cache.key_scales),
                                   ("value", cache.values, cache.value_scales)):
            rows[i].copy_(torch.from_numpy(np.array(layer[f"cached_{name}"])))
            if scales is not None:
                scales[i].copy_(torch.from_numpy(np.array(layer[f"cached_{name}_scale"])))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_continuation_and_per_row_frontier_logits_match_reference(kv):
    """The model's multi-token continuation (a scalar frontier past 0) and
    its per-row frontiers (rows rewound to different points of their
    prefill, then 3 tokens a row) against JAX's ``decode_continuation`` and
    ``decode_batched_frontier`` clones, each side continuing from the
    reference's prefilled cache (an int8 prefill's codes may sit one step
    apart across frameworks, tests/test_torch_kv_int8.py): f32 logits to
    1e-4 (summation order)."""
    flags = {} if kv is None else {"kv_cache_dtype": jnp.int8}
    ref, params, port = _pair(dict(d_model=32, n_layers=2, n_heads=4), 0, n_kv_heads=2,
                              **flags)
    prompt, cont = _prompt(3, 9, seed=8), _prompt(3, 3, seed=9)
    idx = np.array([9, 5, 7])
    want_scalar, prefilled = _ref_decode_logits(ref, params, prompt, cont, 9,
                                                decode_continuation=True)
    want_rows, _ = _ref_decode_logits(ref, params, prompt, cont, idx,
                                      decode_continuation=True, decode_batched_frontier=True)
    with torch.no_grad():
        cache = port.init_cache(3, 512)
        port(torch.from_numpy(prompt), cache=cache, start=0)
        if kv is None:  # the port's own f32 prefill is held here too
            np.testing.assert_allclose(cache.keys[1].numpy(),
                                       np.asarray(prefilled["block_1"]["attn"]["cached_key"]),
                                       rtol=1e-4, atol=1e-5)
        _load_ref_cache(cache, prefilled)
        got_scalar = port(torch.from_numpy(cont), cache=cache, start=9)
        _load_ref_cache(cache, prefilled)
        got_rows = port(torch.from_numpy(cont), cache=cache, start=torch.from_numpy(idx))
        # One token a row at per-row frontiers: the one-token einsum path.
        one = port(torch.from_numpy(cont[:, :1]), cache=cache,
                   start=torch.from_numpy(idx + 3))
    np.testing.assert_allclose(got_scalar.numpy(), want_scalar, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_rows.numpy(), want_rows, rtol=1e-4, atol=1e-4)
    assert one.shape == (3, 1, VOCAB) and torch.isfinite(one).all()
