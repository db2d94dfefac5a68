"""Tensor-parallel decode on the CPU: ranks of one process each, over gloo.

Each rank holds its Megatron slice (``parallel/tensor_parallel.py``) of
weights converted from the JAX package's init, and runs the port's
generate or speculative loop on its local-width model; the row-parallel
projections sum over the ranks.  Every rank must return the same tokens,
equal to JAX's single-device stream (which equals JAX's TP stream, its own
tests say) and to the port's one-rank stream: the fused-qkv and GQA
layouts, int8 weights, nucleus sampling on one seed, speculative decoding
(batch 1 and batched, int8 target, sampled), and an MoE target (bf16-free
f32 and int8 experts, speculative).  All in f32; tokens exact.  Also the
layout's divisibility guards and ``cli.generate --tp 2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.inference.generate import (
    make_generate_fn as ref_make_generate_fn,
)
from distributed_machine_learning_tpu.inference.speculative import (
    make_speculative_generate_fn as ref_make_spec,
)
from distributed_machine_learning_tpu.models.moe import MoETransformerLM as RefMoE
from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
from distributed_machine_learning_tpu.ops.quant import quantize_lm_params as ref_quantize
from distributed_machine_learning_tpu.train.lm_step import init_lm_state
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.inference.generate import (
    make_generate_fn,
    make_tp_generate_fn,
)
from distributed_machine_learning_tpu_torch.inference.speculative import (
    make_speculative_generate_fn,
    make_tp_speculative_generate_fn,
)
from distributed_machine_learning_tpu_torch.models.moe import MoETransformerLM
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm
from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
    tp_decode_params,
    tp_local_decode_clone,
)
from distributed_machine_learning_tpu_torch.runtime.distributed import Comm
from distributed_machine_learning_tpu_torch.runtime.launch import spawn

VOCAB = 48
DENSE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4)
DRAFT = dict(vocab_size=VOCAB, d_model=16, n_layers=1, n_heads=2)
MOE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, n_experts=4)


def _ref(kind, shape, seed):
    if kind == "moe":
        ref = RefMoE(**shape)
        return ref, jax.device_get(ref.init(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, 8), jnp.int32))["params"])
    ref = RefLM(**shape)
    return ref, jax.device_get(init_lm_state(ref, seed=seed).params)


def _port(kind, shape, sd):
    cls = MoETransformerLM if kind == "moe" else TransformerLM
    model = cls(**shape, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()


def _numpy(params):
    return {k: v.numpy() for k, v in flax_to_state_dict(params).items()}


# name: (target kind, target shape, n_kv_heads, quantize, mode, B, prompt len,
#        new tokens, gamma)
CASES = {
    "gqa": ("dense", DENSE, 2, None, "greedy", 2, 5, 8, 0),
    "mha": ("dense", DENSE, None, None, "greedy", 1, 4, 6, 0),
    "int8": ("dense", DENSE, 2, "int8", "greedy", 2, 5, 8, 0),
    "top_p": ("dense", DENSE, 2, None, "top_p", 2, 4, 6, 0),
    "spec": ("dense", DENSE, None, None, "greedy", 1, 6, 10, 3),
    "spec_int8": ("dense", DENSE, None, "int8", "greedy", 1, 6, 10, 3),
    "spec_batched": ("dense", DENSE, None, None, "greedy", 3, 5, 8, 2),
    "spec_sampled": ("dense", DENSE, None, None, "sampled", 3, 5, 8, 2),
    "moe": ("moe", MOE, 2, None, "greedy", 2, 5, 8, 0),
    "moe_int8": ("moe", MOE, 2, "int8", "greedy", 2, 5, 8, 0),
    "moe_spec": ("moe", MOE, 2, None, "greedy", 2, 5, 8, 3),
}
SAMPLING = {"greedy": {}, "top_p": dict(temperature=0.8, top_p=0.9),
            "sampled": dict(temperature=0.8, top_k=16)}


def _case_inputs(name):
    kind, shape, n_kv, quant, mode, B, Lp, new, gamma = CASES[name]
    shape = {**shape, "n_kv_heads": n_kv}
    prompt = np.random.default_rng(len(name)).integers(0, VOCAB, (B, Lp))
    return kind, shape, quant, mode, prompt, new, gamma


def _serve(name, target, draft, comm=None):
    """The port's tokens of case ``name`` (one rank of ``comm``, or the
    whole model without it)."""
    _, _, quant, mode, prompt, new, gamma = _case_inputs(name)
    if quant == "int8":
        target = quantize_lm(target)
    kw = dict(quantize=quant, **SAMPLING[mode])
    if gamma and comm is not None:
        fn = make_tp_speculative_generate_fn(target, draft, new, comm, gamma=gamma, **kw)
    elif gamma:
        fn = make_speculative_generate_fn(target, draft, new, gamma=gamma, **kw)
    elif comm is not None:
        fn = make_tp_generate_fn(target, new, comm, **kw)
    else:
        fn = make_generate_fn(target, new, **kw)
    return fn(torch.from_numpy(prompt), torch.Generator().manual_seed(1)).numpy()


def _rank(rank, world, init_method, weights):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method)
    try:
        out = {}
        for name, (tsd, dsd) in weights.items():
            kind, shape, *_ = _case_inputs(name)
            draft = None if dsd is None else _port("dense", DRAFT, dsd)
            out[name] = _serve(name, _port(kind, shape, tsd), draft, ctx.comm)
        return out
    finally:
        ctx.shutdown()


@pytest.fixture(scope="module")
def runs():
    """Every case's reference models, and its tokens from two gloo ranks."""
    refs, weights = {}, {}
    draft = _ref("dense", DRAFT, 7)
    for name in CASES:
        kind, shape, *_, gamma = _case_inputs(name)
        refs[name] = (_ref(kind, shape, 0 if kind == "dense" else 4), draft if gamma else None)
        weights[name] = (_numpy(refs[name][0][1]), _numpy(draft[1]) if gamma else None)
    ranks = spawn(_rank, 2, (weights,), timeout_s=300)
    return refs, weights, ranks


def _reference_tokens(name, refs):
    (ref, params), draft = refs[name]
    _, _, quant, mode, prompt, new, gamma = _case_inputs(name)
    if quant == "int8":
        params = ref_quantize(params)
    p = jnp.asarray(prompt, jnp.int32)
    if gamma:
        fn = ref_make_spec(ref, draft[0], new, gamma=gamma, quantize=quant)
        return np.asarray(fn(params, draft[1], p, jax.random.PRNGKey(0)))
    return np.asarray(ref_make_generate_fn(ref, new, quantize=quant)(
        params, p, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4] == "greedy"])
def test_tp_greedy_equals_one_rank_and_reference(runs, name):
    refs, weights, ranks = runs
    kind, shape, *_ = _case_inputs(name)
    tsd, dsd = weights[name]
    one = _serve(name, _port(kind, shape, tsd), None if dsd is None else _port("dense", DRAFT, dsd))
    np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
    np.testing.assert_array_equal(ranks[0][name], one)
    np.testing.assert_array_equal(ranks[0][name], _reference_tokens(name, refs))


def test_tp_sampling_on_one_seed(runs):
    """Nucleus sampling from the same generator seed on every rank equals
    the one-rank run; the sampled speculative rounds stay in the vocab."""
    _, weights, ranks = runs
    kind, shape, *_ = _case_inputs("top_p")
    one = _serve("top_p", _port(kind, shape, weights["top_p"][0]), None)
    np.testing.assert_array_equal(ranks[0]["top_p"], one)
    np.testing.assert_array_equal(ranks[0]["top_p"], ranks[1]["top_p"])
    s = ranks[0]["spec_sampled"]
    np.testing.assert_array_equal(s, ranks[1]["spec_sampled"])
    assert s.shape == (3, 13) and (s >= 0).all() and (s < VOCAB).all()


def test_tp_four_ranks_fused_qkv():
    """tp 4 over MHA's fused qkv (n_kv_heads = n_heads = 4): one head a rank."""
    shape = {**DENSE, "n_kv_heads": 4}
    ref, params = _ref("dense", shape, 0)
    prompt = np.random.default_rng(5).integers(0, VOCAB, (2, 5))
    out = spawn(_rank4, 4, (_numpy(params), prompt), timeout_s=300)
    want = ref_make_generate_fn(ref, 8)(params, jnp.asarray(prompt, jnp.int32),
                                        jax.random.PRNGKey(0))
    for r in range(4):
        np.testing.assert_array_equal(out[r], np.asarray(want))


def _rank4(rank, world, init_method, sd, prompt):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method)
    try:
        model = _port("dense", {**DENSE, "n_kv_heads": 4}, sd)
        return make_tp_generate_fn(model, 8, ctx.comm)(torch.from_numpy(prompt)).numpy()
    finally:
        ctx.shutdown()


def test_tp_slices_every_leaf_and_guards():
    """The local state_dict loads into the local-width clone leaf for leaf
    (dense and MoE, float and int8: the fused parts sliced each on its
    own); the reference's divisibility rules raise with its words."""
    for cls, shape in ((TransformerLM, {**DENSE, "n_kv_heads": 2}), (MoETransformerLM, MOE)):
        model = cls(**shape, device="cpu")
        for m in (model, quantize_lm(model)):
            local = tp_local_decode_clone(m, Comm(1, 2), m.weight_quant)
            sd = tp_decode_params(m.state_dict(), 2, 1)
            assert {k: v.shape for k, v in sd.items()} == {
                k: v.shape for k, v in local.state_dict().items()}
    model = TransformerLM(**{**DENSE, "n_kv_heads": None}, device="cpu")
    qkv = model.blocks[0].attn.qkv.weight.detach()
    got = tp_decode_params(model.state_dict(), 2, 1)["blocks.0.attn.qkv.weight"]
    torch.testing.assert_close(got, qkv.reshape(3, 4, 8, 32)[:, 2:].reshape(-1, 32))
    with pytest.raises(ValueError, match="n_heads"):
        tp_local_decode_clone(TransformerLM(vocab_size=VOCAB, d_model=18, n_layers=1,
                                            n_heads=6, device="cpu"), Comm(0, 4), None)
    with pytest.raises(ValueError, match="n_kv_heads"):
        tp_local_decode_clone(TransformerLM(vocab_size=VOCAB, d_model=32, n_layers=1,
                                            n_heads=8, n_kv_heads=2, device="cpu"),
                              Comm(0, 4), None)
    with pytest.raises(ValueError, match="d_ff"):
        tp_local_decode_clone(TransformerLM(vocab_size=VOCAB, d_model=32, n_layers=1,
                                            n_heads=4, d_ff=6, device="cpu"), Comm(0, 4), None)
    with pytest.raises(ValueError, match="quantize"):
        make_tp_generate_fn(model, 4, Comm(0, 2), quantize="int8")  # the float model
    # The decode layout: the embedding and the head whole, the row-parallel
    # biases inside the sum.  A pass without a cache is no longer refused
    # (training-time TP is the other layout: tensor_parallel.shard_tp_state).
    local = tp_local_decode_clone(model, Comm(0, 2), None)
    assert local.vocab_parallel is None and not local.blocks[0].tp_train
    assert local.lm_head.weight.shape[0] == VOCAB
    one = tp_local_decode_clone(model, Comm(0, 1), None)
    assert one(torch.zeros((1, 4), dtype=torch.long)).shape == (1, 4, VOCAB)


def test_generate_cli_tp_equals_one_rank(capsys, monkeypatch):
    """``cli.generate --tp 2`` (spawned gloo ranks) prints the one-rank
    command's text, speculative and int8 composed in."""
    from distributed_machine_learning_tpu_torch.cli import generate as cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' intra-op threads

    flags = ["--random-init", "--device", "cpu", "--max-new-tokens", "6",
             "--temperature", "0", "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
             "--n-kv-heads", "2", "--compute-dtype", "float32", "--quant", "int8",
             "--spec-gamma", "2", "--draft-d-model", "16", "--draft-n-layers", "1",
             "--draft-n-heads", "2", "--draft-n-kv-heads", "2"]
    one = cli.main(flags)
    capsys.readouterr()
    tp = cli.main(flags + ["--tp", "2"])
    out = capsys.readouterr().out
    assert tp == one
    assert "tp=2 backend=gloo wire=gloo" in out
    with pytest.raises(ValueError, match="n_heads"):
        cli.main(flags + ["--tp", "3"])
