"""MoE serving, the port vs the JAX package, on the CPU: ``models/moe.py``,
``ops/grouped.py`` and the expert layout of ``ops/quant.py``.

Routing invariants (capacity, overflow pass-through, the grouped path equal
to the einsum when nothing drops, dropless), logits and the Switch aux loss
against JAX's forward on converted weights, the counting sort against
JAX's, cached decode against teacher forcing, int8 experts against the
dequantized model, and speculative decoding with an MoE target.  Greedy
comparisons are token-exact in f32.  MoE under tensor-parallel decode is in
``tests/test_torch_tp_decode.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.inference.generate import (
    generate as ref_generate,
)
from distributed_machine_learning_tpu.inference.generate import (
    make_generate_fn as ref_make_generate_fn,
)
from distributed_machine_learning_tpu.inference.speculative import (
    make_speculative_generate_fn as ref_make_spec,
)
from distributed_machine_learning_tpu.models.moe import MoETransformerLM as RefMoE
from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
from distributed_machine_learning_tpu.ops.grouped import sort_by_expert as ref_sort
from distributed_machine_learning_tpu.ops.quant import quantize_lm_params as ref_quantize
from distributed_machine_learning_tpu.train.lm_step import init_lm_state
from distributed_machine_learning_tpu_torch.convert import (
    flax_moe_to_state_dict,
    flax_to_state_dict,
    init_params,
)
from distributed_machine_learning_tpu_torch.inference.generate import (
    generate,
    make_generate_fn,
)
from distributed_machine_learning_tpu_torch.inference.speculative import (
    make_speculative_generate_fn,
)
from distributed_machine_learning_tpu_torch.models.moe import MoEMLP, MoETransformerLM
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.ops.grouped import sort_by_expert
from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

VOCAB = 64
SHAPE = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=4)


def _pair(seed=4, **kw):
    """The reference's tiny MoE LM (4 experts), its params, and the port's
    twin on the same weights."""
    kw.setdefault("n_experts", 4)
    ref = RefMoE(**SHAPE, **kw)
    params = jax.device_get(ref.init(jax.random.PRNGKey(seed),
                                     jnp.zeros((1, 8), jnp.int32))["params"])
    port = MoETransformerLM(**SHAPE, **kw, device="cpu")
    port.load_state_dict(flax_moe_to_state_dict(params))
    return ref, params, port.eval()


def _mlp(n_experts, d_ff, d_model, cf, impl="einsum", seed=0):
    mlp = MoEMLP(d_model, n_experts, d_ff, cf, moe_impl=impl, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-2] if p.dim() > 1
                                                                  else 1.0))
    return mlp


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_moe_mlp_capacity_and_shapes():
    mlp = _mlp(2, 16, 8, 1.0)
    x = _x((2, 8, 8), 0)
    with torch.no_grad():
        y = mlp(x)
    assert y.shape == x.shape
    assert float(mlp.aux_loss) >= 1.0 - 1e-5  # Switch aux >= 1 for any routing
    assert mlp.w_in.shape == (2, 8, 16)


def test_moe_overflow_tokens_pass_through_residual():
    """A starved capacity (1 an expert) drops the rest: zero MLP output."""
    mlp = _mlp(2, 16, 8, 0.01)
    with torch.no_grad():
        y = mlp(_x((1, 8, 8), 1))
    assert int((y.reshape(8, 8).abs().sum(-1) > 1e-7).sum()) <= 2


def test_grouped_impl_matches_einsum_when_nothing_drops():
    """Ample capacity: the dropless grouped path computes the einsum's
    mixture, forward and gradients (the JAX test's limits, 2e-3 and 2e-2)."""
    x = _x((2, 8, 16), 2)
    ein = _mlp(4, 32, 16, 8.0)
    grp = _mlp(4, 32, 16, 8.0, impl="grouped")
    grp.load_state_dict(ein.state_dict())
    ye, yg = ein(x), grp(x)
    torch.testing.assert_close(yg, ye, rtol=2e-3, atol=2e-3)
    (ye * ye).sum().backward()
    (yg * yg).sum().backward()
    for (name, a), b in zip(ein.named_parameters(), grp.parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=2e-2, atol=2e-2, msg=name)


def test_grouped_impl_is_dropless():
    x = _x((1, 16, 8), 3)
    ein = _mlp(2, 16, 8, 0.01)
    grp = _mlp(2, 16, 8, 0.01, impl="grouped")
    grp.load_state_dict(ein.state_dict())
    with torch.no_grad():
        ein_rows = ein(x).reshape(16, 8).abs().sum(-1) > 1e-7
        yg = grp(x)
        assert (yg.reshape(16, 8).abs().sum(-1) > 1e-7).all()
        assert int(ein_rows.sum()) <= 2
        grp.capacity_factor = 4.0  # a no-op for the grouped path
        torch.testing.assert_close(grp(x), yg, rtol=0, atol=0)
        # Serving (dropless) routes every token whatever moe_impl says.
        torch.testing.assert_close(ein(x, dropless=True), yg, rtol=0, atol=0)


@pytest.mark.parametrize("impl,cf", [("einsum", 1.25), ("grouped", 1.25), ("einsum", 8.0)])
def test_logits_and_aux_loss_match_reference(impl, cf):
    """The teacher-forced forward (capacity drops included) and each layer's
    Switch aux loss against JAX's on converted weights: f32 to 1e-5."""
    ref, params, port = _pair(moe_impl=impl, capacity_factor=cf, n_kv_heads=2)
    toks = np.random.default_rng(0).integers(0, VOCAB, (4, 16))
    want, mut = ref.apply({"params": params}, jnp.asarray(toks), mutable=["losses"])
    with torch.no_grad():
        got = port(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    aux = [np.asarray(a).reshape(()) for a in jax.tree_util.tree_leaves(mut["losses"])]
    np.testing.assert_allclose([float(a) for a in port.aux_losses()], aux, rtol=1e-5)


def test_sort_by_expert_matches_reference():
    idx = np.random.default_rng(1).integers(0, 5, 37)
    got = sort_by_expert(torch.from_numpy(idx), 5)
    want = ref_sort(jnp.asarray(idx, jnp.int32), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    order = got[0].numpy()
    assert (np.diff(idx[order]) >= 0).all()  # grouped by expert, stable
    assert (order[got[1].numpy()] == np.arange(37)).all()


@pytest.mark.parametrize("impl", ["einsum", "grouped"])
@pytest.mark.parametrize("seed", [1, 4, 17])
def test_moe_cached_decode_matches_teacher_forced(impl, seed):
    """KV-cached greedy generation (dropless) equals the argmax of the
    dropless teacher-forced forward at every step, and JAX's stream."""
    ref, params, port = _pair(moe_impl=impl, capacity_factor=8.0)
    prompt = np.random.default_rng(seed).integers(0, VOCAB, (2, 5))
    out = generate(port, torch.from_numpy(prompt), 6)
    assert out.shape == (2, 11)
    with torch.no_grad():
        full = port(out)
    np.testing.assert_array_equal(out[:, 5:].numpy(), full[:, 4:-1].argmax(-1).numpy())
    want = ref_generate(ref, params, jnp.asarray(prompt, jnp.int32), max_new_tokens=6)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_moe_quant_requires_decode():
    model = MoETransformerLM(**SHAPE, n_experts=4, weight_quant="int8", device="cpu")
    with pytest.raises(ValueError, match="decode"):
        model(torch.zeros((1, 8), dtype=torch.long))


def _dequantized(qm):
    """The float MoE model holding the int8 twin's dequantized weights (the
    serving reference of the int8 read path)."""
    fm = qm.clone(weight_quant=None)
    sd = {}
    for key, t in qm.state_dict().items():
        module, _, leaf = key.rpartition(".")
        if leaf == "w_q":
            sd[f"{module}.weight"] = (t.float() * qm.state_dict()[f"{module}.scale"]).t()
        elif leaf in ("w_in_q", "w_out_q"):
            scale = qm.state_dict()[f"{module}.{leaf[:-2]}_scale"]
            sd[f"{module}.{leaf[:-2]}"] = t.float() * scale[:, None, :]
        elif leaf != "scale" and not leaf.endswith("_scale"):
            sd[key] = t
    fm.load_state_dict(sd)
    return fm.eval()


@pytest.mark.parametrize("seed", [1, 4])
def test_moe_quantized_generate_token_exact_vs_dequant(seed):
    """int8 MoE serving: experts per expert and per output channel through
    the grouped path, attention and the head through K6's plain version:
    its stream equals the dequantized model's, and JAX's int8 stream."""
    ref, params, port = _pair()
    qm = quantize_lm(port)
    moe = qm.blocks[0].moe
    assert moe.w_in_q.dtype == torch.int8 and moe.w_in_scale.shape == (4, 128)
    assert qm.blocks[0].moe.router.weight.dtype == torch.float32  # router stays f32
    prompt = np.random.default_rng(seed).integers(0, VOCAB, (2, 5))
    got = make_generate_fn(qm, 8, quantize="int8")(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got, make_generate_fn(_dequantized(qm), 8)(
        torch.from_numpy(prompt)))
    want = ref_make_generate_fn(ref, 8, quantize="int8")(
        ref_quantize(params), jnp.asarray(prompt, jnp.int32), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got, np.asarray(want))


def _draft():
    ref = RefLM(vocab_size=VOCAB, d_model=16, n_layers=1, n_heads=2)
    params = jax.device_get(init_lm_state(ref, seed=7).params)
    port = TransformerLM(vocab_size=VOCAB, d_model=16, n_layers=1, n_heads=2, device="cpu")
    port.load_state_dict(flax_to_state_dict(params))
    return ref, params, port.eval()


@pytest.mark.parametrize("rows", [1, 3])
def test_moe_speculative_greedy_token_exact(rows):
    """An MoE target and a dense draft: vanilla MoE greedy, batched rows on
    per-row frontiers included, and JAX's speculative stream."""
    ref, params, port = _pair()
    dref, dparams, draft = _draft()
    prompt = np.random.default_rng(3).integers(0, VOCAB, (rows, 5))
    got = make_speculative_generate_fn(port, draft, 8, gamma=3)(torch.from_numpy(prompt))
    np.testing.assert_array_equal(got, make_generate_fn(port, 8)(torch.from_numpy(prompt)))
    want = ref_make_spec(ref, dref, 8, gamma=3)(params, dparams,
                                                jnp.asarray(prompt, jnp.int32),
                                                jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_moe_speculative_with_int8_target():
    _, _, port = _pair()
    _, _, draft = _draft()
    qm = quantize_lm(port)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(0, VOCAB, (1, 6)))
    got = make_speculative_generate_fn(qm, draft, 8, gamma=3, quantize="int8")(prompt)
    np.testing.assert_array_equal(got, make_generate_fn(qm, 8, quantize="int8")(prompt))


def test_moe_init_and_refusals():
    """init_params fills the router and the experts; the expert-parallel
    fields (the reference's expert_axis and token_axes, here Comms) and MoE
    × context parallelism construct (their steps: tests/test_torch_ep.py);
    a sequence-sharded attention without its Comm among the token Comms
    raises as the reference does."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    model = MoETransformerLM(**SHAPE, n_experts=4, device="cpu")
    init_params(model, seed=0)
    assert model.blocks[1].moe.w_out.std() > 0 and model.blocks[1].moe.router.weight.std() > 0
    assert not model.blocks[1].moe.b_in.any()
    seq = Comm(0, 2)
    for kw in ({"expert_comm": Comm(0, 2)}, {"token_comms": (Comm(0, 2),)},
               {"attn_impl": "ring", "comm": seq, "token_comms": (seq,)}):
        built = MoETransformerLM(**SHAPE, n_experts=4, device="cpu", **kw)
        moe = built.blocks[0].moe
        assert moe.expert_comm is kw.get("expert_comm")
        assert moe.token_comms == kw.get("token_comms", ())
        assert built.attn_impl == kw.get("attn_impl", "dense")
    with pytest.raises(NotImplementedError, match="the sequence-sharded impls "):
        MoETransformerLM(**SHAPE, n_experts=4, device="cpu", attn_impl="ring")
    with pytest.raises(ValueError, match="moe_impl"):
        MoETransformerLM(**SHAPE, n_experts=4, device="cpu", moe_impl="dense")
