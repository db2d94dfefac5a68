"""``cli.lm --parallel tp`` (parallel/tensor_parallel.py, the model's f/g and
vocabulary-split embedding and head) vs the JAX package.

The rule table: every leaf of the reference's LM cut by its ``tp_spec_for``
on a 2-way model axis, converted to the port's names, is bit for bit the
port's ``tp_shard_params`` of the converted whole leaf, on each rank.  The
vocabulary-parallel loss at W 2 against ``F.cross_entropy`` of the whole
logits (the loss and the gradient of each rank's block, f32).
Trajectories: a d64 / 4-layer / 4-head / 2-KV-head / vocab-96 model, B 4 ×
L 64, f32, 3 AdamW steps: the reference initializes it (seed 69143), places
it with ``shard_tp_state`` on a (1, 2) mesh and trains with
``make_tp_lm_train_step``; the port runs ``cli.lm``'s ``build`` in 2 gloo
ranks with the reference's initial weights and the same batches.  Losses
within 1e-5 relative and the gathered parameters within 2e-5
(``tests/test_torch_fsdp_pl.py``'s tolerances); the replicated leaves
(LayerNorms, row-parallel biases) bit for bit equal on the two ranks.  The
same 3 steps under LARS against the reference's (its norms are the whole
leaves'; the port sums a split leaf's squares over the ranks).  The guards
read as the reference's.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
    tp_shard_params,
    tp_spec_for,
)

MODEL = dict(vocab_size=96, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD = 4, 64, 3, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "4", "--n-heads", "4",
         "--n-kv-heads", "2", "--vocab", "96", "--seq-len", str(SEQ), "--batch-size",
         str(BATCH), "--max-iters", str(STEPS)]


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


@functools.lru_cache(maxsize=None)
def _reference(optimizer="adamw"):
    """The JAX TP trajectory on a (1, 2) mesh: (initial params, losses, final
    params)."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel.tensor_parallel import (
        make_tp_lm_train_step,
        shard_tp_batch,
        shard_tp_state,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lars import LARSConfig
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    model = RefLM(**MODEL)
    config = AdamWConfig() if optimizer == "adamw" else LARSConfig()
    state = init_lm_state(model, seed=69143, config=config)
    init = jax.device_get(state.params)
    mesh = make_mesh(WORLD, ("batch", "model"), (1, WORLD))
    step = make_tp_lm_train_step(model, mesh)
    state = shard_tp_state(state, mesh)
    losses = []
    for x, y in _batches():
        state, loss = step(state, *shard_tp_batch(mesh, x, y))
        losses.append(float(loss))
    return init, losses, jax.device_get(state.params)


def _with_weights(weights):
    """cli.lm's init, then the given weights (before the state is laid out)."""
    real = cli_lm.init_lm_state

    def init(model, seed, config):
        state = real(model, seed=seed, config=config)
        model.load_state_dict(weights)
        return state

    cli_lm.init_lm_state = init


def _ce_case(rank, world):
    """The vocabulary-parallel loss of this rank's block of seeded logits,
    and its gradient, beside the whole logits' (every rank draws them)."""
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        vocab_parallel_cross_entropy,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(3, 5, 96, generator=gen) * 4
    targets = torch.randint(0, 96, (3, 5), generator=gen)
    whole = logits.clone().requires_grad_()
    want = torch.nn.functional.cross_entropy(whole.reshape(-1, 96), targets.reshape(-1))
    want.backward()
    cols = slice(rank * 96 // world, (rank + 1) * 96 // world)
    mine = logits[..., cols].clone().requires_grad_()
    import torch.distributed as dist

    got = vocab_parallel_cross_entropy(mine, targets, Comm(rank, world, dist.get_backend()))
    got.backward()
    return (float(got), float(want), mine.grad.numpy(), whole.grad[..., cols].numpy())


def _train_rank(rank, world, init_method, weights):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    _with_weights(weights)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        ce = _ce_case(rank, world)
        runs = {}
        for optimizer in ("adamw", "lars"):
            args = cli_lm.make_parser().parse_args([
                *FLAGS, "--parallel", "tp", "--num-nodes", str(world), "--rank", str(rank),
                "--optimizer", optimizer])
            step, state, place, model = cli_lm.build(args, ctx)
            losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
            local = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
            params = {k: v.numpy() for k, v in step.params_fn(state).items()}
            runs[optimizer] = (losses, params, local, state.step)
        return (*runs["adamw"], ce, runs["lars"])
    finally:
        ctx.shutdown()


@functools.lru_cache(maxsize=None)
def _port():
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init = _reference()[0]
    return spawn(_train_rank, WORLD, (flax_to_state_dict(init),), timeout_s=300)


def test_rule_table_matches_reference():
    """Each rank's slice of every leaf under the reference's tp_spec_for is
    the port's slice of the same leaf, bit for bit; the leaves the reference
    replicates are the ones the port keeps whole."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel.tensor_parallel import (
        tp_spec_for as ref_spec_for,
    )
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    for n_kv in (2, None):  # GQA (q + kv) and MHA (fused qkv)
        params = jax.device_get(init_lm_state(RefLM(**{**MODEL, "n_kv_heads": n_kv}),
                                              seed=1).params)
        whole = flax_to_state_dict(params)
        for rank in range(WORLD):
            def cut(path, leaf, rank=rank):
                spec = tuple(ref_spec_for(tuple(k.key for k in path), leaf.ndim))
                if "model" not in spec:
                    return leaf
                return np.split(np.asarray(leaf), WORLD, axis=spec.index("model"))[rank]

            want = flax_to_state_dict(jax.tree_util.tree_map_with_path(cut, params))
            got = tp_shard_params(whole, WORLD, rank)
            assert got.keys() == want.keys()
            for name in want:
                assert torch.equal(got[name], want[name]), (n_kv, rank, name)
                # Whole on every rank exactly where the reference replicates.
                assert (tp_spec_for(name) is None) == (want[name].shape == whole[name].shape)


def test_vocab_parallel_loss_matches_full_cross_entropy():
    for got, want, grad, want_grad in (out[4] for out in _port()):
        assert got == pytest.approx(want, rel=1e-6)
        np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-7)


def test_three_steps_match_reference():
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    _, want_losses, want_params = _reference()
    ranks = _port()
    want = flax_to_state_dict(want_params)
    for losses, params, local, steps, _, _ in ranks:
        assert steps == STEPS
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(params[name], w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
            spec = tp_spec_for(name)
            shape = list(w.shape)
            if spec is not None:
                shape[spec[0]] //= WORLD
            assert local[name].shape == tuple(shape), name
    (l0, p0, loc0, _, _, _), (l1, p1, loc1, _, _, _) = ranks
    assert l0 == l1
    for name, t in loc0.items():
        if tp_spec_for(name) is None:  # replicated: the same gradient, no reduction
            assert np.array_equal(t.view(np.uint32), loc1[name].view(np.uint32)), name
    for name, t in p0.items():
        assert np.array_equal(t.view(np.uint32), p1[name].view(np.uint32)), name


def test_lars_steps_match_reference():
    """LARS under TP: every rank scales its slice by the whole leaf's trust
    ratio, as the reference's GSPMD step does."""
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    _, want_losses, want_params = _reference("lars")
    want = flax_to_state_dict(want_params)
    for out in _port():
        losses, params, _, steps = out[5]
        assert steps == STEPS
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(params[name], w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)


def test_guards_read_as_the_reference():
    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel.tensor_parallel import (
        make_tp_lm_train_step as ref_step,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        make_tp_lm_train_step,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    mesh = make_mesh(3, ("batch", "model"), (1, 3))
    for shape in (dict(MODEL, n_heads=4, d_model=64), dict(MODEL, n_heads=6, d_model=96),
                  dict(MODEL, attn_impl="ring")):
        ref_shape = dict(shape)
        with pytest.raises(ValueError) as want:
            ref_step(RefLM(**ref_shape), mesh)
        with pytest.raises(ValueError) as got:
            make_tp_lm_train_step(TransformerLM(**shape, device="cpu"), Comm(0, 3))
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="vocab_size=97 must be divisible by the "
                                         "model-axis size 2"):
        TransformerLM(**dict(MODEL, vocab_size=97), device="cpu", tp_comm=Comm(0, 2),
                      vocab_parallel="both")


def test_cli_runs_one_rank(capsys):
    cli_lm.main([*FLAGS, "--parallel", "tp", "--attn", "flash", "--fused-update",
                 "--max-iters", "2", "--eval-batches", "1"])
    out = capsys.readouterr().out
    assert "lm parallel=tp devices=1 (cpu)" in out and "attn=flash mesh=model1" in out
    assert "Eval: nll/token " in out
