"""``cli.lm --parallel ring`` and ``--parallel dp`` over torch.distributed vs
the JAX package.

A d64 / 2-layer / 4-head / 2-KV-head / vocab-97 model, B 2 × L 128, f32:
the reference initializes it (seed 69143) and trains 3 steps with
``make_lm_train_step(model, mesh=make_mesh(2, ("batch", "seq"), ...))``,
(1, 2) for ring (its ``ring_flash`` in Pallas interpret mode, or the einsum
``ring``) and (2, 1) for dp; the port runs ``cli.lm``'s ``build`` in 2 gloo
ranks (``runtime/launch.spawn``) with the converted weights and the same
numpy batches.  Tolerances are ``tests/test_torch_lm_train.py``'s: losses
within 1e-5 relative, parameters within 2e-5 after 3 AdamW steps.  Every
rank must end with bit-for-bit the same parameters.  ``--remat
--remat-policy block`` re-runs each block's forward, hops included, inside
the backward: every rank must still make every hop in the same order.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm

MODEL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD = 2, 128, 3, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
# (--parallel, --attn, the reference's attn_impl, its mesh shape, more flags)
MODES = {"ring-flash": ("ring", "flash", "ring_flash", (1, WORLD), ()),
         "ring-flash-remat": ("ring", "flash", "ring_flash", (1, WORLD),
                              ("--remat", "--remat-policy", "block")),
         "ring-dense": ("ring", "dense", "ring", (1, WORLD), ()),
         "dp": ("dp", "dense", "dense", (WORLD, 1), ())}


def _args(parallel, attn, *extra):
    return cli_lm.make_parser().parse_args([
        "--device", "cpu", "--parallel", parallel, "--attn", attn, "--num-nodes", str(WORLD),
        "--d-model", "64", "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
        "--vocab", "97", "--seq-len", str(SEQ), "--batch-size", str(BATCH), *extra])


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


@functools.lru_cache(maxsize=None)
def _reference(impl, shape):
    """The JAX trajectory: (initial params, losses, final params)."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import (
        init_lm_state,
        make_lm_train_step,
        shard_lm_batch,
    )

    model = RefLM(**MODEL, attn_impl=impl)
    state = init_lm_state(model, seed=69143, config=AdamWConfig())
    init = jax.device_get(state.params)
    mesh = make_mesh(WORLD, ("batch", "seq"), shape)
    step = make_lm_train_step(model, mesh=mesh)
    losses = []
    for x, y in _batches():
        state, loss = step(state, *shard_lm_batch(mesh, x, y))
        losses.append(float(loss))
    return init, losses, jax.device_get(state.params)


def _train_rank(rank, world, init_method, mode, weights):
    """One rank: cli.lm's build on its process group, the reference's
    weights loaded, 3 steps on its shards of the global batches."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    parallel, attn, impl, _, extra = MODES[mode]
    args = _args(parallel, attn, "--rank", str(rank), *extra)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        step, state, place, model = cli_lm.build(args, ctx)
        assert model.attn_impl == impl
        model.load_state_dict(weights)
        losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
        return losses, {k: v.numpy() for k, v in model.state_dict().items()}, state.step
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("mode", list(MODES))
def test_three_steps_match_reference(mode):
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init, want_losses, want_params = _reference(*MODES[mode][2:4])
    ranks = spawn(_train_rank, WORLD, (mode, flax_to_state_dict(init)), timeout_s=300)
    for losses, params, steps in ranks:
        assert steps == STEPS
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        for name, want in flax_to_state_dict(want_params).items():
            np.testing.assert_allclose(params[name], want.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
    for name, p in ranks[0][1].items():
        for r in range(1, WORLD):
            assert np.array_equal(ranks[r][1][name].view(np.uint32), p.view(np.uint32)), \
                f"rank {r} {name} differs from rank 0"


def test_attention_upgrade_rule(capsys):
    """The reference's ring → ring_flash rule: --attn flash on any chunk the
    kernels tile natively (a warning and the einsum ring otherwise), --attn
    auto where one-device flash wins on the chunk; dp keeps --attn."""
    impl = lambda *flags: cli_lm.attn_impl(_args(*flags))  # noqa: E731
    assert impl("ring", "flash") == "ring_flash"  # chunk 64
    assert impl("ring", "auto") == "ring"  # flash does not win at 64
    assert impl("ring", "auto", "--seq-len", "4096") == "ring_flash"  # chunk 2048
    assert impl("ring", "dense") == "ring"
    assert impl("dp", "flash") == "flash"
    assert capsys.readouterr().out == ""
    assert impl("ring", "flash", "--seq-len", "200") == "ring"  # chunk 100 would pad
    assert "WARNING: --attn flash with --parallel ring: per-device chunk 100" in \
        capsys.readouterr().out


def test_cli_refusals():
    for flags, exc, match in (
            (["--parallel", "ep", "--num-nodes", "4", "--ep", "2", "--ep-seq", "2",
              "--moe-impl", "grouped", "--batch-size", "2", "--seq-len", "129"], ValueError,
             "--seq-len 129 must be divisible by --ep-seq 2"),
            (["--parallel", "ring", "--num-nodes", "2", "--seq-len", "129"], ValueError,
             "--seq-len 129 must be divisible by the 2-device sequence axis"),
            (["--num-nodes", "2", "--batch-size", "3"], ValueError,
             "--batch-size 3 must be divisible by the 2-device data axis")):
        with pytest.raises(exc, match=match):
            cli_lm.main(["--device", "cpu", *flags])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_lm.main(["--parallel", "ring", "--num-nodes", "2", "--max-iters", "1"])
