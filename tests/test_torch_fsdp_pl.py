"""``cli.lm --parallel fsdp_pl`` (parallel/fsdp_perlayer.py, parallel/gspmd.py)
vs the JAX package.

The rule's choices on fixed shapes and the split fraction of the LM's
parameters are the reference's exactly.  Trajectories: the d64 / 2-layer /
4-head / 2-KV-head / vocab-97 model of ``tests/test_torch_fsdp.py``, B 4 ×
L 64, f32, 3 steps: the reference initializes it (seed 69143), places it
with ``shard_fsdp_pl_state`` on a (2,) mesh and trains with
``make_fsdp_pl_lm_train_step`` (dense attention, with and without
``fused_ce_chunks``); the port runs ``cli.lm``'s ``build`` in 2 gloo ranks
with the reference's initial weights and the same batches.  No gathered leaf
survives the forward (the backward gathers again).  The gathered
parameters are compared; tolerances are ``tests/test_torch_fsdp.py``'s:
losses within 1e-5 relative, parameters within 2e-5 after 3 AdamW steps.
A save after 2 steps and a resume for 2 more is bit for bit an
uninterrupted run over the same batches.  The refusals read as the
reference's.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import fsdp_pl_spec_for

MODEL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD = 4, 64, 3, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "2", "--n-heads", "4",
         "--n-kv-heads", "2", "--vocab", "97", "--seq-len", str(SEQ), "--batch-size",
         str(BATCH)]


def _args(*extra):
    return cli_lm.make_parser().parse_args([*FLAGS, "--parallel", "fsdp_pl", "--num-nodes",
                                            str(WORLD), *extra])


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


@pytest.mark.parametrize("shape", [(8,), (7,), (64, 64), (97, 64), (64, 256), (3, 6, 4),
                                   (2, 2), (1,), (6, 9)])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_rule_choices_match_reference(shape, n):
    from distributed_machine_learning_tpu.parallel.fsdp_perlayer import (
        fsdp_pl_spec_for as ref_spec_for,
    )

    spec = ref_spec_for(n)((), shape)
    want = next((i for i, a in enumerate(spec) if a is not None), None)
    assert fsdp_pl_spec_for(n)("x", shape) == want


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fraction_matches_reference(world):
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel.fsdp_perlayer import (
        fsdp_pl_sharded_fraction as ref_fraction,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
        fsdp_pl_sharded_fraction,
    )
    from distributed_machine_learning_tpu_torch.train.lm_step import init_lm_state as port_init

    model = dict(MODEL, vocab_size=98)  # the head's bias (98,) splits at 2, not at 4
    want = ref_fraction(init_lm_state(RefLM(**model), seed=0), make_mesh(world))
    got = fsdp_pl_sharded_fraction(port_init(TransformerLM(**model, device="cpu")), world)
    assert got == pytest.approx(want, rel=0, abs=0) and 0 < got <= 1
    del jax


@functools.lru_cache(maxsize=None)
def _reference(chunks):
    """The JAX per-layer FSDP trajectory: (initial params, losses, final params)."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel.fsdp_perlayer import (
        make_fsdp_pl_lm_train_step,
        shard_fsdp_pl_state,
    )
    from distributed_machine_learning_tpu.parallel.tensor_parallel import shard_tp_batch
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    model = RefLM(**MODEL)
    state = init_lm_state(model, seed=69143, config=AdamWConfig())
    init = jax.device_get(state.params)
    mesh = make_mesh(WORLD)
    step = make_fsdp_pl_lm_train_step(model, mesh, fused_ce_chunks=chunks)
    state = shard_fsdp_pl_state(state, mesh)
    losses = []
    for x, y in _batches():
        state, loss = step(state, *shard_tp_batch(mesh, x, y))
        losses.append(float(loss))
    return init, losses, jax.device_get(state.params)


def _with_weights(weights):
    """cli.lm's init, then the given weights (before the state is sharded)."""
    real = cli_lm.init_lm_state

    def init(model, seed, config):
        state = real(model, seed=seed, config=config)
        model.load_state_dict(weights, strict=False)
        return state

    cli_lm.init_lm_state = init


def _train_rank(rank, world, init_method, extra, weights):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    _with_weights(weights)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    real_backward = torch.Tensor.backward
    try:
        step, state, place, model = cli_lm.build(_args("--rank", str(rank), *extra), ctx)
        resident = []

        def backward(loss, *a, **k):
            # Between the forward and the backward: how many of the step's
            # gathered leaves are still alive (held by a module or the graph).
            live = model.fsdp_pl.live.values()
            resident.append((sum(ref() is not None for ref, _ in live), len(live)))
            return real_backward(loss, *a, **k)

        torch.Tensor.backward = backward
        losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
        torch.Tensor.backward = real_backward
        params = step.params_fn(state)
        blocks = {k: tuple(p.shape) for k, p in model.named_parameters()}
        return losses, {k: v.numpy() for k, v in params.items()}, blocks, state.step, resident
    finally:
        torch.Tensor.backward = real_backward
        ctx.shutdown()


@pytest.mark.parametrize("chunks", [None, 3], ids=["unfused", "fused-ce"])
def test_three_steps_match_reference(chunks):
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init, want_losses, want_params = _reference(chunks)
    extra = ("--fused-ce-chunks", str(chunks)) if chunks else ()
    ranks = spawn(_train_rank, WORLD, (extra, flax_to_state_dict(init)), timeout_s=300)
    want = flax_to_state_dict(want_params)
    for losses, params, blocks, steps, resident in ranks:
        assert steps == STEPS
        # Leaves were gathered in the forward, and none is resident at its
        # end: the backward gathers again what it needs.
        assert len(resident) == STEPS and all(alive == 0 < n for alive, n in resident)
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(params[name], w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
            # Each rank holds its block: the leaf's largest W-divisible dim halved.
            dim = fsdp_pl_spec_for(WORLD)(name, tuple(w.shape))
            shape = list(w.shape)
            if dim is not None:
                shape[dim] //= WORLD
            assert blocks[name] == tuple(shape), name
    for name, p in ranks[0][1].items():
        assert np.array_equal(ranks[1][1][name].view(np.uint32), p.view(np.uint32))


def _resume_rank(rank, world, init_method, ckpt_dir):
    """An uninterrupted run of 2 + 2 steps over the stream's first two
    batches twice (what a resumed process sees), then cli.lm's run with
    --ckpt-dir for 2 steps and with --resume for 2 more."""
    from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
        gather_fsdp_pl_params,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        flags = ("--rank", str(rank), "--max-iters", "2", "--ckpt-dir", ckpt_dir)
        args = _args(*flags)
        step, state, place, _ = cli_lm.build(args, ctx)
        for _ in range(2):
            state, _ = train_epoch(step, state, cli_lm.synthetic_batches(args),
                                   place_batch=place, max_iters=2)
        want = step.params_fn(state)
        cli_lm.run(args, ctx)
        resumed = cli_lm.run(_args(*flags, "--resume"), ctx)
        got = gather_fsdp_pl_params(resumed, ctx.comm)
        return ({k: v.numpy() for k, v in want.items()}, {k: v.numpy() for k, v in got.items()},
                resumed.step)
    finally:
        ctx.shutdown()


def test_save_resume_is_bit_for_bit(tmp_path):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    ranks = spawn(_resume_rank, WORLD, (str(tmp_path / "ck"),), timeout_s=300)
    for want, got, steps in ranks:
        assert steps == 4
        for k, v in want.items():
            assert np.array_equal(got[k].view(np.uint32), v.view(np.uint32)), k
    # The files are a dp run's: every leaf whole.
    restored = ck.restore_checkpoint(ck.latest_checkpoint(tmp_path / "ck"))
    assert restored.step == 4 and ck.checkpoint_shard_spec(
        ck.latest_checkpoint(tmp_path / "ck")) is None
    for k, v in ranks[0][0].items():
        assert tuple(restored.params[k].shape) == v.shape


def test_refusals_read_as_the_reference():
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer import (
        make_fsdp_pl_lm_train_step,
        shard_fsdp_pl_state,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    for attn in ("ring", "ulysses"):
        model = TransformerLM(**MODEL, attn_impl=attn, device="cpu")
        with pytest.raises(ValueError, match="per-layer FSDP supports dense/flash/auto "
                                             "attention \\(sequence-sharded ring/ulysses "
                                             "need a second mesh axis\\)"):
            make_fsdp_pl_lm_train_step(model, Comm())

    class LARSConfig:  # the reference's optimizer the flat and per-layer schemes refuse
        pass

    state = TrainState(model=TransformerLM(**MODEL, device="cpu"), momentum={}, step=0,
                       config=LARSConfig())
    with pytest.raises(ValueError, match="per-layer FSDP cannot shard LARS"):
        shard_fsdp_pl_state(state, Comm())
    for flags, match in (
            (["--num-nodes", "2", "--batch-size", "3"],
             "--batch-size 3 must be divisible by the 2-device data axis"),
            (["--overlap-update"], "--overlap-update applies to --parallel fsdp"),
            (["--guard-nonfinite"], "--guard-nonfinite/--loss-scale apply to the "
                                    "replicated dp/ring/ulysses steps only \\(got "
                                    "--parallel fsdp_pl\\)")):
        with pytest.raises(ValueError, match=match):
            cli_lm.main([*FLAGS, "--parallel", "fsdp_pl", *flags])
    args = _args("--attn", "flash")
    assert cli_lm.attn_impl(args) == "flash"  # honoured, unlike flat fsdp
