"""``cli.lm --parallel fsdp`` (parallel/fsdp.py, parallel/overlap.py) vs the
JAX package.

A d64 / 2-layer / 4-head / 2-KV-head / vocab-97 model, B 4 × L 64, f32:
the reference initializes it (seed 69143), shards it over a (2,) mesh
(``shard_fsdp_state``) and trains 3 steps with ``make_fsdp_lm_train_step``
(with and without ``fused_ce_chunks``); the port runs ``cli.lm``'s
``build`` in 2 gloo ranks with the reference's initial weights written
into its shards (the port's flat order) and the same numpy batches.  The
gathered parameter trees are compared, never the flat vectors (the
reference ravels in sorted-key order).  Tolerances are
``tests/test_torch_lm_train.py``'s: losses within 1e-5 relative,
parameters within 2e-5 after 3 AdamW steps.  Each rank then runs the same
3 steps with ``--overlap-update`` through ``train_epoch``: its parameters
must be bit for bit the sync run's, and the loop must report the
gathers' seconds.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm

MODEL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD = 4, 64, 3, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


def _args(*extra):
    return cli_lm.make_parser().parse_args([
        "--device", "cpu", "--parallel", "fsdp", "--num-nodes", str(WORLD),
        "--d-model", "64", "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
        "--vocab", "97", "--seq-len", str(SEQ), "--batch-size", str(BATCH), *extra])


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


@functools.lru_cache(maxsize=None)
def _reference(chunks):
    """The JAX ZeRO-3 trajectory: (initial params, losses, gathered final
    params, its memory footprint at W 2)."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel.fsdp import (
        fsdp_memory_footprint,
        gather_fsdp_params,
        make_fsdp_lm_train_step,
        shard_fsdp_state,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    model = RefLM(**MODEL)
    state = init_lm_state(model, seed=69143, config=AdamWConfig())
    init = jax.device_get(state.params)
    mesh = make_mesh(WORLD)
    fstate, unravel, n_elems = shard_fsdp_state(state, mesh)
    step = make_fsdp_lm_train_step(model, mesh, unravel, n_elems, fused_ce_chunks=chunks)
    sharding = NamedSharding(mesh, P("batch"))
    losses = []
    for x, y in _batches():
        fstate, loss = step(fstate, jax.device_put(x, sharding), jax.device_put(y, sharding))
        losses.append(float(loss))
    final = jax.device_get(gather_fsdp_params(fstate, unravel, n_elems))
    return init, losses, final, fsdp_memory_footprint(n_elems, WORLD)


def _load(state, model, weights, comm):
    """The reference's weights into this rank's shard, in the port's flat
    order (``named_parameters()``, each tensor row-major, zero-padded)."""
    flat = torch.cat([weights[name].reshape(-1) for name, _ in model.named_parameters()])
    shard = state.param_shard
    flat = torch.nn.functional.pad(flat, (0, shard.numel() * comm.world - flat.numel()))
    shard.copy_(flat.view(comm.world, -1)[comm.rank])


def _train_rank(rank, world, init_method, extra, weights):
    from distributed_machine_learning_tpu_torch.parallel.fsdp import fsdp_memory_footprint
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        out = {}
        for mode in ("sync", "overlap"):
            flags = ("--rank", str(rank), *extra) + (("--overlap-update",)
                                                    if mode == "overlap" else ())
            step, state, place, model = cli_lm.build(_args(*flags), ctx)
            assert model.attn_impl == "dense"
            _load(state, model, weights, ctx.comm)
            if mode == "sync":
                losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
                gathers = []
            else:
                losses = []

                def run(s, x, y, step=step):
                    s, loss = step(s, x, y)
                    losses.append(float(loss))
                    return s, loss

                run.pop_gather_seconds = step.pop_gather_seconds
                state, timer = train_epoch(run, state, _batches(), place_batch=place,
                                           max_iters=STEPS)
                gathers = timer.param_gather_s
            params = step.params_fn(state)
            if mode == "overlap":
                step.close()
            n = sum(p.numel() for p in params.values())
            moment_bytes = sum(t.numel() * t.element_size()
                               for t in state.momentum_shards.values())
            out[mode] = (losses, {k: v.numpy() for k, v in params.items()}, state.step,
                         gathers, moment_bytes, fsdp_memory_footprint(n, world))
        return out
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("chunks", [None, 3], ids=["unfused", "fused-ce"])
def test_three_steps_match_reference(chunks):
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init, want_losses, want_params, want_mem = _reference(chunks)
    extra = ("--fused-ce-chunks", str(chunks)) if chunks else ()
    ranks = spawn(_train_rank, WORLD, (extra, flax_to_state_dict(init)), timeout_s=300)
    want = flax_to_state_dict(want_params)
    for out in ranks:
        losses, params, steps, _, moment_bytes, mem = out["sync"]
        assert steps == STEPS and mem == want_mem
        assert moment_bytes == mem["fsdp"] and 2 * moment_bytes >= mem["replicated"]
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(params[name], w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
        o_losses, o_params, o_steps, gathers, _, _ = out["overlap"]
        assert o_steps == STEPS and o_losses == losses
        assert len(gathers) == STEPS - 1 and all(g > 0 for g in gathers)
        for name, p in params.items():
            assert np.array_equal(o_params[name].view(np.uint32), p.view(np.uint32)), \
                f"overlap {name} differs from the sync run"
    for name, p in ranks[0]["sync"][1].items():
        assert np.array_equal(ranks[1]["sync"][1][name].view(np.uint32), p.view(np.uint32))


def test_cli_refusals_read_as_the_reference():
    for flags, match in (
            (["--attn", "flash"], "FSDP LM step requires attn_impl='dense'"),
            (["--ckpt-dir", "x"], "--ckpt-dir does not support the flat-vector fsdp state"),
            (["--guard-nonfinite"], "--guard-nonfinite/--loss-scale apply to the "
                                    "replicated dp/ring/ulysses steps only \\(got "
                                    "--parallel fsdp\\)"),
            (["--num-nodes", "2", "--batch-size", "3"],
             "--batch-size 3 must be divisible by the 2-device data axis")):
        with pytest.raises(ValueError, match=match):
            cli_lm.main(["--device", "cpu", "--parallel", "fsdp", *flags])
    assert cli_lm.attn_impl(_args()) == "dense"  # auto resolves to dense
    with pytest.raises(NotImplementedError, match="ROADMAP A5b"):
        cli_lm.main(["--device", "cpu", "--parallel", "fsdp_pl"])
