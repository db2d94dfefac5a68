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
gathers' seconds.  The CNN step (``make_fsdp_train_step``: VGGTEST with
BatchNorm, SGD, augmentation off) against the reference's at W 2, its
overlap run, a prefetch miss after a rebound state and one after a save
and a restore of the rank's blocks each bit for bit the sync run.  The
CLI's refusals; ``--parallel fsdp_pl`` runs (``tests/test_torch_fsdp_pl.py``
holds it against the reference) and so does expert parallelism
(``tests/test_torch_ep.py`` holds it).
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch import convert
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


def test_cli_refusals_read_as_the_reference(capsys):
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
    # fsdp_pl runs (a one-rank run here; tests/test_torch_fsdp_pl.py holds it
    # at W 2 against the reference); tp, pp and 3d run (their own test files);
    # so does expert parallelism (tests/test_torch_ep.py).
    for parallel in ("fsdp_pl", "ep"):
        cli_lm.main(["--device", "cpu", "--parallel", parallel, "--d-model", "32",
                     "--n-layers", "1", "--n-heads", "2", "--seq-len", "16",
                     "--batch-size", "2", "--max-iters", "1"])
        assert f"lm parallel={parallel}" in capsys.readouterr().out


# -- the CNN step (make_fsdp_train_step), against tests/test_fsdp.py --------------------
CNN_BATCH, CNN_STEPS = 16, 3
CNN_RTOL, CNN_ATOL = 1e-4, 1e-6


def _cnn_data():
    rng = np.random.default_rng(11)
    return (rng.integers(0, 256, (CNN_BATCH, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 10, CNN_BATCH).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _cnn_reference():
    """The JAX ZeRO-3 CNN run (VGGTEST with BatchNorm, SGD, augmentation
    off): (initial variables, losses, gathered final params, final stats)."""
    import jax

    from distributed_machine_learning_tpu.cli.common import init_model_and_state
    from distributed_machine_learning_tpu.models.vgg import VGGTest
    from distributed_machine_learning_tpu.parallel.fsdp import (
        gather_fsdp_params,
        make_fsdp_train_step,
        shard_fsdp_state,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.step import shard_batch

    model = VGGTest(use_bn=True)
    mesh = make_mesh(WORLD)
    state = init_model_and_state(model)
    init = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    fstate, unravel, n = shard_fsdp_state(state, mesh)
    step = make_fsdp_train_step(model, mesh, unravel, n, augment=False)
    mx, my = shard_batch(mesh, *_cnn_data())
    losses = []
    for _ in range(CNN_STEPS):
        fstate, loss = step(fstate, mx, my)
        losses.append(float(loss))
    return (init, losses, jax.device_get(gather_fsdp_params(fstate, unravel, n)),
            jax.device_get(fstate.batch_stats))


def _cnn_rank(rank, world, init_method, init, ckpt_dir):
    """Sync 3 steps; overlap 3 steps; overlap 2 steps, a rebound state
    (new tensors, the same values), 1 step; overlap 2 steps, a save and a
    restore of this rank's blocks, 1 step."""
    from distributed_machine_learning_tpu_torch.models.vgg import VGG
    from distributed_machine_learning_tpu_torch.parallel.fsdp import (
        FSDPState,
        gather_fsdp_params,
        make_fsdp_train_step,
        shard_fsdp_state,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    comm = ctx.comm
    x, y = _cnn_data()
    lo, hi = rank * CNN_BATCH // world, (rank + 1) * CNN_BATCH // world
    x, y = torch.from_numpy(x[lo:hi]), torch.from_numpy(y[lo:hi]).long()
    out = {}
    try:
        for mode in ("sync", "overlap", "rebind", "restore"):
            model = VGG("VGGTEST", use_bn=True)
            model.load_state_dict(convert.flax_vgg_to_state_dict(init["params"],
                                                                 init["batch_stats"]))
            fstate, unravel, n = shard_fsdp_state(TrainState.create(model, SGDConfig()), comm)
            step = make_fsdp_train_step(model, comm, unravel, n, augment=False,
                                        overlap=mode != "sync")
            losses = []
            for i in range(CNN_STEPS):
                if i == CNN_STEPS - 1 and mode == "rebind":
                    fstate = FSDPState(fstate.param_shard.clone(),
                                       fstate.momentum_shards.clone(), fstate.step,
                                       fstate.config, dict(fstate.batch_stats))
                if i == CNN_STEPS - 1 and mode == "restore":
                    spec = ShardSpec("fsdp", world, n)
                    try:  # refused: no collective while a gather is in flight
                        ck.save_checkpoint(ckpt_dir, fstate, shard_spec=spec, comm=comm)
                    except ValueError as exc:
                        out["in_flight"] = str(exc)
                    step.join(fstate)
                    ck.save_checkpoint(ckpt_dir, fstate, shard_spec=spec, comm=comm)
                    fstate, _ = ck.reshard_restore(ck.latest_checkpoint(ckpt_dir), world=world,
                                                   rank=comm.rank)
                losses.append(float(step(fstate, x, y)[1]))
            full = step.join(fstate) if mode != "sync" else None
            params = gather_fsdp_params(fstate, unravel, n, comm, full=full)
            if mode != "sync":
                step.close()
            out[mode] = {"losses": losses, "shard": fstate.param_shard.numpy(),
                         "params": {k: v.numpy() for k, v in params.items()},
                         "stats": {k: v.numpy().copy() for k, v in fstate.batch_stats.items()}}
        return out
    finally:
        ctx.shutdown()


def test_cnn_step_matches_reference(tmp_path):
    """``make_fsdp_train_step`` at W 2 against the reference's: losses within
    1e-5 relative, parameters within rtol 1e-4 / atol 1e-6 after 3 steps,
    BatchNorm statistics within rtol 1e-5 / atol 1e-7 (``tests/test_zero1.py``'s
    tolerances); the overlap run, a prefetch miss after a rebound state and
    one after a save and a restore of the rank's blocks all bit for bit the
    sync run; a save while the overlap gather is in flight refused."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init, want_losses, want_params, want_stats = _cnn_reference()
    ranks = spawn(_cnn_rank, WORLD, (init, str(tmp_path / "ck")), timeout_s=300)
    for out in ranks:
        sync = out["sync"]
        np.testing.assert_allclose(sync["losses"], want_losses, rtol=LOSS_RTOL)
        got = convert.flax_vgg_tree({k: torch.from_numpy(v) for k, v in sync["params"].items()})
        for mod, leaves in want_params.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got[mod][leaf], np.asarray(w), rtol=CNN_RTOL,
                                           atol=CNN_ATOL, err_msg=f"{mod}/{leaf}")
        for name, v in sync["stats"].items():
            _, i, stat = name.split(".")
            w = want_stats[f"BatchNorm_{i}"]["mean" if stat == "running_mean" else "var"]
            np.testing.assert_allclose(v, np.asarray(w), rtol=1e-5, atol=1e-7)
        for mode in ("overlap", "rebind", "restore"):
            assert out[mode]["losses"] == sync["losses"], mode
            assert np.array_equal(out[mode]["shard"].view(np.uint32),
                                  sync["shard"].view(np.uint32)), mode
            for k, v in sync["stats"].items():
                assert np.array_equal(out[mode]["stats"][k], v), (mode, k)
        assert "gather of this fsdp state is in flight" in out.get("in_flight", "")
    for k, v in ranks[0]["sync"]["params"].items():
        assert np.array_equal(ranks[1]["sync"]["params"][k], v)
