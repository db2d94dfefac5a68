"""ZeRO-1 (parallel/zero1.py) vs the JAX package, and its flat checkpoint.

VGGTEST (the JAX package's narrow test net), augmentation off, a global
batch of 16 (8 a rank), 2 steps: the reference initializes the weights
(``init_model_and_state``), shards them over a (2,) mesh
(``shard_zero1_state``) and trains with ``make_zero1_train_step``; the port
loads the converted weights in 2 gloo ranks and trains with its own.  Two
cases: SGD with BatchNorm (the parts' optimizer and model), and AdamW with
the fused update (K7's plain version on the CPU) without BatchNorm.
Tolerances are ``tests/test_zero1.py``'s: the loss within 1e-5 relative,
parameters and the reassembled momentum within rtol 1e-4 / atol 1e-6,
BatchNorm statistics within rtol 1e-5 / atol 1e-7.  The overlap build
(``overlap=True``) must be bit for bit the sync build; each rank's
momentum bytes and ``zero1_memory_footprint`` equal the reference's
accounting.  VGGTEST has 8,522 parameters (8,794 with BatchNorm), so rank
1's slice of the replicated vector starts off a 16-byte boundary at W 2
(4,261 f32): every operand the fused update receives must be contiguous
and 16-byte aligned all the same.  Each rank then saves its final state
under ``ShardSpec("zero1", 2, n)`` (gathered, rank 0 writes); the
restore at world 1 holds the ranks' parameters and momentum bit for bit.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch import convert

WORLD, BATCH, STEPS = 2, 16, 2
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
STATS_RTOL, STATS_ATOL = 1e-5, 1e-7
CASES = {"sgd-bn": ("sgd", True), "adamw-fused": ("adamw", False)}


def _data():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    return x, y


@functools.lru_cache(maxsize=None)
def _reference(opt: str, use_bn: bool):
    """The JAX ZeRO-1 run: (initial variables, losses, final params tree,
    final batch stats, the momentum reassembled (a tree, or mu/nu trees),
    footprint at W 2, n_elems)."""
    import jax

    from distributed_machine_learning_tpu.cli.common import init_model_and_state
    from distributed_machine_learning_tpu.models.vgg import VGGTest
    from distributed_machine_learning_tpu.parallel.zero1 import (
        make_zero1_train_step,
        shard_zero1_state,
        zero1_memory_footprint,
        zero1_params,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.step import shard_batch

    model = VGGTest(use_bn=use_bn)
    mesh = make_mesh(WORLD)
    state = init_model_and_state(model, config=AdamWConfig() if opt == "adamw" else None)
    init = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    z1, unravel, n = shard_zero1_state(state, mesh)
    step = make_zero1_train_step(model, mesh, unravel, n, augment=False)
    mx, my = shard_batch(mesh, *_data())
    losses = []
    for _ in range(STEPS):
        z1, loss = step(z1, mx, my)
        losses.append(float(loss))
    mom = jax.tree_util.tree_map(lambda a: unravel(np.asarray(a)[:n]), z1.momentum_shards)
    return (init, losses, jax.device_get(zero1_params(z1, unravel, n)),
            jax.device_get(z1.batch_stats), jax.device_get(mom),
            zero1_memory_footprint(n, WORLD), n)


def _port_state(init, opt, use_bn):
    from distributed_machine_learning_tpu_torch.models.vgg import VGG
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = VGG("VGGTEST", use_bn=use_bn)
    model.load_state_dict(convert.flax_vgg_to_state_dict(init["params"], init["batch_stats"]))
    config = AdamWConfig(fused=True) if opt == "adamw" else SGDConfig()
    return model, TrainState.create(model, config)


def _rank(rank, world, init_method, init, opt, use_bn, ckpt_dir):
    from distributed_machine_learning_tpu_torch.parallel.fsdp import Unravel
    from distributed_machine_learning_tpu_torch.parallel.zero1 import (
        make_zero1_train_step,
        shard_zero1_state,
        zero1_memory_footprint,
        zero1_params,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.runtime.mesh import ShardSpec
    from distributed_machine_learning_tpu_torch.train import adamw as adamw_mod
    from distributed_machine_learning_tpu_torch.train.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    aligned = []
    real = adamw_mod.fused_adamw_leaf

    def checked(p, mu, nu, g, *a, **k):
        aligned.append(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (p, mu, nu, g)))
        return real(p, mu, nu, g, *a, **k)

    adamw_mod.fused_adamw_leaf = checked
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    comm = ctx.comm
    x, y = _data()
    lo, hi = rank * BATCH // world, (rank + 1) * BATCH // world
    x, y = torch.from_numpy(x[lo:hi]), torch.from_numpy(y[lo:hi]).long()
    out = {}
    try:
        for overlap in (False, True):
            model, state = _port_state(init, opt, use_bn)
            z1, unravel, n = shard_zero1_state(state, comm)
            step = make_zero1_train_step(model, comm, unravel, n, augment=False,
                                         overlap=overlap)
            losses = [float(step(z1, x, y)[1]) for _ in range(STEPS)]
            if overlap:
                step.join(z1)
                step.close()
            mom = z1.momentum_shards
            moms = mom if isinstance(mom, dict) else {"buf": mom}
            whole = {k: Unravel(model)(comm.all_gather_flat(v)[:n]) for k, v in moms.items()}
            out["overlap" if overlap else "sync"] = {
                "losses": losses, "n": n,
                "params": {k: v.numpy() for k, v in zero1_params(z1, unravel, n).items()},
                "stats": {k: v.numpy().copy() for k, v in z1.batch_stats.items()},
                "momentum": {k: {name: t.numpy() for name, t in v.items()}
                             for k, v in whole.items()},
                "moment_bytes": sum(t.numel() * t.element_size() for t in moms.values()),
                "flat_bytes": z1.param_flat.numel() * 4,
                "footprint": zero1_memory_footprint(n, world)}
            if overlap:
                save_checkpoint(ckpt_dir, z1, shard_spec=ShardSpec("zero1", world, n_elems=n),
                                comm=comm)
        out["aligned"] = aligned
        return out
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_steps_match_reference(tmp_path, case):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck

    opt, use_bn = CASES[case]
    init, want_losses, want_params, want_stats, want_mom, want_fp, n = _reference(opt, use_bn)
    assert (n // WORLD) % 4 != 0  # rank 1's slice is misaligned: the case K7 refuses
    ranks = spawn(_rank, WORLD, (init, opt, use_bn, str(tmp_path / "ck")), timeout_s=300)
    tree = convert.flax_vgg_tree
    for out in ranks:
        sync, over = out["sync"], out["overlap"]
        np.testing.assert_allclose(sync["losses"], want_losses, rtol=LOSS_RTOL)
        got = tree({k: torch.from_numpy(v) for k, v in sync["params"].items()})
        for mod, leaves in want_params.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(got[mod][leaf], np.asarray(w), rtol=PARAM_RTOL,
                                           atol=PARAM_ATOL, err_msg=f"{mod}/{leaf}")
        moms = ({"buf": want_mom} if opt == "sgd" else want_mom)
        for key, w_tree in moms.items():
            got_m = tree({k: torch.from_numpy(v) for k, v in sync["momentum"][key].items()})
            for mod, leaves in w_tree.items():
                for leaf, w in leaves.items():
                    np.testing.assert_allclose(got_m[mod][leaf], np.asarray(w),
                                               rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                               err_msg=f"{key} {mod}/{leaf}")
        if use_bn:
            for name, v in sync["stats"].items():
                _, i, stat = name.split(".")
                w = want_stats[f"BatchNorm_{i}"]["mean" if stat == "running_mean" else "var"]
                np.testing.assert_allclose(v, np.asarray(w), rtol=STATS_RTOL, atol=STATS_ATOL)
        assert over["losses"] == sync["losses"]
        for part in ("params", "stats"):
            for k, v in sync[part].items():
                assert np.array_equal(over[part][k].view(np.uint32), v.view(np.uint32)), k
        assert sync["footprint"] == want_fp
        n_moments = 1 if opt == "sgd" else 2
        assert sync["flat_bytes"] + sync["moment_bytes"] // n_moments == want_fp["zero1"]
        assert sync["moment_bytes"] == n_moments * want_fp["fsdp"] // 2
        if opt == "adamw":
            assert out["aligned"] and all(out["aligned"])
    for k, v in ranks[0]["sync"]["params"].items():
        assert np.array_equal(ranks[1]["sync"]["params"][k], v)
    restored, spec = ck.reshard_restore(ck.latest_checkpoint(tmp_path / "ck"), world=1)
    assert spec.layout == "zero1" and restored.step == STEPS
    flat = np.concatenate([v.reshape(-1) for v in ranks[0]["overlap"]["params"].values()])
    assert np.array_equal(restored.param_flat[:n].numpy(), flat)
