"""Ulysses context parallelism (ops/ulysses.py, ``cli.lm --parallel ulysses``)
vs the JAX package.

Attention: gloo ranks (``runtime/launch.spawn``) at world 2 and 4 run the
port's ``ulysses_self_attention`` on their chunks of the same numpy inputs
(B 2 × L 64, head dim 16, f32), forward and the q/k/v gradients of
``sum(out * g)``; JAX runs its own under ``shard_map`` on as many virtual
devices.  The cases cover the GQA narrow path (Hkv divisible by W), the
wide path (Hkv 2 at W 4), MHA, the flash local attention (K1-K3's plain
versions against the Pallas kernels in interpret mode) and the ``H % W``
refusal.  Both sides compute the same f32 attention over the same full
sequence, so they agree to summation order: within 1e-5.

Training: 3 steps of ``cli.lm --parallel ulysses`` at world 2 (``build`` in
gloo ranks, the reference's converted weights) against JAX
``make_lm_train_step`` on a (batch, seq) mesh of (1, 2), with and without
``--remat --remat-policy block``, at ``tests/test_torch_lm_ring.py``'s model
and tolerances (losses 1e-5 relative, parameters 2e-5 absolute); every
rank ends with bit-for-bit the same parameters.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm

B, L, D = 2, 64, 16
ATTN_TOL = 1e-5
# (H, Hkv, local attention): at W 2 every GQA case takes the narrow path;
# at W 4 Hkv 2 takes the wide one.
CASES = [(4, 2, "dense"), (8, 4, "dense"), (4, 4, "dense"), (4, 2, "flash")]

MODEL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD = 2, 128, 3, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
REMAT = ("--remat", "--remat-policy", "block")


def _inputs(H, Hkv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, n, D)).astype(np.float32) for n in (H, Hkv, Hkv, H)]


def _attention_rank(rank, world, init_method):
    from distributed_machine_learning_tpu_torch.ops.ulysses import ulysses_self_attention
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        Lc = L // world
        outs = {}
        for i, (H, Hkv, local) in enumerate(CASES):
            chunks = [torch.from_numpy(x[:, rank * Lc:(rank + 1) * Lc].copy())
                      for x in _inputs(H, Hkv, i)]
            q, k, v = (x.clone().requires_grad_() for x in chunks[:3])
            out = ulysses_self_attention(q, k, v, ctx.comm, local_attn=local)
            grads = torch.autograd.grad(out, (q, k, v), chunks[3])
            outs[i] = [out.detach().numpy(), *(g.numpy() for g in grads)]
        q = torch.zeros(1, Lc, 6, D)
        try:
            ulysses_self_attention(q, q, q, ctx.comm)
            outs["refusal"] = None
        except ValueError as exc:
            outs["refusal"] = str(exc)
        return outs
    finally:
        ctx.shutdown()


def _jax_ulysses(world, case):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_machine_learning_tpu.ops.ulysses import ulysses_self_attention
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh, shard_map_no_check

    H, Hkv, local = CASES[case]
    q, k, v, g = (jnp.asarray(x) for x in _inputs(H, Hkv, case))
    spec = P(None, "seq")
    fn = jax.jit(shard_map_no_check(
        lambda a, b, c: ulysses_self_attention(a, b, c, "seq", world, local_attn=local),
        mesh=make_mesh(world, ("seq",)), in_specs=(spec,) * 3, out_specs=spec))
    out, vjp = jax.vjp(fn, q, k, v)
    return [np.asarray(x) for x in (out, *vjp(g))]


@pytest.mark.parametrize("world", [2, 4])
def test_attention_matches_reference(world):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    per_rank = spawn(_attention_rank, world, timeout_s=240)
    for case in range(len(CASES)):
        want = _jax_ulysses(world, case)
        for i, what in enumerate(("out", "dq", "dk", "dv")):
            got = np.concatenate([r[case][i] for r in per_rank], axis=1)
            np.testing.assert_allclose(got, want[i], rtol=ATTN_TOL, atol=ATTN_TOL,
                                       err_msg=f"{CASES[case]} at W {world}: {what}")
    for r in per_rank:
        if world == 4:
            assert "6 heads over 4 devices" in r["refusal"]
        else:
            assert r["refusal"] is None


def _args(*extra):
    return cli_lm.make_parser().parse_args([
        "--device", "cpu", "--parallel", "ulysses", "--num-nodes", str(WORLD),
        "--d-model", "64", "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
        "--vocab", "97", "--seq-len", str(SEQ), "--batch-size", str(BATCH), *extra])


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


@functools.lru_cache(maxsize=None)
def _reference(remat: bool):
    """The JAX trajectory on a (1, 2) mesh: (initial params, losses, final
    params)."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import (
        init_lm_state,
        make_lm_train_step,
        shard_lm_batch,
    )

    model = RefLM(**MODEL, attn_impl="ulysses", remat=remat,
                  remat_policy="block" if remat else "mlp")
    state = init_lm_state(model, seed=69143, config=AdamWConfig())
    init = jax.device_get(state.params)
    mesh = make_mesh(WORLD, ("batch", "seq"), (1, WORLD))
    step = make_lm_train_step(model, mesh=mesh)
    losses = []
    for x, y in _batches():
        state, loss = step(state, *shard_lm_batch(mesh, x, y))
        losses.append(float(loss))
    return init, losses, jax.device_get(state.params)


def _train_rank(rank, world, init_method, extra, weights):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    args = _args("--rank", str(rank), *extra)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        step, state, place, model = cli_lm.build(args, ctx)
        assert model.attn_impl == "ulysses"
        model.load_state_dict(weights)
        losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
        return losses, {k: v.numpy() for k, v in model.state_dict().items()}, state.step
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat-block"])
def test_three_steps_match_reference(remat):
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init, want_losses, want_params = _reference(remat)
    ranks = spawn(_train_rank, WORLD, (REMAT if remat else (), flax_to_state_dict(init)),
                  timeout_s=300)
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


def test_cli_rules():
    """ulysses owns its attention (--attn does not apply), shards the
    sequence, and takes the fused loss and the guard as dp and ring do."""
    assert cli_lm.attn_impl(_args("--attn", "flash")) == "ulysses"
    with pytest.raises(ValueError, match="--seq-len 129 must be divisible by the 2-device "
                                         "sequence axis \\(ulysses shards the sequence\\)"):
        cli_lm.main(["--device", "cpu", "--parallel", "ulysses", "--num-nodes", "2",
                     "--seq-len", "129"])
    with pytest.raises(ValueError, match="--overlap-update applies to --parallel fsdp"):
        cli_lm.main(["--device", "cpu", "--parallel", "ulysses", "--overlap-update"])
