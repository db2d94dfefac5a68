"""The port's ring attention (ops/ring_flash_attention.py, ops/ring_attention.py)
vs the JAX package.

Chunk steps: the plain versions of K11-K13 against JAX's ``_chunk_fwd`` /
``_chunk_dq`` / ``_chunk_dkv`` in Pallas interpret mode on the same numpy
inputs (f32, a non-trivial carry and accumulators in), at chunk lengths on
and off the kernels' 128-row grid (96: both sides tile it in 32-row blocks).  Both run the same
tile arithmetic on the same blocks, so they agree to summation order:
within 1e-5 of each tensor's largest magnitude (at least 1; the
accumulators reach ~20, and a sum of 128 such terms moves by ~1e-5 in
another order).  Rings: gloo ranks (``runtime/launch.spawn``) run the port's
``ring_flash_self_attention`` and ``ring_self_attention``, forward and the
three gradients; at world 2 against JAX's rings under ``shard_map`` on 2
virtual devices (the tolerances of ``tests/test_ring_flash.py``), at
world 4 against the port's dense attention.
"""

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

D = 16
CHUNK_TOL = 1e-5
FWD_RTOL, FWD_ATOL = 2e-5, 2e-6  # tests/test_ring_flash.py's forward tolerances
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5  # and its gradient tolerances


def _check(got, want, name):
    err = float(np.abs(got - want).max())
    assert err <= CHUNK_TOL * max(1.0, float(np.abs(want).max())), (name, err)


def _fold(x):  # [B, L, H, D] → [B·H, L, D], the JAX kernels' layout
    B, L, H, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, L, d)


def _unfold(x, B):
    BH, L, d = x.shape
    return np.asarray(x).reshape(B, BH // B, L, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("Lc", [32, 96, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["diagonal", "full"])
def test_chunk_steps_match_pallas(causal, H, Hkv, Lc):
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.ops.pallas import ring_flash_attention as jrf

    B, g = 2, H // Hkv
    rng = np.random.default_rng(Lc + H * Hkv + causal)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, do, acc, dq = f(B, Lc, H, D), f(B, Lc, H, D), f(B, Lc, H, D), f(B, Lc, H, D)
    k, v, dk, dv = f(B, Lc, Hkv, D), f(B, Lc, Hkv, D), f(B, Lc, Hkv, D), f(B, Lc, Hkv, D)
    m, l = f(B, H, Lc), rng.uniform(0.5, 2.0, (B, H, Lc)).astype(np.float32)
    lse, delta = 2.0 + 0.5 * f(B, H, Lc), f(B, H, Lc)
    t = torch.from_numpy
    rows = lambda x: jnp.asarray(x.reshape(B * H, 1, Lc))  # noqa: E731
    jq, jk, jv, jdo = (jnp.asarray(_fold(x)) for x in (q, k, v, do))

    jm, jl, jacc = jrf._chunk_fwd(jq, jk, jv, (rows(m), rows(l), jnp.asarray(_fold(acc))),
                                  causal=causal, kv_groups=g)
    got = rf.chunk_fwd_reference(t(q), t(k), t(v), t(m), t(l), t(acc), causal)
    for name, a, want in (("m", got[0], np.asarray(jm).reshape(B, H, Lc)),
                          ("l", got[1], np.asarray(jl).reshape(B, H, Lc)),
                          ("acc", got[2], _unfold(jacc, B))):
        _check(a.numpy(), want, name)

    jdq = jrf._chunk_dq(jq, jk, jv, jdo, rows(lse), rows(delta), jnp.asarray(_fold(dq)),
                        causal=causal, kv_groups=g)
    got = rf.chunk_dq_reference(t(q), t(k), t(v), t(do), t(lse), t(delta), t(dq), causal)
    _check(got.numpy(), _unfold(jdq, B), "dq")

    # The reference's step_dkv: in place under MHA; per-query-head zero
    # buffers group-summed into the traveling grads under GQA.
    jdk, jdv = jnp.asarray(_fold(dk)), jnp.asarray(_fold(dv))
    if g == 1:
        jdk, jdv = jrf._chunk_dkv(jq, jk, jv, jdo, rows(lse), rows(delta), jdk, jdv,
                                  causal=causal)
    else:
        z = jnp.zeros(jq.shape, jnp.float32)
        dk_q, dv_q = jrf._chunk_dkv(jq, jk, jv, jdo, rows(lse), rows(delta), z, z,
                                    causal=causal, kv_groups=g)
        jdk, jdv = jdk + jrf._group_sum(dk_q, B, H, g), jdv + jrf._group_sum(dv_q, B, H, g)
    got = rf.chunk_dkv_reference(t(q), t(k), t(v), t(do), t(lse), t(delta), t(dk), t(dv),
                                 causal)
    for name, a, want in zip(("dk", "dv"), got, (jdk, jdv)):
        _check(a.numpy(), _unfold(want, B), name)


B, L = 2, 64
CASES = [(2, 2), (4, 2)]  # (H, Hkv): MHA and GQA


def _inputs(H, Hkv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, n, D)).astype(np.float32) for n in (H, Hkv, Hkv, H)]


def _ring_rank(rank, world, init_method):
    """Every case through both rings on this rank's chunk: the output and
    the gradients of sum(out * g); and the chunk steps the flash ring ran."""
    from distributed_machine_learning_tpu_torch.ops.ring_attention import (
        ring_self_attention,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    kinds = []
    step = rf._chunk_fwd

    def counted(*a, causal):
        kinds.append(causal)
        step(*a, causal=causal)

    rf._chunk_fwd = counted
    try:
        Lc = L // world
        outs = {}
        for H, Hkv in CASES:
            chunks = [torch.from_numpy(x[:, rank * Lc:(rank + 1) * Lc].copy())
                      for x in _inputs(H, Hkv, H)]
            for name, fn in (("ring_flash", rf.ring_flash_self_attention),
                             ("ring", ring_self_attention)):
                q, k, v = (x.clone().requires_grad_() for x in chunks[:3])
                out = fn(q, k, v, ctx.comm)
                grads = torch.autograd.grad(out, (q, k, v), chunks[3])
                outs[name, H, Hkv] = [out.detach().numpy(), *(x.numpy() for x in grads)]
        return outs, kinds
    finally:
        ctx.shutdown()


def _gathered(per_rank, key):
    """The ranks' chunks of (out, dq, dk, dv), concatenated along L."""
    return [np.concatenate([r[0][key][i] for r in per_rank], axis=1) for i in range(4)]


def _jax_rings(H, Hkv):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_machine_learning_tpu.ops.pallas.ring_flash_attention import (
        ring_flash_self_attention,
    )
    from distributed_machine_learning_tpu.ops.ring_attention import ring_self_attention
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh, shard_map_no_check

    q, k, v, g = (jnp.asarray(x) for x in _inputs(H, Hkv, H))
    spec = P(None, "seq")
    want = {}
    for name, fn in (("ring_flash", ring_flash_self_attention), ("ring", ring_self_attention)):
        ring = jax.jit(shard_map_no_check(lambda a, b, c, fn=fn: fn(a, b, c, "seq", 2),
                                          mesh=make_mesh(2, ("seq",)),
                                          in_specs=(spec,) * 3, out_specs=spec))
        out, vjp = jax.vjp(ring, q, k, v)
        want[name] = [np.asarray(x) for x in (out, *vjp(g))]
    return want


def _dense(H, Hkv):
    """The port's dense attention over the whole sequence, with autograd."""
    from distributed_machine_learning_tpu_torch.ops.ring_attention import dense_self_attention

    q, k, v, g = (torch.from_numpy(x) for x in _inputs(H, Hkv, H))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    rep = H // Hkv
    out = dense_self_attention(q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2))
    return [out.detach().numpy(), *(x.numpy() for x in torch.autograd.grad(out, (q, k, v), g))]


@pytest.mark.parametrize("world", [2, 4])
def test_rings_match_reference(world):
    """World 2: both rings against JAX's on a 2-device mesh.  World 4: against
    dense attention (JAX's 4-shard interpret case is a slow test there).
    Rank r runs r + 1 forward chunk steps (its diagonal and r full ones) and
    skips the W − 1 − r later chunks, in each of the 2 cases."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    per_rank = spawn(_ring_rank, world, timeout_s=240)
    for H, Hkv in CASES:
        ref = _jax_rings(H, Hkv) if world == 2 else dict.fromkeys(("ring_flash", "ring"),
                                                                  _dense(H, Hkv))
        for name, want in ref.items():
            got = _gathered(per_rank, (name, H, Hkv))
            for i, what in enumerate(("out", "dq", "dk", "dv")):
                rtol, atol = (FWD_RTOL, FWD_ATOL) if i == 0 else (GRAD_RTOL, GRAD_ATOL)
                np.testing.assert_allclose(got[i], want[i], rtol=rtol, atol=atol,
                                           err_msg=f"{name} H={H} Hkv={Hkv} {what}")
    for r, (_, kinds) in enumerate(per_rank):
        assert kinds == [True] + [False] * r + [True] + [False] * r, (r, kinds)
