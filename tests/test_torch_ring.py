"""The port's ring all-reduce (one process per rank, gloo) against JAX's
ring on a mesh of virtual CPU devices.

Each world spawns its ranks once (``runtime/launch.spawn``) and runs every
case inside them; the parent runs JAX's ``ring_all_reduce_flat`` /
``ring_all_reduce`` under ``shard_map`` on the same per-rank f32 vectors.
The arithmetic is the reference's op for op (chunking, hop order, the
codecs, the relayed all-gather, the residual), so outputs and residuals
must agree BIT FOR BIT for every codec: none, bf16, int8 (both impls; the
kernels' plain versions on the CPU), topk; mean and sum; one bucket and
ragged buckets.  Every rank must end with identical bits.
"""

import numpy as np
import pytest
import torch

LENGTH = 1237  # ragged against every world and bucket
SMALL_BUCKET = 1000  # bytes: 250 elements, a 237-element tail bucket
# (codec, impl, mean, bucket_bytes or None for the 25 MiB default, residual)
CASES = [
    ("none", "xla", True, None, True),
    ("none", "xla", False, SMALL_BUCKET, False),
    ("bf16", "xla", True, SMALL_BUCKET, True),
    ("int8", "xla", True, None, True),
    ("int8", "pallas", True, SMALL_BUCKET, True),
    ("int8", "pallas", False, None, False),
    ("topk", "xla", True, None, True),
]
TOPK_FRAC = 0.2


def _ring_rank(rank, world, init_method, data, cases):
    """One rank: every case through the port's bucketed ring."""
    import torch.distributed as dist

    from distributed_machine_learning_tpu_torch.ops import ring
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        comm = ctx.comm
        x = torch.from_numpy(data[rank])
        outs = []
        for codec, impl, mean, bucket, residual in cases:
            scheme = ring.get_wire_scheme(codec, topk_frac=TOPK_FRAC, codec_impl=impl)
            got = ring.ring_all_reduce(x.clone(), comm, mean=mean,
                                       bucket_bytes=bucket or ring.DEFAULT_BUCKET_BYTES,
                                       scheme=scheme, return_residual=residual)
            outs.append(tuple(t.numpy() for t in got) if residual else (got.numpy(),))
        dist.barrier()
        return outs
    finally:
        ctx.shutdown()


def _jax_ring(world, data, codec, impl, mean, bucket, residual):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from distributed_machine_learning_tpu.ops import ring as jring
    from distributed_machine_learning_tpu.runtime.mesh import shard_map_no_check

    mesh = Mesh(np.array(jax.devices()[:world]), ("batch",))
    scheme = jring.get_wire_scheme(codec, topk_frac=TOPK_FRAC, codec_impl=impl)

    def per_dev(row):
        v = row[0]
        if bucket is None:
            out = jring.ring_all_reduce_flat(v, "batch", world, mean=mean, scheme=scheme,
                                             return_residual=residual)
        else:
            out = jring.ring_all_reduce(v, "batch", world, mean=mean, bucket_bytes=bucket,
                                        scheme=scheme, return_residual=residual)
        return tuple(o[None] for o in out) if residual else (out[None],)

    specs = (P("batch"),) * (2 if residual else 1)
    fn = jax.jit(shard_map_no_check(per_dev, mesh=mesh, in_specs=P("batch"),
                                    out_specs=specs))
    return [np.asarray(o) for o in fn(jnp.asarray(data))]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_bitwise_vs_jax(world):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    data = np.random.default_rng(world).standard_normal((world, LENGTH)).astype(np.float32)
    per_rank = spawn(_ring_rank, world, (data, CASES), timeout_s=240)
    for i, case in enumerate(CASES):
        want = _jax_ring(world, data, *case)
        for r in range(world):
            for k, got in enumerate(per_rank[r][i]):
                np.testing.assert_array_equal(
                    _bits(got), _bits(want[k][r]),
                    err_msg=f"{case} rank {r} {'residual' if k else 'output'}")
        outs = np.stack([per_rank[r][i][0] for r in range(world)])
        assert all((_bits(outs[r]) == _bits(outs[0])).all() for r in range(world)), \
            f"{case}: ranks ended with different bits"
        codec, _, mean, _, residual = case
        if residual and codec != "none":
            # Complete EF bookkeeping: summed over ranks, the residuals are
            # the all-reduce's whole compression error (sum units).
            exact = data.sum(axis=0) / (world if mean else 1)
            res = np.stack([per_rank[r][i][1] for r in range(world)]).sum(axis=0)
            scale = world if mean else 1
            np.testing.assert_allclose(res, scale * (exact - outs[0]), rtol=1e-4, atol=1e-4)


def _fail_rank(rank, world, init_method):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    return rank


def test_spawn_fails_the_run_when_a_rank_fails_and_world_one_is_identity():
    from distributed_machine_learning_tpu_torch.ops import ring
    from distributed_machine_learning_tpu_torch.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    with pytest.raises(RuntimeError, match="(?s)rank 1 failed:.*rank 1 gives up"):
        spawn(_fail_rank, 2, timeout_s=120)
    comm = Comm()
    assert comm.world == 1 and comm.wire == "none"
    x = torch.arange(10, dtype=torch.float32)
    out, res = ring.ring_all_reduce(x, comm, scheme=ring.get_wire_scheme("int8"),
                                    return_residual=True)
    assert torch.equal(out, x) and not res.any()
    grads = [x.clone(), x[:3].clone()]
    for name in ("all_reduce", "gather_scatter", "ring"):
        synced = get_strategy(name)(grads, comm)
        assert all(torch.equal(a, b) for a, b in zip(synced, grads))
