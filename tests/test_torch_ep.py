"""``cli.lm --parallel ep`` (parallel/expert_parallel.py, models/moe.py,
ops/grouped.grouped_expert_mlp_ep) vs the JAX package, on the CPU.

The op: ``grouped_expert_mlp_ep`` in 2 gloo ranks against the reference's
under ``shard_map`` on a 2-device expert mesh, dropless (random routes) and
bounded (every row to expert 0, 2 send slots): the output and the
gradients of the tokens and of the expert leaves of ``sum(out²)`` (f32,
within 1e-5 relative and absolute; the weights at the model's init
scale), the dropped counts equal, the dropped rows' output and gradient
exactly zero.

The steps: a d64 / 2-layer / 4-head / 2-KV-head / vocab-96 MoE, E 4, B 4 ×
L 32, f32, 3 AdamW steps; the reference initializes it (seed 69143) and
trains with ``make_ep_train_step`` (einsum, a (1, 2) mesh; without a mesh:
one device) and ``make_ep_grouped_train_step`` (a (1, 2) mesh); the port
runs ``cli.lm``'s ``build`` in 2 gloo ranks (one process at world 1) from
the reference's initial weights on the same batches.  Losses within 1e-5
relative, the gathered parameters within 2e-5 (``tests/test_torch_tp_train.py``'s
tolerances); the leaves outside the experts bit for bit equal across the
ranks; at every step every token's expert equal to the reference's (its
routes read off the router of a forward of the reference model on the
parameters before the step; the smallest top-1 margin is printed).  The
(2, 2) einsum mesh and ``--ep-seq`` are in ``tests/test_torch_ep_cp.py``.
The EP checkpoint: saved after 2 steps (the experts gathered), resumed for
a third, bit for bit the uninterrupted run, and served by ``cli.generate
--moe --ckpt-dir``.  The guards read as the reference's, and the EP
modules import no JAX.
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm

MODEL = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, n_experts=4)
BATCH, SEQ, STEPS, WORLD = 4, 32, 3, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
OP_TOL = 1e-5
FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "2", "--n-heads", "4",
         "--n-kv-heads", "2", "--vocab", "96", "--n-experts", "4", "--seq-len", str(SEQ),
         "--batch-size", str(BATCH), "--max-iters", str(STEPS), "--parallel", "ep"]
# name: (the reference's mesh shape (batch, expert[, seq]), or None for one
# device; --moe-impl).  The 4-rank cases run in tests/test_torch_ep_cp.py.
CASES = {"einsum-1x2": ((1, 2), "einsum"), "grouped-1x2": ((1, 2), "grouped"),
         "world1": (None, "grouped"), "einsum-2x2": ((2, 2), "einsum"),
         "grouped-seq-1x2x2": ((1, 2, 2), "grouped")}
SEQ_LEN = {"grouped-seq-1x2x2": 64}  # --ep-seq 2: chunks of 32
# The op case: E 4 over 2 ranks, 8 rows a rank, D 4, F 8.
OP = dict(ep=2, n_local=8, d=4, dff=8, experts=4)


def _world(case) -> int:
    shape = CASES[case][0]
    return 1 if shape is None else int(np.prod(shape))


def _flags(case, rank: int) -> list:
    """cli.lm's flags of a case on one rank."""
    shape, impl = CASES[case]
    out = [*FLAGS, "--moe-impl", impl]
    if shape is not None:
        out += ["--num-nodes", str(_world(case)), "--rank", str(rank), "--ep", str(shape[1])]
    if shape is not None and len(shape) == 3:
        out += ["--ep-seq", str(shape[2]), "--seq-len", str(SEQ_LEN[case])]
    return out


def _batches(seq=SEQ, count=STEPS):
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, seq, MODEL["vocab_size"])
              for _ in range(count)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


def _jax_routes(model, params, tokens):
    """Each layer's experts [layers, B, L] of a forward of the reference
    ``model`` on ``params``, and the smallest top-1 router margin (its
    probability over the runner-up's)."""
    import jax
    import jax.numpy as jnp

    _, inter = model.apply({"params": params}, jnp.asarray(tokens),
                           capture_intermediates=True, mutable=["intermediates"])
    inter = inter["intermediates"]
    routes, margin = [], np.inf
    for i in range(MODEL["n_layers"]):
        gate = np.asarray(inter[f"block_{i}"]["moe"]["router"]["__call__"][0])
        probs = np.asarray(jax.nn.softmax(gate, axis=-1))
        top = np.sort(probs, axis=-1)
        margin = min(margin, float((top[:, -1] - top[:, -2]).min()))
        routes.append(gate.argmax(-1).reshape(tokens.shape))
    return np.stack(routes), margin


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The reference's trajectory: (initial params, losses, final params,
    routes a step [steps, layers, B, L], smallest router margin)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from distributed_machine_learning_tpu.models.moe import MoETransformerLM as RefMoE
    from distributed_machine_learning_tpu.parallel.expert_parallel import (
        init_moe_state,
        make_ep_grouped_train_step,
        make_ep_train_step,
        shard_ep_state,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig

    shape, impl = CASES[case]
    model = RefMoE(**MODEL, moe_impl=impl, attn_impl="dense")
    state = init_moe_state(model, seed=69143, config=AdamWConfig())
    init = jax.device_get(state.params)
    if shape is None:
        step = make_ep_train_step(model, mesh=None)
        place = lambda x, y: (jnp.asarray(x), jnp.asarray(y))  # noqa: E731
    else:
        axes = ("batch", "expert", "seq")[:len(shape)]
        mesh = make_mesh(int(np.prod(shape)), axes, shape)
        if impl == "einsum":
            step = make_ep_train_step(model, mesh)
            spec = P("batch", None)
        elif len(shape) == 3:  # the cli's --ep-seq: the ring over the seq axis
            step = make_ep_grouped_train_step(model.clone(attn_impl="ring"), mesh,
                                              seq_axis="seq")
            spec = P(("batch", "expert"), "seq")
        else:
            step = make_ep_grouped_train_step(model, mesh)
            spec = P(("batch", "expert"), None)
        state = shard_ep_state(state, mesh)
        sharding = NamedSharding(mesh, spec)
        place = lambda x, y: (jax.device_put(jnp.asarray(x), sharding),  # noqa: E731
                              jax.device_put(jnp.asarray(y), sharding))
    losses, routes, margin = [], [], np.inf
    for x, y in _batches(SEQ_LEN.get(case, SEQ)):
        r, m = _jax_routes(model, jax.device_get(state.params), x)
        routes.append(r)
        margin = min(margin, m)
        state, loss = step(state, *place(x, y))
        losses.append(float(loss))
    return init, losses, jax.device_get(state.params), np.stack(routes), margin


def _with_weights(weights):
    """cli.lm's MoE init, then the given weights (before the state is
    sharded), and a tape of every routing decision (MoEMLP.route)."""
    from distributed_machine_learning_tpu_torch.models.moe import MoEMLP
    from distributed_machine_learning_tpu_torch.parallel import expert_parallel as ep_mod

    real = ep_mod.init_moe_state

    def init(model, seed, config):
        state = real(model, seed=seed, config=config)
        model.load_state_dict(weights)
        return state

    ep_mod.init_moe_state = init
    tape: list = []
    route = MoEMLP.route

    def taped(self, tokens):
        out = route(self, tokens)
        tape.append(out[1].detach().numpy().copy())
        return out

    MoEMLP.route = taped
    return tape


def _run(args, ctx, tape, batches):
    """One cli.lm build trained over ``batches``: losses, the gathered and
    the local parameters, the routes a step [steps, layers, rows, cols]."""
    step, state, place, model = cli_lm.build(args, ctx)
    tape.clear()
    losses = []
    for x, y in batches:
        xs, ys = place(x, y)
        losses.append(float(step(state, xs, ys)[1]))
    routes = np.stack(tape).reshape(len(batches), MODEL["n_layers"], *xs.shape)
    params = {k: v.detach().numpy().copy() for k, v in step.params_fn(state).items()}
    local = {k: p.detach().numpy().copy() for k, p in model.named_parameters()}
    mesh = {k: (c.rank, c.world) for k, c in getattr(step, "mesh", {}).items()}
    return dict(losses=losses, params=params, local=local, routes=routes, mesh=mesh,
                step=state.step)


def _op_inputs(routes: str):
    """The op case's global inputs (numpy, from a seed): tokens [ep·n, D],
    experts [ep·n], and the four expert leaves of E experts."""
    rng = np.random.default_rng(5)
    n, d, f, e = OP["ep"] * OP["n_local"], OP["d"], OP["dff"], OP["experts"]
    tokens = rng.standard_normal((n, d)).astype(np.float32)
    eidx = (np.zeros(n) if routes == "bounded" else rng.integers(0, e, n)).astype(np.int32)
    # Weights at the model's init scale (1/sqrt(fan-in)), biases small.
    leaves = [(rng.standard_normal(s) / np.sqrt(s[-2] if len(s) == 3 else 8)).astype(np.float32)
              for s in ((e, d, f), (e, f), (e, f, d), (e, d))]
    return tokens, eidx, leaves


def _op_rank(comm):
    """This rank's part of the op cases: its output rows, the gradients of
    its tokens and expert leaves, its dropped count."""
    from distributed_machine_learning_tpu_torch.ops.grouped import grouped_expert_mlp_ep

    out = {}
    for routes, slots in (("dropless", None), ("bounded", 2)):
        tokens, eidx, leaves = _op_inputs(routes)
        rows = slice(comm.rank * OP["n_local"], (comm.rank + 1) * OP["n_local"])
        e_local = OP["experts"] // comm.world
        own = slice(comm.rank * e_local, (comm.rank + 1) * e_local)
        t = torch.from_numpy(tokens[rows]).requires_grad_()
        ws = [torch.from_numpy(w[own].copy()).requires_grad_() for w in leaves]
        y, dropped = grouped_expert_mlp_ep(
            t, torch.from_numpy(eidx[rows]), *ws, comm=comm,
            n_experts_global=OP["experts"], slots_per_owner=slots, return_dropped=True)
        (y * y).sum().backward()
        out[routes] = dict(y=y.detach().numpy(), dt=t.grad.numpy(),
                           dw=[w.grad.numpy() for w in ws], dropped=int(dropped))
    return out


def _rank(rank, world, init_method, weights):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    tape = _with_weights(weights)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        out = {"op": _op_rank(ctx.comm)} if world == 2 else {}
        for case in CASES:
            if _world(case) == world:
                args = cli_lm.make_parser().parse_args(_flags(case, rank))
                out[case] = _run(args, ctx, tape, _batches(SEQ_LEN.get(case, SEQ)))
        if world == 2:  # the spawn's rendezvous directory outlives the ranks' runs
            out["ckpt"] = _ckpt_rank(rank, world, ctx, tape,
                                     init_method[len("file://"):] + "-ckpt")
        return out
    finally:
        ctx.shutdown()


def _ckpt_rank(rank, world, ctx, tape, ckdir):
    """grouped EP: 2 steps saved by cli.lm's run, resumed for 1 more (the
    stream restarts at its seed: batches 0, 1, then 0), against the same 3
    batches uninterrupted; rank 0 then serves the checkpoint with
    cli.generate --moe and with the generate loop on the final parameters."""
    from distributed_machine_learning_tpu_torch.cli import generate as cli_generate
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.models.moe import MoETransformerLM
    from distributed_machine_learning_tpu_torch.parallel.expert_parallel import (
        gather_ep_params,
    )
    from distributed_machine_learning_tpu_torch.train.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
    )

    flags = [*FLAGS, "--moe-impl", "grouped", "--num-nodes", str(world), "--rank",
             str(rank), "--ckpt-dir", ckdir]
    parse = cli_lm.make_parser().parse_args

    def gathered(state):
        return {k: v.numpy().copy()
                for k, v in gather_ep_params(state, state.model.mesh["expert"]).items()}

    two = gathered(cli_lm.run(parse([*flags, "--max-iters", "2"]), ctx))
    saved = restore_checkpoint(latest_checkpoint(ckdir), files_verified=True)
    resumed = cli_lm.run(parse([*flags, "--max-iters", "1", "--resume"]), ctx)
    final = gathered(resumed)
    b = _batches(count=2)
    straight = _run(parse(flags), ctx, tape, [b[0], b[1], b[0]])
    out = dict(step=resumed.step, saved_step=saved.step, final=final,
               straight=straight["params"],
               saved_equal=all(np.array_equal(saved.params[k].numpy(), v)
                               for k, v in two.items()) and saved.params.keys() == two.keys())
    if rank == 0:
        shape = dict(vocab_size=96, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
        out["served"] = cli_generate.main([
            "--device", "cpu", "--moe", "--n-experts", "4", "--ckpt-dir", ckdir,
            "--d-model", "64", "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
            "--vocab", "96", "--compute-dtype", "float32", "--temperature", "0",
            "--max-new-tokens", "6", "--prompt", "expert"])
        model = MoETransformerLM(**shape, n_experts=4, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in final.items()})
        prompt = torch.tensor([[b % 96 for b in b"expert"]])
        out["direct"] = make_generate_fn(model.eval(), 6)(prompt)[0, 6:].tolist()
    return out


@functools.lru_cache(maxsize=None)
def _port(world: int = WORLD):
    """Every rank's records of the cases of ``world`` ranks (one spawn)."""
    from distributed_machine_learning_tpu_torch.convert import flax_moe_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    init = _reference("einsum-1x2")[0]  # every case starts from the same weights
    return spawn(_rank, world, (flax_moe_to_state_dict(init),), timeout_s=400)


@functools.lru_cache(maxsize=None)
def _port_world1():
    from distributed_machine_learning_tpu_torch.convert import flax_moe_to_state_dict

    from distributed_machine_learning_tpu_torch.models.moe import MoEMLP
    from distributed_machine_learning_tpu_torch.parallel import expert_parallel as ep_mod

    init, route = ep_mod.init_moe_state, MoEMLP.route
    try:
        tape = _with_weights(flax_moe_to_state_dict(_reference("world1")[0]))
        args = cli_lm.make_parser().parse_args(_flags("world1", 0))
        return _run(args, None, tape, _batches())
    finally:
        ep_mod.init_moe_state, MoEMLP.route = init, route


def _op_reference(routes: str, slots):
    """The reference op under shard_map on a 2-device expert mesh: the
    output, the gradients of the tokens and the four expert leaves of
    sum(out²), the dropped count a device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from distributed_machine_learning_tpu.ops.grouped import grouped_expert_mlp_ep
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh, shard_map_no_check

    mesh = make_mesh(OP["ep"], axis_names=("expert",))
    tokens, eidx, leaves = _op_inputs(routes)

    def f(t, ei, wi, bi, wo, bo):
        y, nd = grouped_expert_mlp_ep(t, ei, wi, bi, wo, bo, expert_axis="expert",
                                      n_experts_global=OP["experts"],
                                      slots_per_owner=slots, return_dropped=True)
        return y, nd[None]

    fn = shard_map_no_check(f, mesh=mesh, in_specs=(P("expert"),) * 6,
                            out_specs=(P("expert"), P("expert")))
    args = [jnp.asarray(a) for a in (tokens, eidx, *leaves)]
    y, dropped = jax.jit(fn)(*args)

    def loss(t, wi, bi, wo, bo):
        return jnp.sum(fn(t, args[1], wi, bi, wo, bo)[0] ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(args[0], *args[2:])
    return np.asarray(y), [np.asarray(g) for g in grads], np.asarray(dropped)


@pytest.mark.parametrize("routes,slots", [("dropless", None), ("bounded", 2)])
def test_grouped_expert_mlp_ep_matches_reference(routes, slots):
    y, grads, dropped = _op_reference(routes, slots)
    ranks = [out["op"][routes] for out in _port()]
    got_y = np.concatenate([r["y"] for r in ranks])
    np.testing.assert_allclose(got_y, y, rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(np.concatenate([r["dt"] for r in ranks]), grads[0], rtol=OP_TOL,
                               atol=OP_TOL)
    for i in range(4):
        np.testing.assert_allclose(np.concatenate([r["dw"][i] for r in ranks]), grads[i + 1],
                                   rtol=OP_TOL, atol=OP_TOL)
    assert [r["dropped"] for r in ranks] == list(dropped)
    if slots is not None:
        # Every row routes to expert 0; each sender keeps 2 and drops the rest:
        # zero output and zero gradient.
        assert sum(r["dropped"] for r in ranks) == OP["ep"] * (OP["n_local"] - slots)
        for r in ranks:
            assert not r["y"][slots:].any() and not r["dt"][slots:].any()
            assert r["y"][:slots].any() and r["dt"][:slots].any()


def check_case(case):
    """A case's 3 steps on every rank against the reference (the module
    note's tolerances, routes and bits)."""
    from distributed_machine_learning_tpu_torch.convert import flax_moe_to_state_dict
    from distributed_machine_learning_tpu_torch.parallel.expert_parallel import (
        is_expert_path,
    )

    _, want_losses, want_params, want_routes, margin = _reference(case)
    print(f"{case}: smallest top-1 router margin {margin:.3e}")
    world = _world(case)
    recs = [_port_world1()] if world == 1 else [out[case] for out in _port(world)]
    want = flax_moe_to_state_dict(want_params)
    for rec in recs:
        assert rec["step"] == STEPS
        np.testing.assert_allclose(rec["losses"], want_losses, rtol=LOSS_RTOL)
        assert rec["params"].keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(rec["params"][name], w.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)
    # Routes: each rank's block of the batch (einsum: its data rank's rows,
    # whole on its expert ranks; grouped: the rows of its (data, expert)
    # pair and its sequence chunk), placed into the global [B, L].
    got = np.full(want_routes.shape, -1)
    for rec in recs:
        m = rec["mesh"]
        rows, row_shards = m.get("batch", (0, 1))
        if CASES[case][1] == "grouped" and world > 1:
            rows, row_shards = rows * m["expert"][1] + m["expert"][0], row_shards * m["expert"][1]
        col, cols = m.get("seq", (0, 1))
        r, c = rec["routes"].shape[-2:]
        assert (r * row_shards, c * cols) == want_routes.shape[-2:]
        got[..., rows * r:(rows + 1) * r, col * c:(col + 1) * c] = rec["routes"]
    np.testing.assert_array_equal(got, want_routes)
    for name, t in recs[0]["local"].items():
        if not is_expert_path(name):  # whole on every rank, the same bits
            for rec in recs[1:]:
                assert np.array_equal(t.view(np.uint32), rec["local"][name].view(np.uint32)), name


@pytest.mark.parametrize("case", [c for c in CASES if _world(c) < 4])
def test_three_steps_match_reference(case):
    check_case(case)


def test_checkpoint_resumes_bit_for_bit_and_serves():
    ranks = [out["ckpt"] for out in _port()]
    for rec in ranks:
        assert rec["saved_step"] == 2 and rec["step"] == 3 and rec["saved_equal"]
        assert rec["final"].keys() == rec["straight"].keys()
        for name, t in rec["final"].items():
            assert np.array_equal(t, rec["straight"][name]), name
    assert np.ravel(ranks[0]["served"]).tolist() == ranks[0]["direct"]


# Flags of the two CLIs' EP checks at 8 devices (the reference's forced CPU
# mesh; the port's --num-nodes 8), each raising before any group forms.
GUARDS = [
    ["--ep-seq", "2"],
    ["--parallel", "ep", "--ep-slots", "2"],
    ["--parallel", "ep", "--ep", "3"],
    ["--parallel", "ep", "--n-experts", "6", "--ep", "4"],
    ["--parallel", "ep", "--n-experts", "0"],
    ["--parallel", "ep", "--ep-seq", "2"],
    ["--parallel", "ep", "--ep-seq", "0"],
    ["--parallel", "ep", "--moe-impl", "grouped", "--ep", "4", "--ep-seq", "4"],
    ["--parallel", "ep", "--ep", "2", "--batch-size", "3"],
    ["--parallel", "ep", "--moe-impl", "grouped", "--ep", "2", "--batch-size", "4"],
    ["--parallel", "ep", "--moe-impl", "grouped", "--ep", "2", "--ep-seq", "2",
     "--batch-size", "4", "--seq-len", "129"],
    ["--parallel", "ep", "--remat", "--remat-policy", "block"],
    ["--parallel", "ep", "--n-kv-heads", "3"],
]


def test_guards_read_as_the_reference():
    import jax
    from jax.sharding import Mesh

    from distributed_machine_learning_tpu.cli import lm as ref_cli
    from distributed_machine_learning_tpu.models.moe import MoEMLP as RefMLP
    from distributed_machine_learning_tpu.models.moe import MoETransformerLM as RefMoE
    from distributed_machine_learning_tpu.parallel import expert_parallel as ref_ep
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu_torch.models.moe import MoEMLP, MoETransformerLM
    from distributed_machine_learning_tpu_torch.parallel import expert_parallel as ep
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    assert jax.device_count() == 8
    for flags in GUARDS:
        with pytest.raises(ValueError) as want:
            ref_cli.build(ref_cli.make_parser().parse_args(flags))
        with pytest.raises(ValueError) as got:
            cli_lm.main(["--device", "cpu", "--num-nodes", "8", *flags])
        assert str(got.value) == str(want.value), flags
    # The model's guards of the expert-parallel fields.
    x = np.zeros((1, 2, 8), np.float32)
    mlp = dict(n_experts=4, d_ff=16, moe_impl="grouped")
    for ref_kw, kw, exc in (
            (dict(ep_slots_per_owner=2), dict(ep_slots_per_owner=2), ValueError),
            (dict(expert_axis="expert", weight_quant="int8", dropless=True),
             dict(expert_comm=Comm(0, 2), weight_quant="int8"), NotImplementedError),
            (dict(expert_axis="expert", tp_axis="model", dropless=True),
             dict(expert_comm=Comm(0, 2), tp_comm=Comm(0, 2)), NotImplementedError)):
        with pytest.raises(exc) as want:
            RefMLP(**mlp, **ref_kw).init(jax.random.PRNGKey(0), x)
        with pytest.raises(exc) as got:
            MoEMLP(8, 4, 16, moe_impl="grouped", device="cpu", **kw)
        assert str(got.value) == str(want.value)
    # The steps' guards (a mesh of Comms in place of the reference's Mesh).
    small = dict(MODEL, n_experts=4)
    seq, seq3 = Comm(0, 2), Comm(0, 3)
    mesh2 = make_mesh(2, ("batch", "expert"), (1, 2))
    mesh3 = make_mesh(4, ("batch", "expert", "seq"), (1, 2, 2))
    comms2 = {"batch": Comm(0, 1), "expert": Comm(0, 2)}
    comms3 = {**comms2, "seq": seq}
    ring = dict(attn_impl="ring", comm=seq, token_comms=(seq,))
    cases = [
        (lambda: ref_ep.make_ep_train_step(RefMoE(**small, attn_impl="ring")),
         lambda: ep.make_ep_train_step(MoETransformerLM(**small, **ring, device="cpu"))),
        (lambda: ref_ep.make_ep_train_step(RefMoE(**small, moe_impl="grouped"), mesh2),
         lambda: ep.make_ep_train_step(MoETransformerLM(**small, moe_impl="grouped",
                                                        device="cpu"), comms2)),
        (lambda: ref_ep.make_ep_grouped_train_step(RefMoE(**small), mesh2),
         lambda: ep.make_ep_grouped_train_step(MoETransformerLM(**small, device="cpu"),
                                               comms2, Comm(0, 2))),
        (lambda: ref_ep.make_ep_grouped_train_step(
            RefMoE(**small, moe_impl="grouped", attn_impl="ring"), mesh2),
         lambda: ep.make_ep_grouped_train_step(
            MoETransformerLM(**small, moe_impl="grouped", **ring, device="cpu"), comms2,
            Comm(0, 2))),
        (lambda: ref_ep.make_ep_grouped_train_step(
            RefMoE(**small, moe_impl="grouped"), mesh3, seq_axis="seq"),
         lambda: ep.make_ep_grouped_train_step(
            MoETransformerLM(**small, moe_impl="grouped", device="cpu"), comms3,
            Comm(0, 4), seq_axis="seq")),
        (lambda: ref_ep.make_ep_grouped_train_step(
            RefMoE(**dict(small, n_heads=2, n_kv_heads=None), moe_impl="grouped",
                   attn_impl="ulysses"),
            Mesh(np.array(jax.devices()[:3]).reshape(1, 1, 3), ("batch", "expert", "seq")),
            seq_axis="seq"),
         lambda: ep.make_ep_grouped_train_step(
            MoETransformerLM(**dict(small, n_heads=2, n_kv_heads=None), moe_impl="grouped",
                             attn_impl="ulysses", comm=seq3, token_comms=(seq3,),
                             device="cpu"),
            {"batch": Comm(0, 1), "expert": Comm(0, 1), "seq": seq3}, Comm(0, 3),
            seq_axis="seq")),
        (lambda: ref_ep.make_ep_train_step(
            RefMoE(**small), make_mesh(3, ("batch", "expert"), (1, 3))),
         lambda: ep.make_ep_train_step(MoETransformerLM(**small, device="cpu"),
                                       {"batch": Comm(0, 1), "expert": Comm(0, 3)})),
    ]
    for ref_call, call in cases:
        with pytest.raises(ValueError) as want:
            ref_call()
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(want.value)


def test_ep_modules_import_no_jax():
    code = ("import sys, distributed_machine_learning_tpu_torch.cli.lm, "
            "distributed_machine_learning_tpu_torch.parallel.expert_parallel, "
            "distributed_machine_learning_tpu_torch.models.moe, "
            "distributed_machine_learning_tpu_torch.ops.grouped, "
            "distributed_machine_learning_tpu_torch.ops.collectives; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('distributed_machine_learning_tpu.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
