"""``cli.lm --parallel 3d`` (parallel/parallel3d.py over the subgroup Comms of
runtime/distributed.mesh_comms) vs the JAX package.

Trajectories: a d64 / 4-layer / 4-head / 2-KV-head / vocab-96 model, B 4 ×
L 64 in 2 microbatches, f32, 3 AdamW steps, on a dp 1 × pp 2 × tp 2 mesh
and on dp 2 × pp 2 × tp 1 with ``--zero1-dp``: the reference initializes it
(seed 69143), stacks and places it (``shard_3d_state``) and trains with
``make_3d_lm_train_step``; the port runs ``cli.lm``'s ``build`` in 4 gloo
ranks with the reference's initial weights and the same batches.  Losses
within 1e-5 relative (``tests/test_torch_fsdp_pl.py``'s tolerance), the
gathered, unstacked parameters within 4e-5: twice that file's 2e-5, because
the reference's own update-equivalent 3-D programs spread that far on this
model and these batches (its plain 3-D and ``--zero1-dp`` runs on the dp 2 ×
pp 2 × tp 1 mesh differ by 2.26e-5, its dp 2 × pp 2 × tp 1 and dp 1 × pp 2
× tp 2 runs by 3.29e-5: AdamW turns the summation order of a near-zero
gradient into a step of up to lr); ``--zero1-dp`` bit for bit plain 3-D on
the same mesh (the reference holds its two within 1e-6 on the losses).
On both meshes ``cli.lm``'s run with ``--ckpt-dir`` for 2 steps and
``--resume`` for 2 more is bit for bit the uninterrupted 4 steps (the
pipeline layout gathered over the TP and data groups, laid out again on
resume).  Every rank's mesh coordinates and its groups' members; the moment and
gradient layout rules against the reference's on fixed shapes; the mesh
checks read as the reference's.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.parallel import parallel3d as p3

MODEL = dict(vocab_size=96, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD, MICRO = 4, 64, 3, 4, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 4e-5  # the reference's own 3-D spread (see the module note)
FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "4", "--n-heads", "4",
         "--n-kv-heads", "2", "--vocab", "96", "--seq-len", str(SEQ), "--batch-size",
         str(BATCH), "--max-iters", str(STEPS), "--parallel", "3d", "--microbatches",
         str(MICRO)]
MESHES = {"1x2x2": (1, 2, 2, False), "2x2x1-zero1": (2, 2, 1, True),
          "2x2x1": (2, 2, 1, False)}


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX 3-D trajectory: (initial per-layer params, losses, final
    per-layer params)."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel import parallel3d as jp3
    from distributed_machine_learning_tpu.parallel.pipeline import unstack_lm_params
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    dp, pp_, tp, zero1 = MESHES[name]
    model = RefLM(**MODEL)
    init = jax.device_get(init_lm_state(model, seed=69143, config=AdamWConfig()).params)
    mesh = jp3.make_3d_mesh(dp, pp_, tp)
    step = jp3.make_3d_lm_train_step(model, mesh, MICRO, zero1_dp=zero1)
    state = jp3.shard_3d_state(jp3.init_pipeline_state(model, seed=69143,
                                                       config=AdamWConfig()),
                               mesh, zero1_dp=zero1)
    losses = []
    for x, y in _batches():
        state, loss = step(state, *jp3.shard_3d_batch(mesh, *jp3.microbatch(x, y, MICRO)))
        losses.append(float(loss))
    return init, losses, unstack_lm_params(jax.device_get(state.params), 4)


def _with_weights(weights):
    real = cli_lm.init_lm_state

    def init(model, seed, config):
        state = real(model, seed=seed, config=config)
        model.load_state_dict(weights)
        return state

    cli_lm.init_lm_state = init


def _resumed(args_for, ctx):
    """(uninterrupted 2 + 2 steps over the stream's first two batches twice,
    cli.lm's run with --ckpt-dir for 2 then --resume for 2): gathered
    parameters of both, and the resumed step."""
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    args = args_for()
    step, state, place, _ = cli_lm.build(args, ctx)
    for _ in range(2):
        state, _ = train_epoch(step, state, cli_lm.synthetic_batches(args, count=2),
                               place_batch=place, max_iters=2)
    want = {k: v.numpy() for k, v in step.params_fn(state).items()}
    cli_lm.run(args_for(), ctx)
    resumed_args = args_for("--resume")
    resumed = cli_lm.run(resumed_args, ctx)
    got = {k: v.numpy() for k, v in cli_lm.build(resumed_args, ctx)[0].params_fn(
        resumed).items()}
    return want, got, resumed.step


def _train_rank(rank, world, init_method, weights, ckdir):
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    _with_weights(weights)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    out = {}
    try:
        for name, (dp, pp_, tp, zero1) in MESHES.items():
            def args_for(*extra, dp=dp, pp_=pp_, tp=tp, zero1=zero1):
                return cli_lm.make_parser().parse_args([
                    *FLAGS, "--num-nodes", str(world), "--rank", str(rank), "--dp", str(dp),
                    "--pp", str(pp_), "--tp", str(tp), *(["--zero1-dp"] if zero1 else []),
                    *extra])

            args = args_for()
            step, state, place, model = cli_lm.build(args, ctx)
            losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
            params = {k: v.numpy() for k, v in step.params_fn(state).items()}
            mesh = {k: (c.rank, c.ranks) for k, c in step.mesh.items()}
            moments = {k: tuple(t.shape) for k, t in state.momentum["mu"].items()}
            out[name] = (losses, params, mesh, moments, dict(model.zero1 or {}))
            if name != "2x2x1":
                out[name + " ckpt"] = _resumed(
                    lambda *e, a=args_for, n=name: a("--max-iters", "2", "--ckpt-dir",
                                                     f"{ckdir}/{n}", *e), ctx)
        return out
    finally:
        ctx.shutdown()


@functools.lru_cache(maxsize=None)
def _port():
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    import tempfile

    with tempfile.TemporaryDirectory(prefix="p3_ckpt_") as ckdir:
        return spawn(_train_rank, WORLD, (flax_to_state_dict(_reference("1x2x2")[0]), ckdir),
                     timeout_s=300)


@pytest.mark.parametrize("name", ["1x2x2", "2x2x1-zero1"])
def test_three_steps_match_reference(name):
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    _, want_losses, want_params = _reference(name)
    want = flax_to_state_dict(want_params)
    ranks = _port()
    for out in ranks:
        losses, params = out[name][:2]
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        for key, w in want.items():
            np.testing.assert_allclose(params[key], w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=key)
        assert all(np.array_equal(params[k].view(np.uint32), ranks[0][name][1][k].view(
            np.uint32)) for k in params)


def test_zero1_dp_is_plain_3d_and_shards_the_moments():
    for out in _port():
        plain, zero1 = out["2x2x1"], out["2x2x1-zero1"]
        assert plain[0] == zero1[0]
        for k, p in plain[1].items():
            assert np.array_equal(zero1[1][k].view(np.uint32), p.view(np.uint32)), k
        dims, shapes, whole = zero1[4], zero1[3], plain[3]
        assert any(d is not None for d in dims.values())
        for k, d in dims.items():
            want = list(whole[k])
            if d is not None:
                want[d] //= 2
            assert shapes[k] == tuple(want), k
        assert dims["embed.weight"] is None


@pytest.mark.parametrize("name", ["1x2x2", "2x2x1-zero1"])
def test_save_resume_is_bit_for_bit(name):
    for out in _port():
        want, got, steps = out[name + " ckpt"]
        assert steps == 4 and got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k].view(np.uint32), v.view(np.uint32)), k


def test_mesh_groups_follow_the_reference_order():
    """rank = (d·pp + p)·tp + t: each axis's group holds the ranks that
    differ in that coordinate only, in its order."""
    for rank, out in enumerate(_port()):
        for name, (dp, pp_, tp, _) in MESHES.items():
            mesh = out[name][2]
            d, p, t = rank // (pp_ * tp), rank // tp % pp_, rank % tp
            assert mesh["model"] == (t, tuple((d * pp_ + p) * tp + i for i in range(tp)))
            assert mesh["pipe"] == (p, tuple((d * pp_ + i) * tp + t for i in range(pp_)))
            assert mesh["batch"] == (d, tuple((i * pp_ + p) * tp + t for i in range(dp)))


SHAPES = [(("blocks", "attn", "q", "kernel"), (4, 64, 4, 16)),
          (("blocks", "attn", "q", "bias"), (4, 4, 16)),
          (("blocks", "attn", "kv", "kernel"), (4, 64, 2, 2, 16)),
          (("blocks", "attn", "out", "kernel"), (4, 4, 16, 64)),
          (("blocks", "attn", "out", "bias"), (4, 64)),
          (("blocks", "fc_in", "kernel"), (4, 64, 256)),
          (("blocks", "fc_out", "kernel"), (4, 256, 64)),
          (("blocks", "ln1", "scale"), (4, 64)),
          (("blocks", "ln1", "scale"), (3, 5)),
          (("embed", "embedding"), (96, 64)),
          (("lm_head", "kernel"), (64, 96)),
          (("lm_head", "bias"), (96,)),
          (("ln_f", "bias"), (7,))]


@pytest.mark.parametrize("dp", [2, 3, 4])
def test_moment_and_grad_rules_match_reference(dp):
    from distributed_machine_learning_tpu.parallel import parallel3d as jp3

    for path, shape in SHAPES:
        base = tuple(jp3.p3_param_spec(path, len(shape)))
        name = ".".join(path)
        want_m = tuple(jp3.p3_zero1_moment_spec(path, shape, dp))
        want_g = tuple(jp3.p3_zero1_grad_spec(path, shape, dp))
        pad = lambda t: t + (None,) * (len(shape) - len(t))  # noqa: E731
        assert pad(p3.p3_zero1_moment_spec(name, shape, dp, base)) == pad(want_m), path
        assert pad(p3.p3_zero1_grad_spec(name, shape, dp, base)) == pad(want_g), path
    # The port's own layout: a stacked leaf's layer dim is the pipe's, the TP
    # split the model's, the embedding whole.
    assert p3.p3_param_spec("blocks.attn.q.weight", (4, 64, 64)) == ("pipe", "model", None)
    assert p3.p3_param_spec("blocks.attn.out.weight", (4, 64, 64)) == ("pipe", None, "model")
    assert p3.p3_param_spec("embed.weight", (96, 64)) == (None, None)
    assert p3.p3_param_spec("lm_head.weight", (96, 64)) == ("model", None)


def test_mesh_checks_read_as_the_reference():
    for flags, match in (
            (["--num-nodes", "4", "--dp", "2", "--pp", "2", "--tp", "2"],
             "3-D mesh dp×pp×tp = 2×2×2 = 8 must equal the device count 4 \\(a "
             "prefix-subset mesh would silently idle the rest\\)"),
            (["--pp", "0"], "--pp and --tp must be >= 1, got pp=0 tp=2"),
            (["--num-nodes", "4", "--dp", "0"], "--dp must be >= 1, got 0"),
            (["--zero1-dp", "--parallel", "pp"], "--zero1-dp \\(ZeRO-1 x 3-D moment "
                                                 "sharding\\) applies to --parallel 3d only")):
        with pytest.raises(ValueError, match=match):
            cli_lm.main([*FLAGS, *flags])
    with pytest.raises(ValueError, match="microbatch size 3 must be divisible by the "
                                         "2-device data axis"):
        from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

        p3.shard_3d_batch(Comm(0, 2), torch.zeros(2, 3, 4), torch.zeros(2, 3, 4))
    assert cli_lm.attn_impl(cli_lm.make_parser().parse_args(FLAGS)) == "dense"


def test_cli_runs_one_rank(capsys):
    cli_lm.main([*FLAGS, "--dp", "1", "--pp", "1", "--tp", "1", "--fused-update",
                 "--max-iters", "2", "--eval-batches", "1"])
    out = capsys.readouterr().out
    assert "lm parallel=3d devices=1 (cpu)" in out and "mesh=batch1xpipe1xmodel1" in out
    assert "Eval: nll/token " in out
