"""``cli.lm --parallel pp`` (parallel/pipeline.py, pipeline_1f1b.py,
pipeline_interleaved.py) vs the JAX package.

Trajectories: a d64 / 4-layer / 4-head / 2-KV-head / vocab-96 model, B 4 ×
L 64 in 4 microbatches, f32, dense attention, 3 AdamW steps over 2 stages:
the reference initializes it (seed 69143), stacks it and trains with each
of its three builders (``make_pp_lm_train_step``,
``make_pp_1f1b_lm_train_step``, ``make_pp_interleaved_lm_train_step`` at
v 2) on a (2,) pipe mesh; the port runs ``cli.lm``'s ``build`` in 2 gloo
ranks (``--pp-schedule gpipe``, ``1f1b``, ``interleaved --pp-chunks 2``)
with the reference's initial weights and the same batches.  Losses within
1e-5 relative, the gathered, unstacked parameters within 2e-5
(``tests/test_torch_fsdp_pl.py``'s tolerances); ``--overlap-update`` bit for
bit the sync GPipe run.  The stacked layouts (contiguous and interleaved)
row for row the reference's, their tags and the tag parser's refusal; the
schedules' tables (each microbatch once forward and once backward through
every virtual stage; 1F1B's in-flight bound); the refusals read as the
reference's.
"""

import functools

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.parallel import pipeline as pp
from distributed_machine_learning_tpu_torch.parallel import pipeline_interleaved as ppi
from distributed_machine_learning_tpu_torch.parallel.pipeline_1f1b import one_f_one_b_table

MODEL = dict(vocab_size=96, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS, WORLD, MICRO, CHUNKS = 4, 64, 3, 2, 4, 2
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "4", "--n-heads", "4",
         "--n-kv-heads", "2", "--vocab", "96", "--seq-len", str(SEQ), "--batch-size",
         str(BATCH), "--max-iters", str(STEPS), "--parallel", "pp", "--microbatches",
         str(MICRO)]
RUNS = {"gpipe": ["--pp-schedule", "gpipe"], "1f1b": ["--pp-schedule", "1f1b"],
        "interleaved": ["--pp-schedule", "interleaved", "--pp-chunks", str(CHUNKS)],
        "overlap": ["--pp-schedule", "gpipe", "--overlap-update"]}


def _batches():
    rng = np.random.default_rng(69143)
    blocks = [cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
              for _ in range(STEPS)]
    return [(b[:, :-1], b[:, 1:]) for b in blocks]


def _ref_model():
    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM

    return RefLM(**MODEL, attn_impl="dense")


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """The JAX pipeline trajectory of one schedule: (initial per-layer params,
    losses, final per-layer params)."""
    import jax

    from distributed_machine_learning_tpu.parallel import pipeline as jpp
    from distributed_machine_learning_tpu.parallel import pipeline_interleaved as jppi
    from distributed_machine_learning_tpu.parallel.pipeline_1f1b import (
        make_pp_1f1b_lm_train_step,
    )
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state

    model = _ref_model()
    mesh = make_mesh(WORLD, ("pipe",))
    init = jax.device_get(init_lm_state(model, seed=69143, config=AdamWConfig()).params)
    if kind == "interleaved":
        step = jppi.make_pp_interleaved_lm_train_step(model, mesh, MICRO, CHUNKS)
        state = jppi.init_interleaved_state(model, WORLD, CHUNKS, seed=69143,
                                            config=AdamWConfig())
        unstack = lambda p: jppi.unstack_interleaved(p, 4, WORLD, CHUNKS)  # noqa: E731
    else:
        build = {"gpipe": jpp.make_pp_lm_train_step, "1f1b": make_pp_1f1b_lm_train_step}
        step = build[kind](model, mesh, MICRO)
        state = jpp.init_pipeline_state(model, seed=69143, config=AdamWConfig())
        unstack = lambda p: jpp.unstack_lm_params(p, 4)  # noqa: E731
    state = jpp.shard_pp_state(state, mesh)
    losses = []
    for x, y in _batches():
        state, loss = step(state, *jpp.microbatch(x, y, MICRO))
        losses.append(float(loss))
    return init, losses, unstack(jax.device_get(state.params))


def _with_weights(weights):
    real = cli_lm.init_lm_state

    def init(model, seed, config):
        state = real(model, seed=seed, config=config)
        model.load_state_dict(weights)
        return state

    cli_lm.init_lm_state = init


def _train_rank(rank, world, init_method, weights):
    """Every schedule of RUNS in this rank, in turn: losses, the gathered
    per-layer parameters, the local leaves' names."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.set_num_threads(1)
    _with_weights(weights)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    out = {}
    try:
        for kind, extra in RUNS.items():
            args = cli_lm.make_parser().parse_args([*FLAGS, "--num-nodes", str(world),
                                                    "--rank", str(rank), *extra])
            step, state, place, model = cli_lm.build(args, ctx)
            losses = [float(step(state, *place(x, y))[1]) for x, y in _batches()]
            params = {k: v.numpy() for k, v in step.params_fn(state).items()}
            out[kind] = (losses, params, model.layer_ids, state.step)
        return out
    finally:
        ctx.shutdown()


@functools.lru_cache(maxsize=None)
def _port():
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    return spawn(_train_rank, WORLD, (flax_to_state_dict(_reference("gpipe")[0]),),
                 timeout_s=300)


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "interleaved"])
def test_schedule_matches_reference(kind):
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    _, want_losses, want_params = _reference(kind)
    want = flax_to_state_dict(want_params)
    layers = {"interleaved": [[0, 2], [1, 3]]}.get(kind, [[0, 1], [2, 3]])
    ranks = _port()
    for rank, out in enumerate(ranks):
        losses, params, layer_ids, steps = out[kind]
        assert steps == STEPS and layer_ids == layers[rank]
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
        assert params.keys() == want.keys()
        for name, w in want.items():
            np.testing.assert_allclose(params[name], w.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=name)
    for name, p in ranks[0][kind][1].items():
        assert np.array_equal(ranks[1][kind][1][name].view(np.uint32), p.view(np.uint32))


def test_overlap_update_is_bit_for_bit_sync_gpipe():
    for out in _port():
        (sync_l, sync_p, _, _), (ov_l, ov_p, _, _) = out["gpipe"], out["overlap"]
        assert sync_l == ov_l
        for name, p in sync_p.items():
            assert np.array_equal(ov_p[name].view(np.uint32), p.view(np.uint32)), name


def _stacked_rows(stacked_jax: dict, n: int) -> list:
    """Each row of a reference stacked tree as the port's per-layer names
    (``blocks.0.<leaf>``)."""
    import jax

    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    rows = []
    for j in range(n):
        tree = {k: v for k, v in stacked_jax.items() if k != "blocks"}
        tree["block_0"] = jax.tree_util.tree_map(lambda x, j=j: x[j], stacked_jax["blocks"])
        rows.append(flax_to_state_dict(tree))
    return rows


@pytest.mark.parametrize("v", [1, 2])
def test_stacked_layouts_and_tags_match_reference(v):
    import jax

    from distributed_machine_learning_tpu.parallel import pipeline as jpp
    from distributed_machine_learning_tpu.parallel import pipeline_interleaved as jppi
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict

    params = jax.device_get(init_lm_state(_ref_model(), seed=3).params)
    flat = flax_to_state_dict(params)
    if v == 1:
        want, got = jpp.stack_lm_params(params, 4), pp.stack_lm_params(flat, 4)
        back = pp.unstack_lm_params(got, 4)
    else:
        want = jppi.stack_interleaved(params, 4, WORLD, v)
        got = ppi.stack_interleaved(flat, 4, WORLD, v)
        back = ppi.unstack_interleaved(got, 4, WORLD, v)
        assert ppi._interleaved_order(8, 2, 2) == jppi._interleaved_order(8, 2, 2)
    for j, row in enumerate(_stacked_rows(jax.device_get(want), 4)):
        for name, t in row.items():
            key = name.replace("blocks.0.", "blocks.") if name.startswith("blocks.") else name
            assert torch.equal(got[key][j] if key.startswith("blocks.") else got[key], t)
    assert list(back) == list(flat) and all(torch.equal(back[k], flat[k]) for k in flat)
    for P_, v_ in ((2, 2), (4, 3)):
        tag = ppi.interleaved_layout_tag(P_, v_)
        assert tag == jppi.interleaved_layout_tag(P_, v_)
        assert ppi.parse_interleaved_layout(tag) == jppi.parse_interleaved_layout(tag)
    for tag in (None, "pp-contiguous"):
        assert ppi.parse_interleaved_layout(tag) is None
    with pytest.raises(ValueError) as want_err:
        jppi.parse_interleaved_layout("pp-interleaved-P2")
    with pytest.raises(ValueError) as got_err:
        ppi.parse_interleaved_layout("pp-interleaved-P2")
    assert str(got_err.value) == str(want_err.value)


@pytest.mark.parametrize("M,P,v", [(4, 2, 1), (3, 2, 2), (5, 4, 2), (8, 4, 1), (1, 3, 1)])
def test_tables_run_every_microbatch_once(M, P, v):
    K = P * v
    tables = {"gpipe": pp.gpipe_table(M, P, v)}
    if v == 1:
        tables["1f1b"] = one_f_one_b_table(M, P)
    for kind, table in tables.items():
        assert len({len(t) for t in table}) == 1
        for sub in (0, 1):
            items = sorted(x[sub] for t in table for x in t if x[sub] is not None)
            assert items == sorted((m, k) for m in range(M) for k in range(K)), kind
        if kind == "1f1b":  # at most 2(P-1-s)+1 microbatches in flight on stage s
            for s, ticks in enumerate(table):
                live = peak = 0
                for f, b in ticks:
                    live += f is not None
                    peak = max(peak, live)
                    live -= b is not None
                assert peak <= 2 * (P - 1 - s) + 1


def test_refusals_read_as_the_reference():
    from distributed_machine_learning_tpu.parallel import pipeline as jpp
    from distributed_machine_learning_tpu.parallel import pipeline_interleaved as jppi
    from distributed_machine_learning_tpu.runtime.mesh import make_mesh
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    mesh = make_mesh(3, ("pipe",))
    for shape, extra in ((dict(MODEL, attn_impl="ring"), {}), (MODEL, {}),
                         (dict(MODEL, n_layers=6), {"v": 3})):
        with pytest.raises(ValueError) as want:
            if "v" in extra:
                jppi.make_pp_interleaved_lm_train_step(
                    _ref_model().clone(**{k: v for k, v in shape.items() if k != "vocab_size"}),
                    mesh, 2, extra["v"])
            else:
                jpp.make_pp_lm_train_step(_ref_model().clone(attn_impl=shape.get(
                    "attn_impl", "dense")), mesh, 2)
        model = TransformerLM(**shape, device="cpu")
        with pytest.raises(ValueError) as got:
            if "v" in extra:
                ppi.make_pp_interleaved_lm_train_step(model, Comm(0, 3), 2, extra["v"])
            else:
                pp.make_pp_lm_train_step(model, Comm(0, 3), 2)
        assert str(got.value) == str(want.value)
    for flags, match in (
            (["--pp-schedule", "1f1b", "--pp-chunks", "2"],
             "--pp-chunks applies to --parallel pp with --pp-schedule interleaved only "
             "\\(got --parallel pp, --pp-schedule 1f1b\\)"),
            (["--overlap-update"], "--overlap-update applies to --parallel fsdp \\(prefetch "
                                   "protocol\\) or --parallel pp --pp-schedule gpipe"),
            (["--optimizer", "lars"], "LARS is not supported under pipeline/3-D parallelism"),
            (["--fused-ce-chunks", "2"], "--fused-ce-chunks applies to the dp/ring/ulysses/"
                                         "fsdp/fsdp_pl steps only"),
            (["--guard-nonfinite"], "--guard-nonfinite/--loss-scale apply to the replicated "
                                    "dp/ring/ulysses steps only \\(got --parallel pp\\)")):
        with pytest.raises(ValueError, match=match):
            cli_lm.main([*FLAGS, *flags])
    with pytest.raises(ValueError, match="batch 4 not divisible by num_microbatches=3"):
        pp.microbatch(torch.zeros(4, 2), torch.zeros(4, 2), 3)


def test_cli_runs_one_stage(capsys):
    cli_lm.main([*FLAGS, "--attn", "flash", "--fused-update", "--max-iters", "2",
                 "--eval-batches", "1"])
    out = capsys.readouterr().out
    assert ("lm parallel=pp devices=1 (cpu)" in out
            and "attn=flash mesh=pipe1 schedule=1f1b microbatches=4" in out)
    assert "Eval: nll/token " in out
