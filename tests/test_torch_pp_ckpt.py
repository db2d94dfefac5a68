"""Checkpoints of the model-parallel schemes: ``cli.lm --parallel pp/tp
--ckpt-dir/--resume`` and ``cli.generate --ckpt-dir`` on pipeline layouts,
vs themselves and the JAX package.

In 2 gloo ranks (d64 / 4-layer / 4-head / 2-KV-head / vocab-96, B 4 × L 64,
f32): ``cli.lm``'s run under ``--parallel pp`` (1F1B) saves after 2 steps
and ``--resume`` trains 2 more, bit for bit the uninterrupted 4 steps over
the same batches; an interleaved run's checkpoint carries its tag and a
1F1B run refuses to resume from it (and it from the contiguous one), in
the reference's words; a ``--parallel tp`` run's checkpoint is a dp run's
files (every leaf whole, no layout tag), which a one-process dp run
restores.  ``cli.generate --ckpt-dir`` on a contiguous and on an
interleaved checkpoint prints the text JAX's ``cli.generate`` prints from
its own checkpoint of the same stacked weights (each stacked row converted
to the port's names): the unstacking orders agree.
"""

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.train import checkpoint as ck

WORLD = 2
FLAGS = ["--device", "cpu", "--d-model", "64", "--n-layers", "4", "--n-heads", "4",
         "--n-kv-heads", "2", "--vocab", "96", "--seq-len", "64", "--batch-size", "4",
         "--microbatches", "2", "--max-iters", "2"]


def _args(*extra):
    return cli_lm.make_parser().parse_args([*FLAGS, "--num-nodes", str(WORLD), *extra])


def _ckpt_rank(rank, world, init_method, root):
    """An uninterrupted 2 + 2 steps of 1F1B over the stream's first two
    batches twice (what a resumed process sees), then cli.lm's run with
    --ckpt-dir for 2 and --resume for 2; an interleaved save and the two
    wrong-layout resumes; a tp save."""
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.loop import train_epoch

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        r = ("--rank", str(rank))
        pp = (*r, "--parallel", "pp", "--ckpt-dir", f"{root}/1f1b")
        args = _args(*pp)
        step, state, place, _ = cli_lm.build(args, ctx)
        for _ in range(2):
            state, _ = train_epoch(step, state, cli_lm.synthetic_batches(args),
                                   place_batch=place, max_iters=2)
        want = {k: v.numpy() for k, v in step.params_fn(state).items()}
        cli_lm.run(args, ctx)
        resumed_args = _args(*pp, "--resume")
        resumed = cli_lm.run(resumed_args, ctx)
        rstep = cli_lm.build(resumed_args, ctx)[0]
        got = {k: v.numpy() for k, v in rstep.params_fn(resumed).items()}
        inter = (*r, "--parallel", "pp", "--pp-schedule", "interleaved", "--pp-chunks", "2")
        cli_lm.run(_args(*inter, "--ckpt-dir", f"{root}/inter"), ctx)
        refusals = []
        for flags in ((*pp[:-1], f"{root}/inter"), (*inter, "--ckpt-dir", f"{root}/1f1b")):
            try:
                cli_lm.run(_args(*flags, "--resume"), ctx)
            except ValueError as exc:
                refusals.append(str(exc))
        tp = cli_lm.run(_args(*r, "--parallel", "tp", "--ckpt-dir", f"{root}/tp"), ctx)
        tp_step = cli_lm.build(_args(*r, "--parallel", "tp"), ctx)[0]
        tp_params = {k: v.numpy() for k, v in tp_step.params_fn(tp).items()}
        return want, got, resumed.step, refusals, tp_params
    finally:
        ctx.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    root = tmp_path_factory.mktemp("pp_ckpt")
    return root, spawn(_ckpt_rank, WORLD, (str(root),), timeout_s=300)


def test_pp_save_resume_is_bit_for_bit(ranks):
    root, outs = ranks
    for want, got, steps, _, _ in outs:
        assert steps == 4 and got.keys() == want.keys()
        for k, v in want.items():
            assert np.array_equal(got[k].view(np.uint32), v.view(np.uint32)), k
    latest = ck.latest_checkpoint(root / "1f1b")
    assert latest.endswith("step_4") and ck.checkpoint_layout(latest) == "pp-contiguous"
    stacked = ck.restore_checkpoint(latest).params
    assert stacked["blocks.attn.q.weight"].shape == (4, 64, 64)  # [n_layers, H·D, E]


def test_wrong_layout_resume_refuses(ranks):
    root, outs = ranks
    assert ck.checkpoint_layout(ck.latest_checkpoint(root / "inter")) == "pp-interleaved-P2-v2"
    for refusals in (o[3] for o in outs):
        assert refusals == [
            "checkpoint parameter layout 'pp-interleaved-P2-v2' does not match this run's "
            "'pp-contiguous' (same tree structure, permuted layers — resume with the "
            "schedule/chunks/device-count it was saved under)",
            "checkpoint parameter layout 'pp-contiguous' does not match this run's "
            "'pp-interleaved-P2-v2' (same tree structure, permuted layers — resume with "
            "the schedule/chunks/device-count it was saved under)"]


def test_tp_checkpoint_restores_in_the_dp_layout(ranks, capsys):
    root, outs = ranks
    latest = ck.latest_checkpoint(root / "tp")
    assert ck.checkpoint_layout(latest) is None
    host = ck.restore_checkpoint(latest)
    for k, v in outs[0][4].items():
        assert np.array_equal(host.params[k].numpy().view(np.uint32), v.view(np.uint32)), k
    cli_lm.main([*FLAGS, "--resume", "--ckpt-dir", str(root / "tp")])
    assert f"Resumed from {latest} (step 2)" in capsys.readouterr().out


def _jax_stacked_ckpt(directory, v):
    """A JAX checkpoint of seeded weights in a pipeline layout (contiguous at
    v 1, interleaved P 2 otherwise), and the same stacked rows as a port
    checkpoint under the same tag."""
    import jax

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.parallel import pipeline as jpp
    from distributed_machine_learning_tpu.parallel import pipeline_interleaved as jppi
    from distributed_machine_learning_tpu.train import checkpoint as jck
    from distributed_machine_learning_tpu.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig as PortAdamW

    model = RefLM(vocab_size=257, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2)
    if v == 1:
        state, tag = jpp.init_pipeline_state(model, seed=9, config=AdamWConfig()), \
            "pp-contiguous"
    else:
        state = jppi.init_interleaved_state(model, WORLD, v, seed=9, config=AdamWConfig())
        tag = jppi.interleaved_layout_tag(WORLD, v)
    jck.save_checkpoint(directory / "jax", state, layout=tag)
    stacked = jax.device_get(state.params)
    rows = []
    for j in range(4):
        tree = {k: t for k, t in stacked.items() if k != "blocks"}
        tree["block_0"] = jax.tree_util.tree_map(lambda x, j=j: x[j], stacked["blocks"])
        rows.append(flax_to_state_dict(tree))
    params = {}
    for name, t in rows[0].items():
        if name.startswith("blocks.0."):
            params["blocks." + name[len("blocks.0."):]] = torch.stack(
                [row[name] for row in rows])
        else:
            params[name] = t
    ck.save_checkpoint(directory / "port", ck.HostState(params=params, momentum={},
                                                        batch_stats={}, step=0,
                                                        config=PortAdamW()), layout=tag)


@pytest.mark.parametrize("v", [1, 2], ids=["contiguous", "interleaved"])
def test_generate_from_pipeline_checkpoint_matches_jax(tmp_path, capsys, v):
    from distributed_machine_learning_tpu.cli import generate as jgen
    from distributed_machine_learning_tpu_torch.cli import generate as pgen

    _jax_stacked_ckpt(tmp_path, v)
    flags = ["--prompt", "Hello ", "--max-new-tokens", "12", "--temperature", "0",
             "--compute-dtype", "float32", "--d-model", "64", "--n-layers", "4",
             "--n-heads", "4", "--n-kv-heads", "2"]
    jgen.main(["--ckpt-dir", str(tmp_path / "jax"), *flags])
    want = capsys.readouterr().out.splitlines()
    tokens = pgen.main(["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu", *flags])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == f"restored {tmp_path / 'port' / 'step_0'}"
    assert len(tokens) == 12 and got[-1] == want[-1]
