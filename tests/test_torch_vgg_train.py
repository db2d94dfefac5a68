"""The port's VGG training path against the JAX package's, and its CLIs.

Both sides start from the same Flax-initialized VGGTEST weights (converted)
and take the same numpy batches with augmentation off (the two frameworks
cannot draw the same crops).  Multi-rank runs spawn their ranks once (gloo,
CPU) and run every strategy inside them; JAX runs the same strategies on a
mesh of 2 virtual devices fed the rank-major global batch.

Tolerances: losses and parameters after 3 steps within 1e-5 relative (f32;
the two sides' convolutions sum in another order, ~1e-7 read).  The int8
ring is bitwise against JAX only on identical inputs
(``tests/test_torch_ring.py``); here the gradients come from two conv
implementations and the port ravels them in its own parameter order and
layout (OIHW, module order), so every element falls into another chunk
with another scale and rounds differently.  The two int8 runs may then
differ by what the compression itself moves: per leaf, max |port − JAX|
after 3 steps within twice max |JAX int8 − JAX uncompressed| (read: at
most 1.3×), losses within 2e-3 relative (read 1.1e-3).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch import convert
from distributed_machine_learning_tpu_torch.cli import common as tcommon
from distributed_machine_learning_tpu_torch.cli import part1 as tpart1
from distributed_machine_learning_tpu_torch.cli import part3 as tpart3

WORLD, PER_RANK, STEPS = 2, 8, 3
# (name, strategy, strategy kwargs, use_bn): parts 2a, 2b, 3 (none, int8 with
# EF through the kernels' entry points), and a BN-free ring for the mean
# equality.
CONFIGS = [
    ("part2a", "gather_scatter", {}, False),
    ("part2b", "all_reduce", {}, False),
    ("part3", "ring", {}, True),
    ("part3_int8", "ring", {"compress": "int8", "codec_impl": "pallas"}, True),
    ("ring_nobn", "ring", {}, False),
]
TOL = 1e-5
INT8_LOSS_TOL = 2e-3


def _batches(seed=0, n=STEPS, size=WORLD * PER_RANK):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (size, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, size).astype(np.int32)) for _ in range(n)]


def _port_model(variables, use_bn):
    from distributed_machine_learning_tpu_torch.models.vgg import VGG
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = VGG("VGGTEST", use_bn=use_bn)
    model.load_state_dict(convert.flax_vgg_to_state_dict(
        variables["params"], variables.get("batch_stats")))
    return model, TrainState.create(model, SGDConfig())


def _run_port(model, state, step, batches, rank=0, world=1):
    losses, first = [], {}
    step.observe = lambda g, r: first.setdefault("grads", [t.clone() for t in g])
    for images, labels in batches:
        lo, hi = rank * PER_RANK, (rank + 1) * PER_RANK
        x, y = (images, labels) if world == 1 else (images[lo:hi], labels[lo:hi])
        state, loss = step(state, torch.from_numpy(x), torch.from_numpy(y).long())
        losses.append(float(loss))
    stats = [t.numpy().copy() for t in state.batch_stats.values()]
    return {"losses": losses, "params": convert.flax_vgg_tree(state.params),
            "grads0": [g.numpy() for g in first["grads"]], "stats": stats}


def _train_rank(rank, world, init_method, variables, batches):
    from distributed_machine_learning_tpu_torch.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    torch.set_num_threads(1)
    ctx = initialize_from_flags(rank=rank, num_nodes=world, device="cpu",
                                init_method=init_method, timeout_s=120)
    try:
        out = {}
        for name, strategy, kwargs, use_bn in CONFIGS:
            model, state = _port_model(variables[use_bn], use_bn)
            step = make_train_step(model, get_strategy(strategy, **kwargs), ctx.comm,
                                   augment=False)
            out[name] = _run_port(model, state, step, batches, rank, world)
        return out
    finally:
        ctx.shutdown()


def _jax_run(use_bn, batches, strategy=None, mesh=None):
    import jax

    from distributed_machine_learning_tpu.cli.common import init_model_and_state
    from distributed_machine_learning_tpu.models.vgg import VGG
    from distributed_machine_learning_tpu.train.step import make_train_step, shard_batch

    model = VGG(name_cfg="VGGTEST", use_bn=use_bn)
    state = init_model_and_state(model)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = make_train_step(model, strategy, mesh=mesh, augment=False)
    losses = []
    for images, labels in batches:
        if mesh is not None:
            images, labels = shard_batch(mesh, images, labels)
        state, loss = step(state, images, labels)
        losses.append(float(loss))
    return variables, losses, jax.device_get(state.params), jax.device_get(state.batch_stats)


def _close_tree(got, want, tol, what):
    for k in want:
        for leaf in want[k]:
            a, b = np.asarray(got[k][leaf]), np.asarray(want[k][leaf])
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= tol, f"{what} {k}/{leaf}: relative error {err:.3e} > {tol}"


def test_part1_three_steps_vs_jax():
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    batches = _batches()
    variables, jlosses, jparams, _ = _jax_run(False, batches)
    model, state = _port_model(variables, False)
    step = make_train_step(model, augment=False)
    got = _run_port(model, state, step, batches)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=TOL)
    _close_tree(got["params"], jparams, TOL, "part1")


def test_parts_at_world_2_vs_jax_and_reference_equalities():
    import jax
    from jax.sharding import Mesh

    from distributed_machine_learning_tpu.parallel.strategies import get_strategy
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn
    from distributed_machine_learning_tpu_torch.train.step import make_train_step

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("batch",))
    batches = _batches(1)
    variables = {bn: _jax_run(bn, [])[0] for bn in (False, True)}
    ranks = spawn(_train_rank, WORLD, (variables, batches), timeout_s=300)
    jax_params = {}
    for name, strategy, kwargs, use_bn in CONFIGS:
        if name == "ring_nobn":
            continue
        _, jlosses, jparams, jstats = _jax_run(use_bn, batches,
                                               get_strategy(strategy, **kwargs), mesh)
        jax_params[name] = jparams
        for r in range(WORLD):
            got = ranks[r][name]
            if name == "part3_int8":
                np.testing.assert_allclose(got["losses"], jlosses, rtol=INT8_LOSS_TOL)
                for k, leaves in jparams.items():
                    for leaf, want in leaves.items():
                        moved = np.abs(want - jax_params["part3"][k][leaf]).max()
                        err = np.abs(got["params"][k][leaf] - want).max()
                        assert err <= 2 * moved + 1e-6, f"int8 {k}/{leaf}: {err} vs {moved}"
                continue
            np.testing.assert_allclose(got["losses"], jlosses, rtol=TOL, err_msg=name)
            _close_tree(got["params"], jparams, TOL, f"{name} rank {r}")
            want_stats = [np.asarray(jstats[f"BatchNorm_{i}"][s])
                          for i in range(len(jstats)) for s in ("mean", "var")]
            for a, b in zip(got["stats"], want_stats):
                np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-6, err_msg=name)
        # Replication: every rank ends with identical parameters.
        for k, leaves in ranks[0][name]["params"].items():
            for leaf, a in leaves.items():
                np.testing.assert_array_equal(a, ranks[1][name]["params"][k][leaf])
    # The reference's equalities on one global batch, BN-free: part2b's SUM
    # is W x part1's gradient, the ring's mean is part1's gradient.
    model, state = _port_model(variables[False], False)
    step = make_train_step(model, augment=False)
    part1 = _run_port(model, state, step, batches[:1])["grads0"]
    for r in range(WORLD):
        for got_sum, got_mean, want in zip(ranks[r]["part2b"]["grads0"],
                                           ranks[r]["ring_nobn"]["grads0"], part1):
            scale = np.abs(want).max()
            assert np.abs(got_sum - WORLD * want).max() <= 1e-5 * WORLD * scale
            assert np.abs(got_mean - want).max() <= 1e-5 * scale


def test_cli_part1_protocol_lines(capsys):
    tpart1.main(["--device", "cpu", "--model", "vggtest", "--batch-size", "4",
                 "--max-iters", "21", "--eval-batches", "2", "--eval-batch-size", "16"])
    out = capsys.readouterr().out
    assert "strategy=none world_size=1 backend=none wire=none devices=cpu" in out
    assert "Loss at 20th batch is " in out and "Total params" in out
    assert "Total execution time is : " in out and "Average execution time is  : " in out
    assert "Test set: Average loss: " in out


def test_cli_part3_int8_two_processes():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "distributed_machine_learning_tpu_torch.cli.part3",
           "--device", "cpu", "--model", "vggtest", "--num-nodes", "2",
           "--master-ip", f"127.0.0.1:{port}", "--ring-compress", "int8",
           "--ring-codec-impl", "pallas", "--batch-size", "4", "--max-iters", "21",
           "--eval-batches", "1", "--eval-batch-size", "16"]
    procs = [subprocess.Popen([*cmd, "--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "strategy=ring world_size=2 backend=gloo wire=gloo devices=cpu" in outs[0]
    for line in ("Loss at 20th batch is ", "Total execution time is : ",
                 "Average execution time is  : ", "Test set: Average loss: "):
        assert line in outs[0] and line not in outs[1]


def test_cli_refusals():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpart1.main(["--max-iters", "1"])
    for flags, item in ((["--faults", "nan@1"], "A6"), (["--telemetry-dir", "x"], "A6"),
                        (["--trace-dir", "x"], "A6"), (["--metrics-file", "x"], "A6"),
                        (["--gang-dir", "x"], "A6"), (["--watchdog-timeout", "5"], "A6"),
                        (["--ring-topology", "2x1"], "A5c")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            tpart3.main(["--device", "cpu", *flags])
    # The strategy itself, past the CLI's refusal, names the same item.
    from distributed_machine_learning_tpu_torch.parallel.strategies import RingAllReduce

    with pytest.raises(NotImplementedError, match="ROADMAP A5c "):
        RingAllReduce(topology="2x1")
    with pytest.raises(ValueError, match="single-process"):
        tcommon.run_part("none", 4, False, tcommon.parse_flags(
            tcommon.make_flag_parser(""), ["--device", "cpu", "--num-nodes", "2"]))


def test_vgg_path_imports_no_jax():
    code = ("import sys\n"
            "for m in ('cli.part1', 'cli.part2a', 'cli.part2b', 'cli.part3', 'ops.ring',\n"
            "          'parallel.strategies', 'train.step', 'runtime.launch', 'cli.parity',\n"
            "          'models.resnet', 'models.registry', 'train.lars', 'data.retry',\n"
            "          'data.native_loader'):\n"
            "    __import__('distributed_machine_learning_tpu_torch.' + m)\n"
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('distributed_machine_learning_tpu.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
