"""LARS, SGD's narrowed momentum and the learning-rate schedules against the
JAX package (``train/lars.py``, ``train/sgd.py``, ``train/schedule.py``,
``cli/common.make_schedule``), on the same seeded numpy inputs."""

from __future__ import annotations

import argparse

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.cli import common as tcommon
from distributed_machine_learning_tpu_torch.train import schedule as tsched
from distributed_machine_learning_tpu_torch.train.lars import LARSConfig, lars_update
from distributed_machine_learning_tpu_torch.train.optimizers import (
    config_class_by_name,
    get_optimizer,
    init_for_config,
)
from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig, sgd_update


def _leaves(seed: int) -> dict:
    """Params, buffers and gradients by name; ``zero_bias`` is all zeros
    (LARS's plain-lr fallback) and ``zero_grad`` has a zero gradient."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "zero_bias": (5,), "zero_grad": (4,), "v": (3, 2, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    p["zero_bias"][:] = 0
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g["zero_grad"][:] = 0
    m = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    return {"p": p, "g": g, "m": m}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("lr", [None, 0.37])
def test_lars_update_vs_jax_with_zero_norm_leaves(lr):
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.train.lars import LARSConfig as JLARS
    from distributed_machine_learning_tpu.train.lars import lars_update as jlars

    d = _leaves(0)
    cfg = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4, trust_coefficient=1e-3)
    for _ in range(2):  # two steps: the buffer carries the scaled step
        jp, jm = jlars({k: jnp.asarray(v) for k, v in d["p"].items()},
                       {k: jnp.asarray(v) for k, v in d["m"].items()},
                       {k: jnp.asarray(v) for k, v in d["g"].items()}, JLARS(**cfg), lr=lr)
        p, m = _t(d["p"]), _t(d["m"])
        lars_update(p, m, _t(d["g"]), LARSConfig(**cfg), lr=lr)
        # f32 norms and elementwise ops in either order of summation: 1 ulp-scale.
        for k in d["p"]:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-6, atol=1e-7)
        d["p"] = {k: np.asarray(v) for k, v in jp.items()}
        d["m"] = {k: np.asarray(v) for k, v in jm.items()}
    # The zero-norm leaves took the plain lr (trust applies to the ratio only).
    zb = LARSConfig(**cfg)
    p0, g0 = _leaves(0)["p"]["zero_bias"], _leaves(0)["g"]["zero_bias"]
    p, m = _t({"b": p0}), _t({"b": np.zeros_like(p0)})
    lars_update(p, m, _t({"b": g0}), zb)
    np.testing.assert_allclose(m["b"].numpy(), 0.1 * g0, rtol=1e-6)


def test_lars_config_refuses_narrow_momentum_and_registers():
    import distributed_machine_learning_tpu.train.lars as jl

    with pytest.raises(ValueError) as port:
        LARSConfig(momentum_dtype="bfloat16")
    with pytest.raises(ValueError) as ref:
        jl.LARSConfig(momentum_dtype="bfloat16")
    assert str(port.value) == str(ref.value)
    assert get_optimizer("lars")[0] is LARSConfig
    assert config_class_by_name("LARSConfig") is LARSConfig  # a LARS checkpoint resolves
    bufs = init_for_config(LARSConfig())({"w": torch.ones(3)})
    assert bufs["w"].dtype == torch.float32 and not bufs["w"].any()
    with pytest.raises(TypeError, match="LARSConfig"):
        lars_update({"w": torch.ones(2)}, {"w": torch.zeros(2)}, {"w": torch.ones(2)},
                    SGDConfig())


def test_sgd_bf16_momentum_vs_jax():
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.train.sgd import SGDConfig as JSGD
    from distributed_machine_learning_tpu.train.sgd import sgd_init as jinit
    from distributed_machine_learning_tpu.train.sgd import sgd_update as jsgd

    d = _leaves(1)
    jp = {k: jnp.asarray(v) for k, v in d["p"].items()}
    jm = jinit(jp, JSGD(momentum_dtype="bfloat16"))
    cfg = SGDConfig(momentum_dtype="bfloat16")
    p = _t(d["p"])
    m = init_for_config(cfg)(p)
    assert all(t.dtype == torch.bfloat16 for t in m.values())
    for step in range(3):
        g = {k: v * (step + 1) for k, v in d["g"].items()}
        jp, jm = jsgd(jp, jm, {k: jnp.asarray(v) for k, v in g.items()},
                      JSGD(momentum_dtype="bfloat16"), lr=0.05)
        sgd_update(p, m, _t(g), cfg, lr=0.05)
        for k in d["p"]:
            # f32 math, the carried buffer rounded to bf16 each step: the
            # same rounding on the same f32 value -> equal buffers; params
            # to f32 ulps.
            np.testing.assert_array_equal(
                m[k].float().numpy(), np.asarray(jm[k].astype(jnp.float32)))
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def _schedule_args(**kw) -> argparse.Namespace:
    base = dict(max_iters=40, epochs=1, lr_schedule="cosine", warmup_steps=4)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kind,start", [("cosine", 0), ("cosine", 25), ("step", 0),
                                        ("step", 17), ("constant", 0)])
def test_make_schedule_vs_jax(kind, start):
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.cli.common import make_schedule as jmake

    args = _schedule_args(lr_schedule=kind)
    ours, ref = tcommon.make_schedule(args, 0.1, start), jmake(args, 0.1, start)
    if kind == "constant":
        assert ours is None and ref is None
        return
    steps = range(start, start + 45)
    got = np.array([ours(s) for s in steps], np.float32)
    want = np.array([float(ref(jnp.int32(s))) for s in steps], np.float32)
    # numpy f32 vs XLA f32 (cos may differ by an ulp): rtol 1e-6.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_schedule_functions_vs_jax():
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.train import schedule as jsched

    cases = [(tsched.warmup_cosine(0.3, 7, 50, end_lr=0.01),
              jsched.warmup_cosine(0.3, 7, 50, end_lr=0.01)),
             (tsched.warmup_cosine(0.1, 0, 20), jsched.warmup_cosine(0.1, 0, 20)),
             (tsched.step_decay(0.2, (10, 30, 35), gamma=0.5),
              jsched.step_decay(0.2, (10, 30, 35), gamma=0.5)),
             (tsched.constant(0.1), jsched.constant(0.1))]
    for ours, ref in cases:
        got = np.array([ours(s) for s in range(60)], np.float32)
        want = np.array([float(ref(jnp.int32(s))) for s in range(60)], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="must exceed"):
        tsched.warmup_cosine(0.1, 5, 5)


@pytest.mark.parametrize("flags,msg", [
    (["--warmup-steps", "-1"], "--warmup-steps must be >= 0"),
    (["--lr-schedule", "cosine", "--warmup-steps", "40"], "must be shorter than the run"),
    (["--grad-accum", "0"], "--grad-accum must be >= 1"),
    (["--keep-last-n", "0"], "--keep-last-n must be >= 1"),
    (["--resume"], "--resume requires --ckpt-dir"),
    (["--loader-retries", "-1"], "--loader-retries must be >= 0"),
    (["--max-restarts", "-1"], "--max-restarts must be >= 0"),
])
def test_parse_time_checks_match_jax(flags, msg, capsys):
    from distributed_machine_learning_tpu.cli import common as jcommon

    errors = []
    for mod in (tcommon, jcommon):
        with pytest.raises(SystemExit):
            mod.parse_flags(mod.make_flag_parser("x"), flags)
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert msg in errors[0] and errors[0] == errors[1]
