"""``cli.distill``, the port vs the JAX package, on the CPU.

The distillation step (the T²-scaled soft cross-entropy against the frozen
teacher plus ``ce_weight`` × the hard CE, one AdamW update of the student)
against JAX's ``make_distill_step`` on converted weights and the same
tokens; that it learns the teacher; the CLI from a port ``cli.lm``
checkpoint to a draft that ``cli.generate --draft-ckpt-dir`` serves with
the plain greedy stream's tokens; the guard.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.cli.distill import (
    make_distill_step as ref_make_distill_step,
)
from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
from distributed_machine_learning_tpu.train.adamw import AdamWConfig as RefAdamWConfig
from distributed_machine_learning_tpu.train.lm_step import init_lm_state as ref_init
from distributed_machine_learning_tpu_torch.cli.distill import make_distill_step
from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
from distributed_machine_learning_tpu_torch.train.state import TrainState

# f32 on both sides, summed in other orders: losses to 1e-5 relative; a
# first AdamW step moves each weight by ~lr·sign(g), so updated weights
# agree to ~1e-7, and 2e-5 sits far below a flipped near-zero gradient's
# 2·lr (tests/test_torch_lm_train.py's limits).
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
TEACHER = dict(vocab_size=32, d_model=32, n_layers=2, n_heads=4)
STUDENT = dict(vocab_size=32, d_model=16, n_layers=1, n_heads=2)


def _twin(shape, params):
    model = TransformerLM(**shape, device="cpu")
    model.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    return model


def test_distill_step_matches_reference():
    T, kd_w, ce_w = 2.0, 1.0, 0.5
    teacher, student = RefLM(**TEACHER), RefLM(**STUDENT)
    tparams = ref_init(teacher).params
    state = ref_init(student, seed=3, config=RefAdamWConfig())  # cli.distill's optimizer
    block = np.random.default_rng(0).integers(0, 32, (4, 17))
    x, y = block[:, :-1], block[:, 1:]
    port_student = _twin(STUDENT, state.params)
    port_state = TrainState.create(port_student)
    port_step = make_distill_step(port_student, _twin(TEACHER, tparams), kd_w, ce_w, T)
    ref_step = ref_make_distill_step(student, teacher, kd_w, ce_w, T)
    for _ in range(2):
        state, want = ref_step(state, tparams, jnp.asarray(x, jnp.int32),
                               jnp.asarray(y, jnp.int32))
        port_state, got = port_step(port_state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want],
                                   rtol=LOSS_RTOL)
    assert port_state.step == 2
    new = port_student.state_dict()
    for name, want in flax_to_state_dict(jax.device_get(state.params)).items():
        np.testing.assert_allclose(new[name].numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_distill_step_learns_teacher():
    """The KD soft CE is bounded below by the teacher's own softened
    entropy, so the learnable part is the gap above it: overfitting one
    batch for 150 steps must shrink it below 0.3 of its start.  The JAX
    test's experiment: its teacher and student weights (converted), its
    batch shape, its criterion and its optimizer (``init_lm_state``'s
    default there, SGD with momentum at the reference's settings)."""
    T = 2.0
    teacher = _twin(TEACHER, ref_init(RefLM(**TEACHER)).params)
    student = _twin(STUDENT, ref_init(RefLM(**STUDENT), seed=3).params)
    state = TrainState.create(student, SGDConfig())
    step = make_distill_step(student, teacher, kd_weight=1.0, ce_weight=0.0,
                             kd_temperature=T)
    block = torch.from_numpy(np.random.default_rng(1).integers(0, 32, (8, 17)))
    x, y = block[:, :-1], block[:, 1:]
    with torch.no_grad():
        t_logp = torch.log_softmax(teacher(x).float() / T, dim=-1)
    floor = float(-(t_logp.exp() * t_logp).sum(-1).mean()) * T * T
    gap0 = None
    for i in range(150):
        state, (_, kd, _) = step(state, x, y)
        if i == 0:
            gap0 = float(kd) - floor
    gap = float(kd) - floor
    assert gap0 > 0 and gap < 0.3 * gap0, (gap, gap0, floor)


def test_distill_cli_end_to_end(tmp_path, capsys):
    """A port ``cli.lm`` target, ``cli.distill`` from its checkpoint, then
    ``cli.generate --draft-ckpt-dir --spec-gamma`` prints the plain greedy
    command's text."""
    from distributed_machine_learning_tpu_torch.cli.distill import main as distill_main
    from distributed_machine_learning_tpu_torch.cli.generate import main as generate_main
    from distributed_machine_learning_tpu_torch.cli.lm import main as lm_main

    target = ["--device", "cpu", "--d-model", "32", "--n-layers", "2", "--n-heads", "4",
              "--vocab", "64"]
    draft = ["--draft-d-model", "16", "--draft-n-layers", "1", "--draft-n-heads", "2"]
    tdir, ddir = str(tmp_path / "target"), str(tmp_path / "draft")
    lm_main(target + ["--seq-len", "16", "--batch-size", "8", "--max-iters", "4",
                      "--ckpt-dir", tdir])
    capsys.readouterr()
    path = distill_main(target + draft + [
        "--seq-len", "16", "--batch-size", "8", "--target-ckpt-dir", tdir,
        "--ckpt-dir", ddir, "--max-iters", "6", "--compute-dtype", "float32"])
    out = capsys.readouterr().out
    assert f"draft checkpoint: {path}" in out and "iter 0: loss" in out
    assert "distill: teacher d32x2L -> draft d16x1L" in out
    serve = target + ["--ckpt-dir", tdir, "--max-new-tokens", "8", "--temperature", "0",
                      "--prompt", "ab", "--compute-dtype", "float32"]
    spec = generate_main(serve + draft + ["--draft-ckpt-dir", ddir, "--spec-gamma", "2"])
    spec_out = capsys.readouterr().out
    assert f"restored {path}" in spec_out
    plain = generate_main(serve)
    plain_out = capsys.readouterr().out
    assert spec == plain
    assert spec_out.splitlines()[-1] == plain_out.splitlines()[-1]


def test_distill_guards():
    t = TransformerLM(**STUDENT, device="cpu")
    with pytest.raises(ValueError, match="kd_temperature"):
        make_distill_step(t, t, 1.0, 0.5, kd_temperature=0.0)
    from distributed_machine_learning_tpu_torch.cli.distill import main as distill_main

    with pytest.raises(RuntimeError, match="no CUDA device"):  # no quiet CPU fallback
        distill_main(["--target-ckpt-dir", "x", "--ckpt-dir", "y"])


def test_a8_modules_import_no_jax():
    """cli.distill and the A8 modules the serving CLI reaches import neither
    jax nor the JAX package."""
    mods = ("cli.distill", "cli.generate", "inference.speculative", "models.moe",
            "ops.grouped", "parallel.tensor_parallel")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('distributed_machine_learning_tpu_torch.' + m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax'))"
            " or m.split('.')[0] == 'distributed_machine_learning_tpu']\n"
            "assert not bad, bad\n")
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(repo)})
    assert res.returncode == 0, res.stderr
