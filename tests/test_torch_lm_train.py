"""The port's LM trainer (train/*, cli/lm.py) vs the JAX package, end to end.

A d64 / 2-layer / 4-head / 2-KV-head / vocab-97 model at L 128, f32: the
reference initializes it (``init_lm_state(seed=69143)``), the weights are
converted with ``convert.flax_to_state_dict`` into the port, and the same
numpy token batches go through the reference's ``make_lm_train_step`` (no
mesh; flash runs its Pallas kernels in interpret mode, ``fused=True`` the
Pallas AdamW) and the port's step (on CPU tensors: the plain versions of
K1-K3 and K7).
"""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
from distributed_machine_learning_tpu.train.adamw import AdamWConfig as RefAdamW
from distributed_machine_learning_tpu.train.lm_step import init_lm_state as ref_init
from distributed_machine_learning_tpu.train.lm_step import make_lm_eval_step as ref_eval
from distributed_machine_learning_tpu.train.lm_step import (
    make_lm_train_step as ref_step_fn,
)
from distributed_machine_learning_tpu_torch.cli import lm as cli_lm
from distributed_machine_learning_tpu_torch.convert import (
    flax_adamw_state,
    flax_to_state_dict,
)
from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
from distributed_machine_learning_tpu_torch.train.lm_step import (
    init_lm_state,
    make_lm_eval_step,
    make_lm_train_step,
    with_dynamic_scale,
)
from distributed_machine_learning_tpu_torch.train.state import TrainState

MODEL = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2)
BATCH, SEQ, STEPS = 2, 128, 3
# f32 on both sides; the losses agree to summation-order noise (~1e-7
# relative).  After 3 AdamW steps (lr 3e-4, first from zero moments, where
# the update is ~lr·sign(g)) the parameters agree to ~1e-7 absolute; a
# flipped sign of a near-zero gradient would move one element by 2·lr, so
# the bound sits well below that.
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5


def _batches(n=STEPS, seed=69143):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        block = cli_lm.synthetic_tokens(rng, BATCH, SEQ, MODEL["vocab_size"])
        out.append((block[:, :-1], block[:, 1:]))
    return out


def _port_model(attn, params=None, **kw):
    model = TransformerLM(**MODEL, attn_impl=attn, device="cpu", **kw)
    if params is not None:
        model.load_state_dict(flax_to_state_dict(params))
    return model


_REF = {}


def _reference_run(attn, fused):
    """The JAX trajectory (initial params, per-step losses, final state),
    computed once per (attn, fused)."""
    if (attn, fused) not in _REF:
        model = RefLM(**MODEL, attn_impl=attn)
        state = ref_init(model, seed=69143, config=RefAdamW(fused=fused))
        init = jax.device_get(state.params)
        step = ref_step_fn(model)
        losses = []
        for x, y in _batches():
            state, loss = step(state, x, y)
            losses.append(float(loss))
        _REF[attn, fused] = (init, losses, jax.device_get(state.params),
                             jax.device_get(state.momentum))
    return _REF[attn, fused]


def _port_run(model, fused, guard=False, steps=STEPS):
    state = TrainState.create(model, AdamWConfig(fused=fused))
    step = make_lm_train_step(model, guard_nonfinite=guard)
    losses = []
    for x, y in _batches(steps):
        state, loss = step(state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        losses.append(float(loss))
    return state, losses


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_three_steps_match_reference(attn, fused):
    """Per-step losses and the final parameters and moments after 3 steps."""
    init, want_losses, want_params, want_moments = _reference_run(attn, fused)
    state, losses = _port_run(_port_model(attn, init), fused)
    assert state.step == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    got = state.model.state_dict()
    for name, want in flax_to_state_dict(want_params).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
    want_nu = flax_adamw_state(want_moments)["nu"]
    for name, want in want_nu.items():
        np.testing.assert_allclose(state.momentum["nu"][name].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-12, err_msg=name)


def test_adamw_state_converts_like_params():
    """``flax_adamw_state`` maps the moment trees with the parameter map:
    same keys and shapes as the port's parameters."""
    init, _, _, moments = _reference_run("dense", False)
    conv = flax_adamw_state(moments)
    model = _port_model("dense", init)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    for which in ("mu", "nu"):
        assert {k: tuple(v.shape) for k, v in conv[which].items()} == shapes


@pytest.mark.parametrize("policy", ["mlp", "block"])
def test_remat_gives_the_same_losses(policy):
    """Recomputing the MLP sub-layer (or the whole block) in the backward
    changes no loss and no parameter (the same f32 ops, run again)."""
    init = _reference_run("flash", False)[0]
    plain, want = _port_run(_port_model("flash", init), False, steps=2)
    remat, got = _port_run(_port_model("flash", init, remat=True, remat_policy=policy),
                           False, steps=2)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for (name, p), q in zip(remat.model.named_parameters(), plain.model.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-7, msg=name)


def test_guard_skips_a_step_with_a_nan_gradient():
    """A NaN in one gradient skips the whole update: parameters, moments and
    the step counter stay as they were; the next clean step applies."""
    model = _port_model("dense", _reference_run("dense", False)[0])
    state = TrainState.create(model, AdamWConfig())
    step = make_lm_train_step(model, guard_nonfinite=True)
    (x, y), (x2, y2) = [(torch.from_numpy(a).long(), torch.from_numpy(b).long())
                        for a, b in _batches(2)]
    state, _ = step(state, x, y)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mu = {k: v.clone() for k, v in state.momentum["mu"].items()}
    hook = model.blocks[0].fc_in.weight.register_hook(lambda g: g * float("nan"))
    state, _ = step(state, x2, y2)
    hook.remove()
    assert state.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in state.momentum["mu"].items():
        assert torch.equal(v, mu[k]), k
    state, loss = step(state, x2, y2)
    assert state.step == 2 and np.isfinite(float(loss))


def test_dynamic_loss_scale_backs_off_and_grows():
    """Overflow halves the scale and skips the update; ``growth_interval``
    good steps in a row double it (clamped to [1, 2^24])."""
    model = _port_model("dense", _reference_run("dense", False)[0])
    sstate = with_dynamic_scale(TrainState.create(model, AdamWConfig()),
                                init_scale=2.0 ** 10, growth_interval=2)
    step = make_lm_train_step(model, dynamic_scale=True)
    x, y = (torch.from_numpy(a).long() for a in _batches(1)[0])
    hook = model.lm_head.weight.register_hook(lambda g: g * float("inf"))
    sstate, loss = step(sstate, x, y)
    hook.remove()
    assert np.isfinite(float(loss))  # the unscaled loss; only a gradient overflowed
    assert (sstate.loss_scale, sstate.good_steps, sstate.step) == (2.0 ** 9, 0, 0)
    sstate, loss = step(sstate, x, y)
    assert (sstate.loss_scale, sstate.good_steps, sstate.step) == (2.0 ** 9, 1, 1)
    sstate, _ = step(sstate, x, y)
    assert (sstate.loss_scale, sstate.good_steps, sstate.step) == (2.0 ** 10, 0, 2)
    with pytest.raises(ValueError, match="init_scale"):
        with_dynamic_scale(sstate.inner, init_scale=0.5)


def test_eval_step_matches_reference():
    """``(nll_sum, count)`` of the flash model's eval step (dense, as the
    reference clones it) at the reference's init."""
    init = _reference_run("flash", False)[0]
    x, y = _batches(1)[0]
    want_nll, want_count = ref_eval(RefLM(**MODEL, attn_impl="flash"))(init, x, y)
    model = _port_model("flash", init)
    nll, count = make_lm_eval_step(model)(dict(model.named_parameters()),
                                          torch.from_numpy(x).long(),
                                          torch.from_numpy(y).long())
    assert count == int(want_count) == BATCH * SEQ
    np.testing.assert_allclose(float(nll), float(want_nll), rtol=LOSS_RTOL)


def test_return_hidden_feeds_the_head():
    """``return_hidden`` gives the post-ln_f states; the head on them gives
    the logits."""
    model = _port_model("dense", _reference_run("dense", False)[0])
    x = torch.from_numpy(_batches(1)[0][0]).long()
    with torch.no_grad():
        hidden = model(x, return_hidden=True)
        assert hidden.shape == (BATCH, SEQ, MODEL["d_model"])
        torch.testing.assert_close(model.lm_head(hidden).float(), model(x))


def test_init_lm_state_is_seeded():
    a = init_lm_state(_port_model("dense"), seed=5)
    b = init_lm_state(_port_model("dense"), seed=5)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.step == 0 and set(a.momentum) == {"mu", "nu"}


def test_cli_prints_the_protocol_lines(capsys):
    cli_lm.main(["--device", "cpu", "--d-model", "64", "--n-layers", "2",
                 "--n-heads", "4", "--n-kv-heads", "2", "--seq-len", "128",
                 "--batch-size", "2", "--max-iters", "21", "--attn", "flash",
                 "--fused-update", "--eval-batches", "1"])
    out = capsys.readouterr().out
    assert "lm parallel=dp devices=1 (cpu)" in out
    assert "Loss at 20th batch is " in out
    assert "Total execution time is : " in out and "Average execution time is  : " in out
    assert "Eval: nll/token " in out


def test_cli_refuses_without_a_card_and_names_what_is_not_ported():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_lm.main(["--max-iters", "1"])
    # Telemetry still raises; expert parallelism and its flags parse and build
    # on the CPU (their trajectories: tests/test_torch_ep.py).
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        cli_lm.main(["--device", "cpu", "--telemetry-dir", "x"])
    tiny = ["--device", "cpu", "--d-model", "32", "--n-layers", "1", "--n-heads", "2",
            "--vocab", "64", "--seq-len", "16", "--batch-size", "2", "--parallel", "ep"]
    for flags in ([], ["--n-experts", "4"], ["--ep", "1"], ["--ep-seq", "1"],
                  ["--moe-impl", "grouped"]):
        args = cli_lm.make_parser().parse_args([*tiny, *flags])
        step, state, place, model = cli_lm.build(args)
        assert model.n_experts == args.n_experts and model.moe_impl == args.moe_impl
        x, y = place(*next(cli_lm.synthetic_batches(args, count=1)))
        assert torch.isfinite(step(state, x, y)[1]) and state.step == 1


def test_trainer_imports_no_jax():
    code = ("import sys, distributed_machine_learning_tpu_torch.cli.lm, "
            "distributed_machine_learning_tpu_torch.train.lm_step, "
            "distributed_machine_learning_tpu_torch.train.checkpoint, "
            "distributed_machine_learning_tpu_torch.runtime.deploy, "
            "distributed_machine_learning_tpu_torch.cli.deploy, "
            "distributed_machine_learning_tpu_torch.parallel.zero1, "
            "distributed_machine_learning_tpu_torch.parallel.fsdp_perlayer; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('distributed_machine_learning_tpu.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("opt", ["sgd_bf16", "lars"])
def test_sgd_and_lars_three_steps_match_reference(opt):
    """``cli.lm --optimizer sgd --momentum-dtype bfloat16`` and ``--optimizer
    lars`` at the small width: the config the CLI builds, then 3 steps from
    the reference's weights against the reference's trajectory (same losses
    and parameters as the AdamW test's tolerances; SGD's buffers are rounded
    to bf16 on both sides from f32 values equal to summation order, so an
    element at a rounding boundary may land one bf16 step away and carry it:
    buffers within two bf16 steps, 2^-6 relative, plus one bf16 step at the
    leaf's largest magnitude for elements that cancel toward zero)."""
    from distributed_machine_learning_tpu.train.lars import LARSConfig as RefLARS
    from distributed_machine_learning_tpu.train.sgd import SGDConfig as RefSGD

    flags = (["--optimizer", "sgd", "--momentum-dtype", "bfloat16"] if opt == "sgd_bf16"
             else ["--optimizer", "lars"])
    cfg = cli_lm.optimizer_config(cli_lm.make_parser().parse_args(flags))
    ref_cfg = RefSGD(momentum_dtype="bfloat16") if opt == "sgd_bf16" else RefLARS()
    assert cfg.__class__.__name__ == ref_cfg.__class__.__name__
    assert vars(cfg) == vars(ref_cfg)
    model = RefLM(**MODEL, attn_impl="flash")
    ref = ref_init(model, seed=69143, config=ref_cfg)
    init = jax.device_get(ref.params)
    ref_step, want = ref_step_fn(model), []
    for x, y in _batches():
        ref, loss = ref_step(ref, x, y)
        want.append(float(loss))
    state = TrainState.create(_port_model("flash", init), cfg)
    step, losses = make_lm_train_step(state.model), []
    for x, y in _batches():
        state, loss = step(state, torch.from_numpy(x).long(), torch.from_numpy(y).long())
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    got = state.model.state_dict()
    for name, w in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    bufs = flax_to_state_dict(jax.device_get(ref.momentum))
    for name, w in bufs.items():
        m = state.momentum[name]
        assert m.dtype == (torch.bfloat16 if opt == "sgd_bf16" else torch.float32)
        w = w.float().numpy()
        np.testing.assert_allclose(m.float().numpy(), w, rtol=2.0 ** -6,
                                   atol=2.0 ** -8 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("flags", [["--optimizer", "sgd", "--momentum-dtype", "bfloat16"],
                                   ["--optimizer", "lars"]])
def test_cli_trains_under_sgd_and_lars(flags, capsys):
    cli_lm.main(["--device", "cpu", "--d-model", "64", "--n-layers", "2", "--n-heads", "4",
                 "--n-kv-heads", "2", "--seq-len", "128", "--batch-size", "2",
                 "--max-iters", "2", "--attn", "flash", *flags])
    assert "Total execution time is : " in capsys.readouterr().out
