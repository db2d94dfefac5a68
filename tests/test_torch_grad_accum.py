"""Gradient accumulation (``make_train_step(accum_steps=k)``) and the LR
schedule fed to the update, against the JAX package's step.

Both sides start from the same Flax-initialized VGGTEST weights (converted)
and take the same numpy batches with augmentation off.  Tolerance: losses
and parameters after 3 steps within 1e-5 relative (f32; the two sides'
convolutions sum in another order).  Against its own ``accum_steps=1``
the port's BN-free step is the same update up to the order of the
microbatch sums (the reference's "identical update when augmentation is
off"): 1e-5 relative as well.
"""

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch import convert
from distributed_machine_learning_tpu_torch.train.step import make_train_step

STEPS, BATCH, TOL = 3, 16, 1e-5


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (BATCH, 32, 32, 3), dtype=np.uint8),
             rng.integers(0, 10, BATCH).astype(np.int32)) for _ in range(STEPS)]


def _jax(use_bn, accum, schedule=None):
    import jax

    from distributed_machine_learning_tpu.cli.common import init_model_and_state
    from distributed_machine_learning_tpu.models.vgg import VGG
    from distributed_machine_learning_tpu.train.step import make_train_step as jmake

    model = VGG(name_cfg="VGGTEST", use_bn=use_bn)
    state = init_model_and_state(model)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
    step = jmake(model, None, mesh=None, augment=False, accum_steps=accum, schedule=schedule)
    losses = []
    for images, labels in _batches():
        state, loss = step(state, images, labels)
        losses.append(float(loss))
    return variables, losses, jax.device_get(state.params), jax.device_get(state.batch_stats)


def _port(variables, use_bn, accum, schedule=None):
    from distributed_machine_learning_tpu_torch.models.vgg import VGG
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = VGG("VGGTEST", use_bn=use_bn)
    model.load_state_dict(convert.flax_vgg_to_state_dict(variables["params"],
                                                         variables.get("batch_stats")))
    state = TrainState.create(model, SGDConfig())
    step = make_train_step(model, augment=False, accum_steps=accum, schedule=schedule)
    losses = []
    for images, labels in _batches():
        state, loss = step(state, torch.from_numpy(images), torch.from_numpy(labels).long())
        losses.append(float(loss))
    return losses, state


def _close(got_tree, want_tree):
    for key, leaves in want_tree.items():
        for leaf, want in leaves.items():
            np.testing.assert_allclose(got_tree[key][leaf], np.asarray(want), rtol=TOL,
                                       atol=TOL * float(np.abs(want).max()),
                                       err_msg=f"{key}/{leaf}")


@pytest.mark.parametrize("use_bn", [False, True])
def test_accum4_vs_jax_and_vs_accum1(use_bn):
    variables, jlosses, jparams, jstats = _jax(use_bn, accum=4)
    losses, state = _port(variables, use_bn, accum=4)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    _close(convert.flax_vgg_tree(state.params), jparams)
    if use_bn:
        # BN's running statistics thread through the 4 microbatches (the step
        # keeps the last one's): 16 moves of 0.9/0.1 after 3 steps.
        names = list(state.batch_stats)
        for i in range(len(names) // 2):
            for j, which in enumerate(("mean", "var")):
                want = np.asarray(jstats[f"BatchNorm_{i}"][which])
                np.testing.assert_allclose(  # a channel mean is a cancelling sum
                    state.batch_stats[names[2 * i + j]].numpy(), want, rtol=TOL,
                    atol=TOL * float(np.abs(want).max()))
        return
    losses1, state1 = _port(variables, use_bn, accum=1)
    np.testing.assert_allclose(losses, losses1, rtol=TOL)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), state1.params[k].detach().numpy(),
                                   rtol=TOL, atol=TOL * float(p.abs().max()))


def test_schedule_reaches_the_update_vs_jax():
    """A warmup-cosine rate over the 3 steps, step 0 at lr 0 (warmup)."""
    from distributed_machine_learning_tpu.train import schedule as jsched

    from distributed_machine_learning_tpu_torch.train import schedule as tsched

    variables, jlosses, jparams, _ = _jax(False, 2, jsched.warmup_cosine(0.1, 1, 3))
    losses, state = _port(variables, False, 2, tsched.warmup_cosine(0.1, 1, 3))
    np.testing.assert_allclose(losses, jlosses, rtol=TOL)
    _close(convert.flax_vgg_tree(state.params), jparams)


def test_indivisible_batch_is_refused_as_jax_refuses():
    from distributed_machine_learning_tpu_torch.models.vgg import VGG
    from distributed_machine_learning_tpu_torch.train.sgd import SGDConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    model = VGG("VGGTEST")
    step = make_train_step(model, augment=False, accum_steps=3)
    with pytest.raises(ValueError, match="per-device batch 16 not divisible by accum_steps=3"):
        step(TrainState.create(model, SGDConfig()), torch.zeros(16, 32, 32, 3, dtype=torch.uint8),
             torch.zeros(16, dtype=torch.long))
