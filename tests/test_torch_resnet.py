"""The port's ResNets (``models/resnet.py``) against the reference's Flax
ResNets, on the same seeded inputs and the reference's own weights
(``convert.flax_resnet_to_state_dict``): train-mode logits, the moved BN
running statistics, and eval-mode logits from those statistics."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch.convert import flax_resnet_to_state_dict
from distributed_machine_learning_tpu_torch.models import registry

CASES = [("ResNet18", True, 32), ("ResNet50", True, 32), ("ResNet18", False, 64)]


def _both(name: str, cifar_stem: bool, hw: int, bf16: bool = False):
    """(flax model, variables, port model, input) with the port holding the
    reference's weights."""
    import jax
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.models.resnet import ResNet

    dt = jnp.bfloat16 if bf16 else jnp.float32
    fm = ResNet(name_cfg=name, cifar_stem=cifar_stem, compute_dtype=dt)
    variables = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), train=False)
    model = registry.get_model(name.lower(), cifar_stem=cifar_stem, device="cpu",
                               compute_dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(flax_resnet_to_state_dict(jax.device_get(variables["params"]),
                                                    jax.device_get(variables["batch_stats"])))
    x = np.random.default_rng(0).standard_normal((2, hw, hw, 3)).astype(np.float32)
    return fm, variables, model, x


def _run(fm, variables, model, x):
    """(reference train logits, port's, reference stats, port's, reference
    eval logits, port's): the eval pass reads the moved statistics."""
    import jax
    import jax.numpy as jnp

    want, mutated = fm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = model(torch.from_numpy(x), train=True).detach().float().numpy()
    model.set_batch_stats(model.new_batch_stats())
    stats_want = flax_resnet_to_state_dict(jax.device_get(variables["params"]),
                                           jax.device_get(mutated["batch_stats"]))
    stats_got = model.state_dict()
    eval_want = fm.apply({"params": variables["params"], "batch_stats": mutated["batch_stats"]},
                         jnp.asarray(x), train=False)
    eval_got = model(torch.from_numpy(x), train=False).detach().float().numpy()
    keys = [k for k in stats_want if "running" in k]
    return (np.asarray(want, np.float32), got, {k: stats_want[k].numpy() for k in keys},
            {k: stats_got[k].numpy() for k in keys}, np.asarray(eval_want, np.float32), eval_got)


@pytest.mark.parametrize("name,cifar_stem,hw", CASES)
def test_f32_logits_and_bn_stats_vs_flax(name, cifar_stem, hw):
    want, got, sw, sg, ew, eg = _run(*_both(name, cifar_stem, hw))
    assert got.dtype == np.float32 and got.shape == (2, 10)
    # f32 end to end: only summation order differs (1e-4 on logits, as the
    # VGG's; ResNet-50's 53 layers read 6.2e-5 in train mode).
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(eg, ew, rtol=1e-4, atol=1e-4)
    assert set(sg) == set(sw) and any("bn_down" in k for k in sw)
    for k in sw:  # a channel's mean is a cancelling sum: 1e-4 of the leaf's largest value
        np.testing.assert_allclose(sg[k], sw[k], rtol=1e-4, atol=1e-4 * np.abs(sw[k]).max())


def test_bf16_logits_and_bn_stats_vs_flax():
    """Convolutions, pool and head in bf16, every BN in f32 rounded to bf16
    (as Flax's BatchNorm with ``dtype=bfloat16``).  The two packages round
    their bf16 convolutions' sums differently (XLA vs oneDNN): logits within
    2^-5 of the largest logit (four bf16 steps at that scale), statistics
    within 2^-6 of each leaf's largest value."""
    want, got, sw, sg, ew, eg = _run(*_both("ResNet18", True, 32, bf16=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2.0 ** -5 * np.abs(want).max())
    np.testing.assert_allclose(eg, ew, atol=2.0 ** -5 * np.abs(ew).max())
    for k in sw:
        np.testing.assert_allclose(sg[k], sw[k], atol=2.0 ** -6 * np.abs(sw[k]).max())


def test_blocks_carry_the_stride_where_the_reference_does():
    """BasicBlock: the first 3x3 convolution strides; Bottleneck: its 3x3
    (the second) does; a shape-changing block has a 1x1 downsample + bn_down."""
    r18 = registry.get_model("resnet18", device="meta")
    r50 = registry.get_model("resnet50", device="meta")
    b18 = r18.stage2_block1
    assert b18.stride == 2 and b18.conv1.shape == (128, 64, 3, 3)
    assert b18.downsample.shape == (128, 64, 1, 1) and r18.stage1_block1.downsample is None
    b50 = r50.stage1_block1  # stride 1, but 64 -> 256 channels
    assert b50.stride == 1 and b50.conv2.shape == (64, 64, 3, 3)
    assert b50.downsample.shape == (256, 64, 1, 1)
    assert r50.stage3_block1.stride == 2 and r50.stage3_block1.conv2.shape == (256, 256, 3, 3)
