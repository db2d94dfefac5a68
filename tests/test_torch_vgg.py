"""The port's VGG, data pipeline and augmentation against the JAX package's.

Weights come from the Flax model (``convert.flax_vgg_to_state_dict``) and
inputs from numpy with a seed.  Tolerances: the forward in f32 within 1e-5
(both sum the same products in another order, ~1e-6 read); everything else
bit for bit (integer pipelines, and a normalization of the same f32 ops).
"""

import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu_torch import convert
from distributed_machine_learning_tpu_torch.data import augment as taug
from distributed_machine_learning_tpu_torch.data import cifar10 as tcifar
from distributed_machine_learning_tpu_torch.data import sharding as tshard
from distributed_machine_learning_tpu_torch.data.distributed_loader import (
    DistributedBatchLoader,
)
from distributed_machine_learning_tpu_torch.models import registry
from distributed_machine_learning_tpu_torch.models import vgg as tvgg


def _flax_vgg(name, use_bn, seed=0):
    import jax
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.models.vgg import VGG

    model = VGG(name_cfg=name, use_bn=use_bn)
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)), train=False)
    return model, jax.device_get(variables)


def _port_vgg(name, use_bn, variables):
    model = tvgg.VGG(name, use_bn=use_bn)
    model.load_state_dict(convert.flax_vgg_to_state_dict(
        variables["params"], variables.get("batch_stats")))
    return model


@pytest.mark.parametrize("name,use_bn", [("VGG11", False), ("VGG11", True),
                                         ("VGGTEST", True)])
def test_forward_eval_and_train_vs_flax(name, use_bn):
    import jax.numpy as jnp

    fmodel, variables = _flax_vgg(name, use_bn)
    if use_bn:  # running stats away from their init, so eval mode uses them
        rng = np.random.default_rng(1)
        variables["batch_stats"] = {
            k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32) * 0.1,
                "var": rng.random(v["var"].shape).astype(np.float32) + 0.5}
            for k, v in variables["batch_stats"].items()}
    model = _port_vgg(name, use_bn, variables)
    x = np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jnp.asarray(x), train=False))
    got = model(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not use_bn:
        return
    want, mutated = fmodel.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    got = model(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = model.new_batch_stats()
    for i in range(len(model.bns)):
        new = mutated["batch_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(stats[2 * i].numpy(), np.asarray(new["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(stats[2 * i + 1].numpy(), np.asarray(new["var"]),
                                   rtol=1e-5, atol=1e-6)


def test_param_counts_and_refusals():
    counts = {use_bn: sum(p.numel() for p in registry.get_model("vgg11", use_bn=use_bn,
                                                                device="meta").parameters())
              for use_bn in (False, True)}
    assert counts == {False: 9_225_610, True: 9_231_114}
    # The registry's ResNets (BN always on: use_bn is accepted and ignored), at
    # torchvision's counts for a 10-class head (CIFAR stem; the ImageNet stem's
    # 7x7 kernel adds 64 x 3 x (49 - 9)).
    resnets = {(name, stem): sum(p.numel() for p in registry.get_model(
        name, use_bn=False, cifar_stem=stem, device="meta").parameters())
        for name, stem in (("resnet18", True), ("resnet18", False), ("resnet34", True),
                           ("resnet50", True))}
    assert resnets == {("resnet18", True): 11_173_962, ("resnet18", False): 11_181_642,
                       ("resnet34", True): 21_282_122, ("resnet50", True): 23_520_842}
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model("resnet101")


def _jax_draws(key, n):
    """augment.py:52-65's draws, recomputed from the same key."""
    import jax

    crop_keys = jax.random.split(jax.random.fold_in(key, 0), n)
    flip = jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (n,))

    def offsets(k):
        kx, ky = jax.random.split(k)
        return jax.random.randint(kx, (), 0, 9), jax.random.randint(ky, (), 0, 9)

    top, left = jax.vmap(offsets)(crop_keys)
    return tuple(torch.from_numpy(np.array(a)) for a in (top, left, flip))


def test_normalize_and_crop_flip_bitwise_vs_jax():
    import jax
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.data.augment import augment_batch, normalize

    imgs = np.random.default_rng(4).integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    timgs = torch.from_numpy(imgs)
    np.testing.assert_array_equal(taug.normalize(timgs).numpy().view(np.uint32),
                                  np.asarray(normalize(jnp.asarray(imgs))).view(np.uint32))
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(augment_batch(key, jnp.asarray(imgs)))
        got = taug.normalize(taug.crop_flip(timgs, *_jax_draws(key, 16))).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # The port's own draws: in range, per (seed, rank, step), and applied.
    top, left, flip = taug.draw_augment(16, 69143, 1, 3)
    assert int(top.min()) >= 0 and int(top.max()) <= 8 and flip.dtype == torch.bool
    assert not torch.equal(top, taug.draw_augment(16, 69143, 0, 3)[0])
    same = taug.crop_flip(timgs, torch.full((16,), 4), torch.full((16,), 4),
                          torch.zeros(16, dtype=torch.bool))
    assert torch.equal(same, timgs)


def test_synthetic_sharding_and_rank_batches_vs_jax():
    from distributed_machine_learning_tpu.data import cifar10 as jcifar
    from distributed_machine_learning_tpu.data import sharding as jshard
    from distributed_machine_learning_tpu.data.distributed_loader import (
        DistributedBatchLoader as JLoader,
    )

    # The test split (the train split is the same code at another seed and n).
    a, b = tcifar._synthetic(False), jcifar._synthetic(False)
    np.testing.assert_array_equal(a.images, b.images)
    np.testing.assert_array_equal(a.labels, b.labels)
    for n, w in ((10, 3), (50_000, 4), (7, 2)):
        for r in range(w):
            for shuffle in (False, True):
                np.testing.assert_array_equal(tshard.shard_indices(n, r, w, shuffle),
                                              jshard.shard_indices(n, r, w, shuffle))
                np.testing.assert_array_equal(tshard.exact_shard_indices(n, r, w, shuffle),
                                              jshard.exact_shard_indices(n, r, w, shuffle))
    # Rank r's batch is row block r of the JAX global (rank-major) batch.
    data = a
    jbatch = next(iter(JLoader(data, 8, 4)))
    for r in range(4):
        imgs, labels = next(iter(DistributedBatchLoader(data, 8, 4, r)))
        np.testing.assert_array_equal(imgs, jbatch[0][r * 8:(r + 1) * 8])
        np.testing.assert_array_equal(labels, jbatch[1][r * 8:(r + 1) * 8])
