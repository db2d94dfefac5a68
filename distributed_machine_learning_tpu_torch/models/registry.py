"""Model registry: name → constructor and seeded init, shared by the part
CLIs.

Counterpart of ``distributed_machine_learning_tpu/models/registry.py``:
the reference's VGG cfg table (VGG11/13/16/19 and the tests' VGGTEST) and
the ResNets BASELINE.json names.  ``use_bn``: VGG takes it literally (off
for part1/2a/2b, on for part3); the ResNets are BN architectures and
accept and ignore it (BN always on).
"""

from __future__ import annotations

import torch

from distributed_machine_learning_tpu_torch.models import resnet, vgg

VGG_NAMES = {k.lower(): k for k in vgg.CFG}
RESNET_NAMES = {k.lower(): k for k in resnet.CFG}


def list_models() -> list[str]:
    return sorted(VGG_NAMES) + sorted(RESNET_NAMES)


def get_model(name: str, *, use_bn: bool = False, compute_dtype=None, num_classes: int = 10,
              cifar_stem: bool = True, device=None):
    """A model by lowercase name (``vgg11``, ``resnet18``, ...)."""
    key = name.lower()
    dtype = compute_dtype or torch.float32
    if key in VGG_NAMES:
        return vgg.VGG(VGG_NAMES[key], use_bn=use_bn, num_classes=num_classes,
                       compute_dtype=dtype, device=device)
    if key in RESNET_NAMES:
        return resnet.ResNet(RESNET_NAMES[key], num_classes=num_classes,
                             cifar_stem=cifar_stem, compute_dtype=dtype, device=device)
    raise ValueError(f"unknown model {name!r}; available: {list_models()}")


def init_params(model, seed: int):
    """Seeded weights, the same on every rank: ``vgg.init_vgg`` for a VGG,
    ``resnet.init_resnet`` for a ResNet."""
    if isinstance(model, vgg.VGG):
        return vgg.init_vgg(model, seed)
    if isinstance(model, resnet.ResNet):
        return resnet.init_resnet(model, seed)
    raise TypeError(f"no initializer for {type(model).__name__}")
