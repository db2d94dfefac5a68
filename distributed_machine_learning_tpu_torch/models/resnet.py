"""ResNet-18/34/50 for CIFAR-10 and ImageNet-class inputs.

Counterpart of ``distributed_machine_learning_tpu/models/resnet.py``: the
torchvision layout, BasicBlock for 18/34 and Bottleneck (4× expansion,
the stride on its 3×3 convolution) for 50, a ``cifar_stem`` flag (3×3
stride-1 stem, no max-pool, for 32×32 inputs; off: the ImageNet 7×7
stride-2 stem and a 3×3 stride-2 max-pool padded with −inf), BatchNorm
after every convolution, global average pool and a Dense head whose
logits come back in f32.  A block's residual goes through a 1×1
``downsample`` convolution (carrying the block's stride) and ``bn_down``
where the block changes the shape.

Convolutions are bias-free; kernels are OIHW ``nn.Parameter`` s named as
the Flax modules are (``stem_conv``, ``stageS_blockB.conv1``, ``bn1``,
``downsample``, ``bn_down``, ``fc``), so ``convert.flax_resnet_to_state_dict``
is a rename and a transpose.  The input is NHWC; it enters the
convolutions as an NCHW view.

BatchNorm is the VGG's Flax-statistics layer (``models/vgg.BatchNorm``):
biased batch variance, running statistics moved with it at a 0.9 retain
fraction.  Under ``compute_dtype=bfloat16`` the convolutions, the pool,
the ReLUs and the head run in bf16 (weights cast per layer, f32 master
parameters), while every BatchNorm computes its statistics and its
normalization in f32 and rounds its output to bf16, as Flax's BatchNorm
with ``dtype=bfloat16`` does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_machine_learning_tpu_torch.models.vgg import BatchNorm

# (block, layers per stage), torchvision's table.
CFG: dict[str, tuple[str, Sequence[int]]] = {
    "ResNet18": ("basic", (2, 2, 2, 2)),
    "ResNet34": ("basic", (3, 4, 6, 3)),
    "ResNet50": ("bottleneck", (3, 4, 6, 3)),
}
STAGE_FEATURES = (64, 128, 256, 512)


def _kernel(cout: int, cin: int, k: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k, device=device))


class _Block(nn.Module):
    """One residual block; ``kind`` "basic" or "bottleneck"."""

    def __init__(self, kind: str, cin: int, features: int, stride: int, device=None):
        super().__init__()
        self.kind, self.stride = kind, stride
        if kind == "basic":
            cout = features
            self.conv1 = _kernel(features, cin, 3, device)
            self.conv2 = _kernel(features, features, 3, device)
            self.bn1, self.bn2 = BatchNorm(features, device=device), BatchNorm(features,
                                                                               device=device)
        else:
            cout = features * 4
            self.conv1 = _kernel(features, cin, 1, device)
            self.conv2 = _kernel(features, features, 3, device)
            self.conv3 = _kernel(cout, features, 1, device)
            self.bn1 = BatchNorm(features, device=device)
            self.bn2 = BatchNorm(features, device=device)
            self.bn3 = BatchNorm(cout, device=device)
        self.cout = cout
        if stride != 1 or cin != cout:  # the reference's `residual.shape != y.shape`
            self.downsample = _kernel(cout, cin, 1, device)
            self.bn_down = BatchNorm(cout, device=device)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = x.dtype
        s = self.stride
        if self.kind == "basic":
            y = F.relu(self.bn1(F.conv2d(x, self.conv1.to(dt), stride=s, padding=1), train))
            y = self.bn2(F.conv2d(y, self.conv2.to(dt), padding=1), train)
        else:
            y = F.relu(self.bn1(F.conv2d(x, self.conv1.to(dt)), train))
            y = F.relu(self.bn2(F.conv2d(y, self.conv2.to(dt), stride=s, padding=1), train))
            y = self.bn3(F.conv2d(y, self.conv3.to(dt)), train)
        residual = x
        if self.downsample is not None:
            residual = self.bn_down(F.conv2d(x, self.downsample.to(dt), stride=s), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet for NHWC 3-channel input, ``num_classes`` f32 logits."""

    def __init__(self, name_cfg: str = "ResNet18", num_classes: int = 10,
                 cifar_stem: bool = True, compute_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.name_cfg, self.cifar_stem, self.compute_dtype = name_cfg, cifar_stem, compute_dtype
        kind, stage_sizes = CFG[name_cfg]
        self.stem_conv = _kernel(64, 3, 3 if cifar_stem else 7, device)
        self.stem_bn = BatchNorm(64, device=device)
        cin = 64
        for stage, (features, n_blocks) in enumerate(zip(STAGE_FEATURES, stage_sizes)):
            for block in range(n_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blk = _Block(kind, cin, features, stride, device=device)
                self.add_module(f"stage{stage + 1}_block{block + 1}", blk)
                cin = blk.cout
        self.fc = nn.Linear(cin, num_classes, device=device)
        self.bns = [m for m in self.modules() if isinstance(m, BatchNorm)]

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def blocks(self) -> list:
        return [m for m in self.children() if isinstance(m, _Block)]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        if self.cifar_stem:
            x = F.conv2d(x, self.stem_conv.to(dt), padding=1)
        else:
            x = F.conv2d(x, self.stem_conv.to(dt), stride=2, padding=3)
        x = F.relu(self.stem_bn(x, train))
        if not self.cifar_stem:
            x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf, as Flax's max_pool
        for blk in self.blocks():
            x = blk(x, train)
        x = x.mean((2, 3))  # global average pool
        return F.linear(x, self.fc.weight.to(dt), self.fc.bias.to(dt)).float()

    def new_batch_stats(self) -> list:
        """Every BN layer's moved running stats, flat: [mean0, var0, ...]."""
        return [t for bn in self.bns for t in bn.new_running_stats()]

    def set_batch_stats(self, stats: list) -> None:
        with torch.no_grad():
            for j, bn in enumerate(self.bns):
                bn.running_mean.copy_(stats[2 * j])
                bn.running_var.copy_(stats[2 * j + 1])


def init_resnet(model: ResNet, seed: int) -> ResNet:
    """Seeded weights, the same on every rank: each kernel normal with std
    1/√fan_in (Flax's LeCun scale, untruncated), the head's bias zero, BN
    scale 1 and bias 0.  Not Flax's draws: parity tests convert the
    reference's weights."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4 or name == "fc.weight":
                fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
            elif name == "fc.bias":
                p.zero_()
    return model
