"""VGG family for 32×32 CIFAR-10, cfg-driven.

Counterpart of ``distributed_machine_learning_tpu/models/vgg.py`` (the
reference's ``part1/model.py``): the cfg table of VGG11/13/16/19 (and the
tests' narrow VGGTEST), 3×3 stride-1 pad-1 convolutions with bias, ReLU,
2×2 max-pools, optional BatchNorm after each convolution (part3's model,
``part3/model.py:24``), and one Linear head on the flattened 1×1 map.
Parameters are f32; ``compute_dtype`` bf16 casts activations and weights
per layer, and the logits come back in f32.

Layout: the input is NHWC uint8-derived f32 (as the data pipeline and the
JAX package carry it); it enters the convolutions as an NCHW view with
channels-last strides.  The flatten happens at 1×1 spatial, so its order
is moot.

BatchNorm follows Flax, not ``F.batch_norm``: the batch variance is the
biased E[x²] − E[x]² (clamped at 0), normalization is
``(x − mean)·(rsqrt(var + eps)·scale) + bias`` in f32 whatever the compute
dtype (the result cast back to it, as Flax's ``_normalize`` promotes
against its f32 statistics), and the running statistics
move by ``0.9·running + 0.1·batch`` with the *biased* variance
(``F.batch_norm(training=True)`` would use the unbiased one).  A train-mode
forward only records each layer's batch statistics; the train step averages
them over the ranks (sync BN) and installs them with
:meth:`VGG.set_batch_stats`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# Reference cfg table (part1/model.py:3-8): ints are conv output channels,
# 'M' a 2×2 max-pool.  VGGTEST is the JAX package's narrow test net.
CFG: dict[str, Sequence] = {
    "VGGTEST": [8, "M", 16, "M", 16, "M", 16, "M", 16, "M"],
    "VGG11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "VGG16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "VGG19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class BatchNorm(nn.Module):
    """BatchNorm2d with Flax's statistics (see the module docstring):
    torch's defaults eps 1e-5, momentum 0.1 (Flax's retain fraction 0.9)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))
        self.batch_stats: tuple | None = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            xf = x.float()
            mean = xf.mean((0, 2, 3))
            var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)

    def new_running_stats(self) -> tuple:
        """(running_mean, running_var) moved toward the last train-mode
        forward's batch statistics (not installed)."""
        mean, var = self.batch_stats
        m = self.momentum
        return (m * self.running_mean + (1 - m) * mean,
                m * self.running_var + (1 - m) * var)


class VGG(nn.Module):
    """VGG for NHWC 3-channel 32×32 input, ``num_classes`` logits."""

    def __init__(self, name_cfg: str = "VGG11", use_bn: bool = False, num_classes: int = 10,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.name_cfg, self.use_bn, self.compute_dtype = name_cfg, use_bn, compute_dtype
        self.cfg = list(CFG[name_cfg])
        convs, bns, cin = [], [], 3
        for c in self.cfg:
            if c == "M":
                continue
            convs.append(nn.Conv2d(cin, c, 3, padding=1, bias=True, device=device))
            if use_bn:
                bns.append(BatchNorm(c, device=device))
            cin = c
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.fc1 = nn.Linear(cin, num_classes, device=device)

    @property
    def device(self) -> torch.device:
        return self.fc1.weight.device

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        i = 0
        for c in self.cfg:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            conv = self.convs[i]
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            if self.use_bn:
                x = self.bns[i](x, train)
            x = F.relu(x)
            i += 1
        x = x.reshape(x.shape[0], -1)
        return F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)).float()

    def new_batch_stats(self) -> list:
        """Every BN layer's moved running stats, flat: [mean0, var0, mean1,
        ...] (empty for a BN-free model)."""
        return [t for bn in self.bns for t in bn.new_running_stats()]

    def set_batch_stats(self, stats: list) -> None:
        with torch.no_grad():
            for j, bn in enumerate(self.bns):
                bn.running_mean.copy_(stats[2 * j])
                bn.running_var.copy_(stats[2 * j + 1])


def init_vgg(model: VGG, seed: int) -> VGG:
    """torch's default distributions, drawn from one seeded generator so
    every rank builds identical weights: U(±1/√fan_in) for each kernel and
    bias (the head's bias with fan-in 512, as the JAX package draws it);
    BN scale 1, bias 0."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t, bound):
        with torch.no_grad():
            t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=gen))

    for conv in model.convs:
        bound = 1.0 / math.sqrt(conv.in_channels * 9)
        fill(conv.weight, bound)
        fill(conv.bias, bound)
    fill(model.fc1.weight, 1.0 / math.sqrt(model.fc1.in_features))
    fill(model.fc1.bias, 1.0 / math.sqrt(512))
    return model
