#!/usr/bin/env python3
"""How far f32 summation order alone moves a ResNet's first-step gradients.

Runs one train-mode forward and backward of the port's ResNet (seeded
init, the first batch of the synthetic CIFAR stand-in, no augmentation) in
f32 and in f64 on the CPU, and prints the relative L2 distance of the f32
gradients from the f64 ones over all leaves and for the worst leaf.  It is
the yardstick ``chip_smoke.a4_first_step_gate`` scales its limits by.

    python3 tools/resnet_grad_noise.py [--model resnet18] [--batch 32 256]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def first_step_grads(model_name: str, batch: int, dtype):
    import torch

    from distributed_machine_learning_tpu_torch.data.augment import normalize
    from distributed_machine_learning_tpu_torch.data.cifar10 import load_cifar10
    from distributed_machine_learning_tpu_torch.models.registry import get_model, init_params
    from distributed_machine_learning_tpu_torch.train.losses import cross_entropy_loss

    data = load_cifar10("./data", train=True)
    model = init_params(get_model(model_name, device="cpu", compute_dtype=dtype), 69143)
    model = model.to(dtype)
    x = normalize(torch.from_numpy(data.images[:batch]))
    loss = cross_entropy_loss(model(x, train=True),
                              torch.from_numpy(data.labels[:batch]).long())
    loss.backward()
    return float(loss), {n: p.grad.double() for n, p in model.named_parameters()}


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet18")
    ap.add_argument("--batch", type=int, nargs="+", default=[32, 256])
    args = ap.parse_args(argv)
    for b in args.batch:
        l32, g32 = first_step_grads(args.model, b, torch.float32)
        l64, g64 = first_step_grads(args.model, b, torch.float64)
        cat = lambda g: torch.cat([g[k].reshape(-1) for k in g64])  # noqa: E731
        whole = float((cat(g32) - cat(g64)).norm() / cat(g64).norm())
        worst, name = max((float((g32[k] - g64[k]).norm() / g64[k].norm()), k) for k in g64)
        print(f"{args.model} B {b}: loss f32 {l32:.7f} f64 {l64:.7f}; gradients f32 vs f64 "
              f"rel L2 {whole:.3e}, worst leaf {worst:.3e} ({name})")


if __name__ == "__main__":
    main()
