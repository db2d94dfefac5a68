#!/usr/bin/env python3
"""A CPU model of K7's one freedom: what FMA contraction of the first moment
does to the parameter, in ulp, at two scales.

Usage: python3 tools/adamw_ulp_model.py [ELEMENTS]  (default 250,000,000)

Draws leaves as ``chip_smoke.check_flat_adamw`` does (p 0.02·N(0,1), mu
1e-3·N, nu 1e-6·U, g 1e-3·N; step 10, ``AdamWConfig()``) in chunks of
10M, updates each twice with the plain f32 chain, once with m rounded once
(``b1·mu + (1−b1)·g`` in f64, then f32: the kernel's contraction) and once
rounded twice, and prints the largest difference of p in ulp taken at the
larger of |p| and the result, and at the larger of those and the Adam
step's terms, lr·(|b1·mu| + |(1−b1)·g|)/bc1/(√n̂ + eps)
(``chip_smoke.adamw_ulp_errs``).  Where n̂ is near 0 the step magnifies
m's one rounding, so the first scale reads tens of ulp on correct
arithmetic.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from distributed_machine_learning_tpu_torch.train.adamw import (  # noqa: E402
    AdamWConfig,
    bias_corrections,
)

CHUNK = 10_000_000


def f32(x) -> float:
    return float(np.float32(x))


def ulp(x: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 24)


def main(n: int) -> None:
    cfg = AdamWConfig()
    b1, b2, eps, wd, lr = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay, cfg.learning_rate
    bc1, bc2 = bias_corrections(cfg, 10)
    gen = torch.Generator().manual_seed(0)
    own = with_terms = 0.0
    for start in range(0, n, CHUNK):
        k = min(CHUNK, n - start)
        p = 0.02 * torch.randn(k, generator=gen)
        mu = 1e-3 * torch.randn(k, generator=gen)
        nu = 1e-6 * torch.rand(k, generator=gen)
        g = 1e-3 * torch.randn(k, generator=gen)
        v = f32(b2) * nu + f32(1 - b2) * (g * g)
        denom = torch.sqrt(v / f32(bc2)) + f32(eps)

        def update(m):
            return p - f32(lr) * ((m / f32(bc1)) / denom + f32(wd) * p)

        once = update((b1 * mu.double() + (1 - b1) * g.double()).float())
        twice = update(f32(b1) * mu + f32(1 - b1) * g)
        diff = (once - twice).abs()
        scale = torch.maximum(twice.abs(), p.abs())
        terms = f32(lr) * (b1 * mu.abs() + (1 - b1) * g.abs()) / f32(bc1) / denom
        own = max(own, float((diff / ulp(scale)).max()))
        with_terms = max(with_terms, float((diff / ulp(torch.maximum(scale, terms))).max()))
    print(f"{n} elements: p's largest difference {own:.0f} ulp at p's own scale, "
          f"{with_terms:.0f} ulp at the Adam step's terms' scale")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 250_000_000)
