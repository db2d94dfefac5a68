"""Port of AdamW (train/adamw.py, ops/fused_adamw.py) vs the JAX package.

The same numpy parameters, moments and gradients go through the reference
``adamw_update`` (jitted; ``fused=True`` reaches the Pallas kernel
``fused_adamw_leaf`` in interpret mode) and through the port's
``adamw_update``, whose unfused chain and K7's plain version run on CPU
tensors.  The CUDA kernel K7 is held against its plain version on the card
(chip_smoke.py and tests/test_torch_kernels_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_machine_learning_tpu.ops.pallas.fused_adamw import (
    fused_adamw_leaf as ref_fused_leaf,
)
from distributed_machine_learning_tpu.train.adamw import AdamWConfig as RefConfig
from distributed_machine_learning_tpu.train.adamw import adamw_update as ref_update
from distributed_machine_learning_tpu_torch.ops.fused_adamw import (
    fused_adamw_leaf,
    fused_adamw_reference,
)
from distributed_machine_learning_tpu_torch.train.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
)

# The reference's parity contract (ops/pallas/fused_adamw.py): one update
# from identical state within 8 ulp on params and moments; 3-step
# trajectories within 5e-6 relative.  The freedom is FMA contraction (XLA
# fuses the chain and rounds b1·mu + (1−b1)·g once where the port's chain
# rounds twice) and the f32 power of the bias corrections (numpy and XLA
# round it differently in ~6 % of steps).  An ulp is taken at the larger of
# the result and the terms it sums: where b1·mu and (1−b1)·g cancel, the
# result is far smaller than its terms and one rounding of a term counts
# hundreds of ulps of the result (measured up to 455).
SINGLE_UPDATE_ULP = 8
TRAJECTORY_REL = 5e-6
SHAPES = {"w": ((37, 19), "float32"), "b": ((5,), "float32"),
          "e": ((2000,), "bfloat16")}
jit_update = jax.jit(ref_update, static_argnames=("config",))


def _ulps(got, want, *terms) -> float:
    """max |got − want| in ulps (of want's dtype: 24 significant bits for
    f32, 8 for bf16) of the larger of |want| and the |terms|."""
    bits = 8 if np.asarray(want).dtype.name == "bfloat16" else 24
    want = np.asarray(want, np.float32)
    scale = np.maximum.reduce([np.abs(want)] + [np.abs(np.asarray(t, np.float32))
                                                for t in terms])
    _, e = np.frexp(scale)
    err = np.abs(np.asarray(got, np.float32) - want)
    return float((err / np.ldexp(1.0, e - bits)).max()) if err.size else 0.0


def _check_update(new, want, old, grad, b1=0.9, b2=0.999):
    """``new``/``want``/``old``: (p, mu, nu) numpy; each within the bound,
    at the scale of the terms the update sums."""
    p, mu, nu = (np.asarray(t, np.float32) for t in old)
    g = np.asarray(grad, np.float32)
    terms = ([p], [np.float32(b1) * mu, np.float32(1 - b1) * g],
             [np.float32(b2) * nu, np.float32(1 - b2) * g * g])
    for name, got, w, t in zip(("p", "mu", "nu"), new, want, terms):
        assert _ulps(got, w, *t) <= SINGLE_UPDATE_ULP, name


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(jnp.bfloat16)
    return t.numpy()


def _state(seed: int):
    """Params (f32 and bf16 leaves), warm moments and gradients, as numpy."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32).astype(
        jnp.bfloat16 if dt == "bfloat16" else np.float32) for k, (s, dt) in SHAPES.items()}
    mu = {k: (1e-2 * rng.normal(size=s)).astype(np.float32) for k, (s, _) in SHAPES.items()}
    nu = {k: (1e-4 * rng.random(size=s)).astype(np.float32) for k, (s, _) in SHAPES.items()}
    grads = {k: rng.normal(size=s).astype(np.float32).astype(params[k].dtype)
             for k, (s, _) in SHAPES.items()}
    return params, {"mu": mu, "nu": nu}, grads


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_single_update_within_ulp_bound(fused):
    """One update at step 10 from the same non-zero state, f32 and bf16
    leaves: the port's chain vs XLA's, and K7's plain version vs the Pallas
    kernel."""
    params, moments, grads = _state(0)
    pr, mr = jit_update(params, moments, grads, RefConfig(fused=fused), step=10)
    tp, tm, tg = _torch(params), _torch(moments), _torch(grads)
    out_p, out_m = adamw_update(tp, tm, tg, AdamWConfig(fused=fused), step=10)
    assert out_p is tp and out_m is tm  # in place
    for k in SHAPES:
        assert tp[k].dtype == (torch.bfloat16 if k == "e" else torch.float32)
        _check_update((_np(tp[k]), _np(tm["mu"][k]), _np(tm["nu"][k])),
                      (pr[k], mr["mu"][k], mr["nu"][k]),
                      (params[k], moments["mu"][k], moments["nu"][k]), grads[k])


def test_plain_k7_matches_pallas_leaf():
    """``fused_adamw_reference`` (in place) against ``fused_adamw_leaf`` of
    the reference on one bf16 leaf, scalars passed as the step gives them."""
    params, moments, grads = _state(1)
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    lr, bc1, bc2 = 1e-3, 1.0 - 0.9 ** 4, 1.0 - 0.999 ** 4
    want = ref_fused_leaf(jnp.asarray(params["e"]), jnp.asarray(moments["mu"]["e"]),
                          jnp.asarray(moments["nu"]["e"]), jnp.asarray(grads["e"]),
                          lr, bc1, bc2, **hyper)
    old = (params["e"], moments["mu"]["e"], moments["nu"]["e"])
    got = [_torch(t) for t in old]
    fused_adamw_reference(*got, _torch(grads["e"]), lr, bc1, bc2, **hyper)
    _check_update([_np(t) for t in got], want, old, grads["e"])


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
def test_three_step_trajectory(fused):
    """3 steps of a quadratic loss, the gradient re-evaluated from each
    side's own parameters (f32 leaves): within 5e-6 relative."""
    params, _, _ = _state(2)
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    target = {k: np.full_like(v, 0.5) for k, v in params.items()}
    cfg = RefConfig(learning_rate=1e-2, fused=fused)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = {"mu": {k: jnp.zeros_like(v) for k, v in jp.items()},
          "nu": {k: jnp.zeros_like(v) for k, v in jp.items()}}
    tp = _torch(params)
    tm = adamw_init(tp)
    for step in range(3):
        jg = {k: jp[k] - target[k] for k in jp}
        jp, jm = jit_update(jp, jm, jg, cfg, step=step)
        tg = {k: tp[k] - torch.from_numpy(target[k]) for k in tp}
        adamw_update(tp, tm, tg, AdamWConfig(learning_rate=1e-2, fused=fused), step=step)
    for k in params:
        want = np.asarray(jp[k])
        rel = np.abs(tp[k].numpy() - want).max() / np.abs(want).max()
        assert rel <= TRAJECTORY_REL, (k, rel)


def test_zero_size_leaf_and_missing_step():
    p = {"z": torch.zeros(0), "w": torch.ones(3)}
    m = adamw_init(p)
    g = {"z": torch.zeros(0), "w": torch.ones(3)}
    for fused in (False, True):
        adamw_update(p, m, g, AdamWConfig(fused=fused), step=0)
    assert p["z"].shape == (0,) and m["mu"]["z"].shape == (0,)
    fused_adamw_leaf(p["z"], m["mu"]["z"], m["nu"]["z"], g["z"], 1e-3, 0.1, 0.001,
                     beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    with pytest.raises(ValueError, match="step="):
        adamw_update(p, m, g, AdamWConfig())
    with pytest.raises(TypeError, match="AdamWConfig"):
        adamw_update(p, m, g, RefConfig(), step=0)
