"""The fused LM head + cross-entropy (ops/fused_ce.py) vs the JAX package.

The same numpy hidden states [T, E], head weights and bias (the port's
weight is [V, E], JAX's kernel its transpose [E, V]) and targets go
through JAX's ``fused_linear_cross_entropy`` and the port's, at chunk
counts that divide V and that do not (V 97: 97 chunks of one row, 5 of 20
with a 17-row tail, 8 of 13 with a 6-row tail), and through the unfused
loss (``F.cross_entropy`` of the full logits).  f32 on both sides, so the
loss and dh/dW/db agree to summation order: within 1e-5.  ``lm_loss``'s
wiring is held against the unfused loss on a model and against JAX's
``lm_loss(fused_ce_chunks=...)`` on the same converted weights.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributed_machine_learning_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

T, E, V = 48, 32, 97
TOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, E)).astype(np.float32)
    w = (0.3 * rng.standard_normal((V, E))).astype(np.float32)
    b = (0.1 * rng.standard_normal(V)).astype(np.float32)
    y = rng.integers(0, V, T).astype(np.int32)
    y[:3] = (0, V - 1, V - 2)  # the first and the last rows of the vocab
    return h, w, b, y


def _port(h, w, b, y, chunks):
    h, w, b = (torch.from_numpy(x).requires_grad_() for x in (h, w, b))
    target = torch.from_numpy(y).long()
    if chunks is None:
        loss = F.cross_entropy(h @ w.t() + b, target)
    else:
        loss = fused_linear_cross_entropy(h, w, b, target, chunks)
    return [loss.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(loss, (h, w, b)))]


@pytest.mark.parametrize("chunks", [1, 5, 8, 97])
def test_matches_jax_and_unfused(chunks):
    import jax
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.ops.fused_ce import (
        fused_linear_cross_entropy as ref,
    )

    h, w, b, y = _inputs(chunks)
    fn = lambda h_, k_, b_: ref(h_, k_, b_, jnp.asarray(y), chunks)  # noqa: E731
    loss, (dh, dk, db) = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(h), jnp.asarray(w.T), jnp.asarray(b))
    want = [np.asarray(loss), np.asarray(dh), np.asarray(dk).T, np.asarray(db)]
    got = _port(h, w, b, y, chunks)
    unfused = _port(h, w, b, y, None)
    for name, g, jw, u in zip(("loss", "dh", "dW", "db"), got, want, unfused):
        np.testing.assert_allclose(g, jw, rtol=TOL, atol=TOL, err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(g, u, rtol=TOL, atol=TOL, err_msg=f"{name} vs unfused")


def test_refuses_bad_shapes():
    with pytest.raises(ValueError, match="num_chunks must be >= 1"):
        fused_linear_cross_entropy(torch.zeros(2, 4), torch.zeros(3, 4), torch.zeros(3),
                                   torch.zeros(2, dtype=torch.long), 0)
    with pytest.raises(ValueError, match="want hidden"):
        fused_linear_cross_entropy(torch.zeros(2, 4), torch.zeros(4, 3), torch.zeros(3),
                                   torch.zeros(2, dtype=torch.long), 2)


def test_lm_loss_wiring():
    """``lm_loss(fused_ce_chunks=3)`` on a model: the unfused loss and every
    parameter's gradient within 1e-5; and JAX's fused ``lm_loss`` on the
    same converted weights and tokens."""
    import jax
    import jax.numpy as jnp

    from distributed_machine_learning_tpu.models.transformer import TransformerLM as RefLM
    from distributed_machine_learning_tpu.train.lm_step import init_lm_state as ref_init
    from distributed_machine_learning_tpu.train.lm_step import lm_loss as ref_loss
    from distributed_machine_learning_tpu_torch.convert import flax_to_state_dict
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.train.lm_step import lm_loss

    cfg = dict(vocab_size=V, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2)
    ref_model = RefLM(**cfg)
    params = jax.device_get(ref_init(ref_model, seed=3).params)
    model = TransformerLM(**cfg, device="cpu")
    model.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(1)
    x, y = rng.integers(0, V, (2, 16)), rng.integers(0, V, (2, 16))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    losses, grads = [], []
    for chunks in (None, 3):
        model.zero_grad()
        loss = lm_loss(model, tx, ty, chunks)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    want = float(ref_loss(ref_model, params, jnp.asarray(x, jnp.int32),
                          jnp.asarray(y, jnp.int32), fused_ce_chunks=3))
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL)
    np.testing.assert_allclose(losses[1], want, rtol=TOL)
    for k, g in grads[0].items():
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
