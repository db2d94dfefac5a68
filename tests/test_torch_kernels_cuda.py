"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Each test asks for the ``cuda`` fixture, which skips when no CUDA device is
present (the CPU test run), so the same tests are collected everywhere.
Run on a card:  python -m pytest tests/test_torch_kernels_cuda.py -q
"""

import contextlib
import math

import pytest
import torch

from distributed_machine_learning_tpu_torch.models import transformer
from distributed_machine_learning_tpu_torch.ops import build
from distributed_machine_learning_tpu_torch.ops import decode_attention as da
from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
from distributed_machine_learning_tpu_torch.ops import fused_adamw as fadam
from distributed_machine_learning_tpu_torch.ops import quant
from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm

# Judged row by row (a row is one output vector), so the limit scales with
# what the row holds: a long attention row's values are far smaller than a
# short row's.  (largest element error / max|plain row|, rms error /
# rms(plain row)).  bf16: kernel and plain version round P and the output
# to bf16 at different places (spacing 2^-8 relative), so 2^-6 is 2 to 4
# spacings of the row's largest value.  f32: summation order only.
BF16_TOL = (2.0 ** -6, 1e-2)
F32_TOL = (1e-4, 1e-4)
# Attention gradients: the same row gates, each row's scale bounded below by
# a fraction of the whole tensor's: dq of query 0 (which sees only key 0)
# is zero in exact arithmetic, rounding noise in both versions (~2e-6 of
# the tensor's scale in f32, so the f32 gate of 1e-4 needs a floor of 5e-2
# for that row; other f32 rows agree to ~1e-6 of their own scale).
GRAD_ROW_FLOOR = {torch.bfloat16: 1e-3, torch.float32: 5e-2}
# f32 gradients: summation order only, but a dq row sums dS K with
# sum_k dS = 0, so its terms cancel: 10x the forward's f32 limit (a worst
# row read 1.2e-4 at D 128).
F32_GRAD_TOL = (1e-3, 1e-3)
# lse (log2 space, ~log2 L): the same f32 sums in another order.
LSE_TOL = 1e-3
# K7 vs its plain version: the reference's contract, 8 ulp per update.
ADAMW_ULP_TOL = 8


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol, floor=0.0):
    elem_tol, rms_tol = tol
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    assert torch.isfinite(got).all()
    err = got - want
    tiny = torch.finfo(torch.float32).tiny
    peak = max(floor * float(want.abs().max()), tiny)
    level = max(floor * float(want.square().mean().sqrt()), tiny)
    elem = err.abs().amax(-1) / want.abs().amax(-1).clamp_min(peak)
    rms = err.square().mean(-1).sqrt() / want.square().mean(-1).sqrt().clamp_min(level)
    assert float(elem.max()) <= elem_tol, f"worst row elem error {float(elem.max()):.3e}"
    assert float(rms.max()) <= rms_tol, f"worst row rms error {float(rms.max()):.3e}"


@contextlib.contextmanager
def plain_kernels():
    """The model's and the trainer's kernel entry points routed to their
    plain versions (attention with a gradient keeps the autograd Function,
    with its launchers swapped)."""
    flash = fa.flash_self_attention

    def plain_flash(q, k, v):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return flash(q, k, v)
        return fa.flash_attention_reference(q, k, v)

    swaps = [(transformer, "flash_self_attention", plain_flash),
             (fa, "_launch", lambda q, k, v: fa.flash_attention_reference(
                 q, k, v, return_lse=True)),
             (fa, "_launch_bwd", fa.flash_attention_backward_reference),
             (fadam, "_launch", fadam.fused_adamw_reference),
             (transformer, "cached_flash_attention", da.cached_attention_reference),
             (transformer, "paged_flash_attention", da.paged_attention_reference),
             (quant, "int8_matmul", qm.int8_matmul_reference)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    try:
        for mod, attr, fn in swaps:
            setattr(mod, attr, fn)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@pytest.mark.parametrize("L", [64, 100, 1024, 1100])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(cuda, L, H, Hkv, D, dtype):
    q = torch.randn(2, L, H, D, device="cuda", generator=cuda).to(dtype)
    k = torch.randn(2, L, Hkv, D, device="cuda", generator=cuda).to(dtype)
    v = torch.randn(2, L, Hkv, D, device="cuda", generator=cuda).to(dtype)
    before = build.launches["flash_fwd"]
    got = fa.flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert build.launches["flash_fwd"] == before + 1
    assert got.dtype == dtype
    _close(got, fa.flash_attention_reference(q, k, v),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


def test_flash_kernel_reads_strided_slices(cuda):
    """q/k/v as slices of a fused projection, as the MHA model passes them."""
    qkv = torch.randn(2, 256, 3, 4, 128, device="cuda", generator=cuda).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    _close(fa.flash_self_attention(q, k, v),
           fa.flash_attention_reference(q, k, v), BF16_TOL)


# K1 (bf16) walks 128-row query tiles split between two warpgroups of 64
# rows, over 128-key tiles: lengths at and around one tile, and tails that
# end inside the first (100, 170) or the second (200) warpgroup's rows.
# The kernel runs on the rows as they are (``_launch``: no pad path).
@pytest.mark.parametrize("L", [100, 127, 128, 129, 170, 200])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
def test_flash_kernel_tile_edges(cuda, L, H, Hkv, D):
    q = torch.randn(2, L, H, D, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(2, L, Hkv, D, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(2, L, Hkv, D, device="cuda", generator=cuda).bfloat16()
    out, lse = fa._launch(q, k, v)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    _close(out, want, BF16_TOL)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_kernel_reads_gqa_slices(cuda, D):
    """q, k, v as head slices of one fused GQA projection [B, L, H + 2 Hkv, D]."""
    H, Hkv = 8, 2
    x = torch.randn(2, 300, H + 2 * Hkv, D, device="cuda", generator=cuda).bfloat16()
    q, k, v = x[:, :, :H], x[:, :, H:H + Hkv], x[:, :, H + Hkv:]
    out, lse = fa._launch(q, k, v)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    _close(out, want, BF16_TOL)


@pytest.mark.parametrize("L", [100, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_lse_matches_plain(cuda, dtype, L):
    q = torch.randn(2, L, 8, 128, device="cuda", generator=cuda).to(dtype)
    k = torch.randn(2, L, 2, 128, device="cuda", generator=cuda).to(dtype)
    v = torch.randn(2, L, 2, 128, device="cuda", generator=cuda).to(dtype)
    out, lse = fa._launch(q, k, v)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    assert lse.shape == (2, 8, L) and lse.dtype == torch.float32
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    _close(out, want, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


def _bwd_inputs(gen, B, L, H, Hkv, D, dtype):
    q, k, v, do = (torch.randn(B, L, n, D, device="cuda", generator=gen).to(dtype)
                   for n in (H, Hkv, Hkv, H))
    out, lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


@pytest.mark.parametrize("L", [100, 1024])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_kernels_match_plain(cuda, L, H, Hkv, D, dtype):
    """K2 and K3 on the same inputs as their plain version (MHA and GQA,
    head dims 32/64/128, a ragged length)."""
    args = _bwd_inputs(cuda, 2, L, H, Hkv, D, dtype)
    before = (build.launches["flash_bwd_dq"], build.launches["flash_bwd_dkv"])
    dq = fa._launch_dq(*args)
    dk, dv = fa._launch_dkv(*args)
    torch.cuda.synchronize()
    assert (build.launches["flash_bwd_dq"], build.launches["flash_bwd_dkv"]) == (
        before[0] + 1, before[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_GRAD_TOL
    for got, want in zip((dq, dk, dv), fa.flash_attention_backward_reference(*args)):
        _close(got, want, tol, GRAD_ROW_FLOOR[dtype])


def _flash_bwd_check(q, k, v, do):
    """K2 and K3 (bf16) vs their plain version, with the plain forward's
    lse and delta of q's rows, each launched once."""
    out, lse = fa.flash_attention_reference(q, k, v, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    names = ("flash_bwd_dq", "flash_bwd_dkv")
    before = [build.launches[n] for n in names]
    got = (fa._launch_dq(q, k, v, do, lse, delta), *fa._launch_dkv(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    assert [build.launches[n] - b for n, b in zip(names, before)] == [1, 1]
    want = fa.flash_attention_backward_reference(q, k, v, do, lse, delta)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w, BF16_TOL, GRAD_ROW_FLOOR[torch.bfloat16])


# K2 and K3 (bf16) at lengths that end inside and at the edge of K2's
# 128-row and K3's 64-row tiles (the kernels on the rows as they are: no
# pad path).
@pytest.mark.parametrize("L", [100, 127, 128, 129, 200])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
def test_flash_backward_tile_edges(cuda, L, H, Hkv, D):
    q, do = (torch.randn(2, L, H, D, device="cuda", generator=cuda).bfloat16() for _ in "ab")
    k, v = (torch.randn(2, L, Hkv, D, device="cuda", generator=cuda).bfloat16() for _ in "ab")
    _flash_bwd_check(q, k, v, do)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_backward_reads_gqa_slices(cuda, D):
    """K2 and K3 with q, k, v as head slices of one fused GQA projection
    and dO a head slice of a wider tensor."""
    H, Hkv = 8, 2
    x = torch.randn(2, 300, H + 2 * Hkv, D, device="cuda", generator=cuda).bfloat16()
    y = torch.randn(2, 300, 2 * H, D, device="cuda", generator=cuda).bfloat16()
    _flash_bwd_check(x[:, :, :H], x[:, :, H:H + Hkv], x[:, :, H + Hkv:], y[:, :, H:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_gradients_through_autograd_padded(cuda, dtype):
    """A padded length (1100 → 1536) through the autograd Function, kernel
    path vs plain path, GQA."""
    q, k, v, do, _, _ = _bwd_inputs(cuda, 1, 1100, 8, 2, 64, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(fa.flash_self_attention(q, k, v), (q, k, v), do)
    with plain_kernels():
        want = torch.autograd.grad(fa.flash_self_attention(q, k, v), (q, k, v), do)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_GRAD_TOL
    for g, w in zip(got, want):
        _close(g, w, tol, GRAD_ROW_FLOOR[dtype])


def test_flash_attention_has_a_gradient_on_the_card(cuda):
    """A loss through the kernel path reaches q, k and v."""
    q, k, v = (torch.randn(1, 512, n, 64, device="cuda", generator=cuda,
                           dtype=torch.bfloat16, requires_grad=True) for n in (4, 2, 2))
    fa.flash_self_attention(q, k, v).float().square().sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert all(bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().max()) > 0
               for t in (q, k, v))


def _ulp_err(got, want, *terms):
    """ulps of want's dtype at the larger of |want| and the |terms| it sums
    (FMA contraction rounds once where the plain chain rounds twice; where
    the terms cancel, that is many ulps of the result)."""
    bits = 8 if want.dtype == torch.bfloat16 else 24
    scale = want.float().abs()
    for t in terms:
        scale = torch.maximum(scale, t.abs())
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - bits)
    return float(((got.float() - want.float()).abs() / ulp).max())


@pytest.mark.parametrize("n", [1, 3, 8, 13, 4096, 1_000_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_kernel_matches_plain(cuda, n, dtype):
    """One update from a non-zero state at step 10, ragged lengths included:
    params and moments within 8 ulp of the plain version."""
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
    p = (0.02 * torch.randn(n, device="cuda", generator=cuda)).to(dtype)
    mu = 1e-3 * torch.randn(n, device="cuda", generator=cuda)
    nu = 1e-6 * torch.rand(n, device="cuda", generator=cuda)
    g = (1e-3 * torch.randn(n, device="cuda", generator=cuda)).to(dtype)
    got = [t.clone() for t in (p, mu, nu, g)]
    want = [t.clone() for t in (p, mu, nu, g)]
    before = build.launches["fused_adamw"]
    scalars = (3e-4, 1 - 0.9 ** 11, 1 - 0.999 ** 11)
    fadam.fused_adamw_leaf(*got, *scalars, **hyper)
    torch.cuda.synchronize()
    assert build.launches["fused_adamw"] == before + 1
    fadam.fused_adamw_reference(*want, *scalars, **hyper)
    assert got[0].dtype == dtype
    g32 = g.float()
    terms = ([p.float()], [0.9 * mu, 0.1 * g32], [0.999 * nu, 0.001 * g32 * g32])
    for i in range(3):
        assert _ulp_err(got[i], want[i], *terms[i]) <= ADAMW_ULP_TOL


def test_fused_adamw_kernel_refuses_what_it_does_not_take(cuda):
    p = torch.zeros(64, device="cuda")
    f32 = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="f32 or bf16"):
        fadam.fused_adamw_leaf(p.half(), f32, f32, p.half(), 1e-3, 0.1, 0.001,
                               beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    with pytest.raises(ValueError, match="aligned"):
        fadam.fused_adamw_leaf(p[1:], f32[1:], f32[1:], p[1:], 1e-3, 0.1, 0.001,
                               beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)


def test_trainer_on_the_card_matches_plain_path(cuda):
    """Two bf16 train steps of a small GQA model with flash attention and the
    fused update, kernel path vs plain path from the same weights: the
    losses agree and every kernel of the step launched."""
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.lm_step import (
        init_lm_state,
        make_lm_train_step,
    )

    tokens = torch.randint(0, 257, (3, 2, 1025), device="cuda", generator=cuda)

    def train():
        model = TransformerLM(vocab_size=257, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, attn_impl="flash",
                              compute_dtype=torch.bfloat16, device="cuda")
        state = init_lm_state(model, seed=0, config=AdamWConfig(fused=True))
        step = make_lm_train_step(model)
        return [float(step(state, t[:, :-1], t[:, 1:])[1]) for t in tokens]

    build.reset_launch_counts()
    got = train()
    assert build.launches["flash_fwd"] == build.launches["flash_bwd_dq"] == 2 * 3
    assert build.launches["flash_bwd_dkv"] == 2 * 3
    assert build.launches["fused_adamw"] == 3 * (1 + 14 * 2 + 4)
    with plain_kernels():
        want = train()
    assert build.launches["fused_adamw"] == 3 * 33  # the plain path launched nothing
    # bf16 logits of one model, kernel vs plain attention: ~1e-3 apart.
    assert all(abs(g - w) <= 2e-2 for g, w in zip(got, want)), (got, want)


def _parallel_rank(rank, world, init_method, parallel):
    """One rank of a small ``cli.lm --parallel ulysses|fsdp`` run sharing the
    card (gloo over host buffers): 2 bf16 steps with the fused update
    (fsdp: the sync step, then --overlap-update from the same seed), the
    launch counts of each run and a digest of the full parameters."""
    import hashlib

    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method)
    flags = ["--parallel", parallel, "--num-nodes", str(world), "--rank", str(rank),
             "--d-model", "256", "--n-layers", "2", "--n-heads", "4", "--n-kv-heads", "2",
             "--vocab", "257", "--compute-dtype", "bfloat16", "--fused-update",
             "--max-iters", "2"]
    flags += (["--seq-len", "2048", "--batch-size", "1"] if parallel == "ulysses"
              else ["--seq-len", "256", "--batch-size", "2"])
    runs = [[]] if parallel == "ulysses" else [[], ["--overlap-update"]]
    out = []
    try:
        for extra in runs:
            args = lm.make_parser().parse_args(flags + extra)
            step, state, place, model = lm.build(args, ctx)
            build.reset_launch_counts()
            losses = [float(step(state, *place(x, y))[1]) for x, y in lm.synthetic_batches(args)]
            launches = dict(build.launches)
            digest = hashlib.sha256()
            for p in step.params_fn(state).values():
                digest.update(p.detach().float().cpu().numpy().tobytes())
            if extra:
                step.close()
            out.append((losses, launches, digest.hexdigest(), model.attn_impl,
                        sum(1 for _ in model.parameters())))
        return out
    finally:
        ctx.shutdown()


@pytest.mark.parametrize("parallel", ["ulysses", "fsdp"])
def test_parallel_trainers_on_the_card(cuda, parallel):
    """``--parallel ulysses`` at W 2 runs its local attention over the full
    2048 tokens through K1-K3 (once per layer a step on every rank) and K7
    once per leaf; ``--parallel fsdp`` at W 2 runs dense attention and K7
    once a step on its flat shard, and its overlapped run is bit for bit the
    sync run.  Every rank ends with the same parameters."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    ranks = spawn(_parallel_rank, 2, (parallel,), timeout_s=600)
    for runs in ranks:
        for losses, launches, digest, attn, n_leaves in runs:
            assert all(math.isfinite(x) for x in losses) and losses == ranks[0][0][0]
            if parallel == "ulysses":
                assert attn == "ulysses"
                assert [launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] \
                    == [2 * 2] * 3
                assert launches["fused_adamw"] == 2 * n_leaves
            else:
                assert attn == "dense" and launches["flash_fwd"] == 0
                assert launches["fused_adamw"] == 2
    assert len({d for runs in ranks for _, _, d, _, _ in runs}) == 1


def test_checkpoint_round_trip_of_a_card_state(cuda, tmp_path):
    """A TrainState on the card after a flash + fused-AdamW step, saved and
    restored into a fresh card state: every leaf bit for bit, on the state's
    device; restored without a template, the same bits on the host."""
    from distributed_machine_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_machine_learning_tpu_torch.train import checkpoint as ck
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.lm_step import (
        init_lm_state,
        make_lm_train_step,
    )

    def state(seed):
        model = TransformerLM(vocab_size=257, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=2, attn_impl="flash",
                              compute_dtype=torch.bfloat16, device="cuda")
        return init_lm_state(model, seed=seed, config=AdamWConfig(fused=True))

    trained = state(0)
    tokens = torch.randint(0, 257, (2, 1025), device="cuda", generator=cuda)
    make_lm_train_step(trained.model)(trained, tokens[:, :-1], tokens[:, 1:])
    path = ck.save_checkpoint(tmp_path, trained)
    restored = ck.restore_checkpoint(path, state(1))
    host = ck.restore_checkpoint(path)
    want = ck._state_leaves(trained)
    got = ck._state_leaves(restored)
    assert restored.step == host.step == 1 and restored.config == trained.config
    assert got.keys() == want.keys() == ck._state_leaves(host).keys()
    for name, t in want.items():
        if name == "step":
            continue
        assert got[name].device == t.device and got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
        assert torch.equal(ck._state_leaves(host)[name], t.cpu()), name


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 1, 200, 511, 4095])
def test_decode_kernel_matches_plain(cuda, dtype, pos, D):
    q = torch.randn(3, 1, 8, D, device="cuda", generator=cuda).to(dtype)
    kc = torch.randn(3, 2, 4096, D, device="cuda", generator=cuda).to(dtype)
    vc = torch.randn(3, 2, 4096, D, device="cuda", generator=cuda).to(dtype)
    got = da.cached_flash_attention(q, kc, vc, pos)
    torch.cuda.synchronize()
    _close(got, da.cached_attention_reference(q, kc, vc, pos),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


def _int8_cache(gen, B, Hkv, S, D):
    """An int8 cache and its scales, from random bf16 K/V through the
    model's quantized write."""
    k = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).bfloat16()
    return (*transformer.quantize_kv(k), *transformer.quantize_kv(v))


@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pos", [0, 1, 200, 2047, 2048, 4095])
def test_decode_int8_kernel_matches_plain(cuda, dtype, pos, D, rep):
    """K4's int8 mode: q in its own dtype, int8 rows dequantized in f32 by
    the slot's scale; bf16 q rounds only the output (BF16_TOL), f32 q is
    summation order only (F32_TOL)."""
    kq, ks, vq, vs = _int8_cache(cuda, 3, 2, 4096, D)
    q = torch.randn(3, 1, 2 * rep, D, device="cuda", generator=cuda).to(dtype)
    before = dict(build.launches)
    got = da.cached_flash_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert build.launches["decode_attention_int8"] == before["decode_attention_int8"] + 1
    assert build.launches["decode_attention"] == before["decode_attention"]
    assert got.dtype == dtype
    _close(got, da.cached_attention_reference(q, kq, vq, pos, ks, vs),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


@pytest.mark.parametrize("q_dtype,cache_dtype", [(torch.float32, torch.bfloat16),
                                                 (torch.bfloat16, torch.float32)])
def test_decode_kernel_with_a_cache_dtype_other_than_q(cuda, q_dtype, cache_dtype):
    q = torch.randn(2, 1, 8, 128, device="cuda", generator=cuda).to(q_dtype)
    kc = torch.randn(2, 2, 4096, 128, device="cuda", generator=cuda).to(cache_dtype)
    vc = torch.randn(2, 2, 4096, 128, device="cuda", generator=cuda).to(cache_dtype)
    got = da.cached_flash_attention(q, kc, vc, 3000)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    _close(got, da.cached_attention_reference(q, kc, vc, 3000), BF16_TOL)


def test_decode_int8_kernel_refuses_what_it_does_not_take(cuda):
    kq, ks, vq, vs = _int8_cache(cuda, 1, 2, 512, 48)
    q = torch.randn(1, 1, 4, 48, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        da.cached_flash_attention(q, kq, vq, 3, k_scale=ks, v_scale=vs)
    kq, ks, vq, vs = _int8_cache(cuda, 1, 2, 512, 64)
    q = torch.randn(1, 1, 4, 64, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="f32 scales"):
        da.cached_flash_attention(q, kq, vq, 3, k_scale=ks.double(), v_scale=vs)
    with pytest.raises(ValueError, match="query"):
        da.cached_flash_attention(q.half(), kq, vq, 3, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match="k_scale"):
        da.cached_flash_attention(q, kq, vq, 3)


def test_int8_kv_model_on_the_card_matches_plain_path(cuda):
    """An f32 model with an int8 cache and the tiered switch on: a 60-token
    prompt in a 512-slot cache, decode positions 60-62 below the break-even
    (100·p < 19·512), so every decode step launches K4's int8 mode; its
    logits held against the plain path of the same model.  f32, but the
    cache is int8: a last-bit difference in one layer's attention output
    can flip one int8 code of the next layer's K/V at a rounding tie (one
    quantization step, amax/127), which moves the logits by ~1e-4 (read
    1.7e-4 on an H100): atol 1e-3."""
    from distributed_machine_learning_tpu_torch.convert import init_params

    model = transformer.TransformerLM(vocab_size=257, d_model=128, n_layers=2, n_heads=4,
                                      n_kv_heads=2, kv_cache_dtype=torch.int8,
                                      int8_tiered_dispatch=True, device="cuda")
    init_params(model, seed=0)
    tokens = torch.randint(0, 257, (2, 63), device="cuda", generator=cuda)

    def run():
        cache = model.init_cache(2, 512)
        steps = [model(tokens[:, :60], cache=cache, start=0, last_only=True)]
        steps += [model(tokens[:, i:i + 1], cache=cache, start=i) for i in range(60, 63)]
        return torch.cat(steps, 1)

    with torch.no_grad():
        build.reset_launch_counts()
        got = run()
        assert build.launches["decode_attention_int8"] == 2 * 3
        with plain_kernels():
            want = run()
    assert build.launches["decode_attention_int8"] == 2 * 3  # the plain path launched nothing
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("bs", [4, 16, 128])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_kernel_matches_plain(cuda, dtype, rep, D, bs):
    """Ragged lanes (0, block edges, long) through shuffled tables whose
    entries past each frontier hold other lanes' blocks, and an idle lane
    on the scratch block."""
    Hkv, positions = 2, [0, bs - 1, bs, 300, 1500, 0]
    mb = -(-1501 // bs)
    n = 5 * mb
    tables = torch.randperm(n, device="cuda", generator=cuda).int().reshape(5, mb)
    tables = torch.cat([tables, torch.full((1, mb), n, dtype=torch.int32, device="cuda")])
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn(6, 1, Hkv * rep, D, device="cuda", generator=cuda).to(dtype)
    k = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=cuda).to(dtype)
    v = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=cuda).to(dtype)
    before = build.launches["paged_attention"]
    got = da.paged_flash_attention(q, k, v, tables, pos)
    torch.cuda.synchronize()
    assert build.launches["paged_attention"] == before + 1 and got.dtype == dtype
    _close(got, da.paged_attention_reference(q, k, v, tables, pos),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


def test_paged_kernel_in_graphs_on_a_fresh_stream(cuda):
    """Two CUDA graphs captured on a stream the kernel never ran on
    eagerly, the second replayed before the first, then eager calls on
    that stream and on another: each is right (counters made during a
    capture are zeroed inside that graph; eager ones kept per stream)."""
    positions = PAGED_EDGE_POSITIONS["engine_step"]
    W, Hkv, D, bs, mb = len(positions), 4, 128, 16, 260
    n = sum(p // bs + 1 for p in positions)
    tables = torch.full((W, mb), n, dtype=torch.int32, device="cuda")
    take = 0
    for w, p in enumerate(positions):
        tables[w, :p // bs + 1] = torch.arange(take, take + p // bs + 1, dtype=torch.int32)
        take += p // bs + 1
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn(W, 1, 4 * Hkv, D, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=cuda).bfloat16()
    want = da.paged_attention_reference(q, k, v, tables, pos)
    stream = torch.cuda.Stream()
    graphs, outs = [], []
    for _ in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs.append(da.paged_flash_attention(q, k, v, tables, pos))
        graphs.append(graph)
    for i in (1, 0, 1):
        outs[i].zero_()
        graphs[i].replay()
        torch.cuda.synchronize()
        _close(outs[i], want, BF16_TOL)
    for s in (stream, torch.cuda.Stream()):
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            got = [da.paged_flash_attention(q, k, v, tables, pos) for _ in range(2)]
        torch.cuda.synchronize()
        for g in got:
            _close(g, want, BF16_TOL)


# K5's plan at its edges: lanes at 0, on page edges (15/16), on the
# smallest chunk's edges (63/64, 127/128) and at the table's last slot
# (4159); one lane and sixteen; f32 pools (16-byte loads of 4 values);
# groups of 1, 2 and 8; block sizes 16 and 4 (a tile spans four pages).
PAGED_EDGE_POSITIONS = {
    "one_lane_at_end": [4159],
    "one_lane_at_0": [0],
    "sixteen_lanes": [15, 16, 63, 64, 127, 128, 129, 0, 1, 2, 511, 512, 4000, 4159, 2, 7],
    "engine_step": [4097, 301, 2944, 3504, 2193, 1808, 3697, 650],
}


@pytest.mark.parametrize("case", sorted(PAGED_EDGE_POSITIONS))
@pytest.mark.parametrize("rep", [1, 2, 8])
@pytest.mark.parametrize("dtype,bs", [(torch.bfloat16, 16), (torch.float32, 16),
                                      (torch.bfloat16, 4)])
def test_paged_kernel_plan_edges(cuda, dtype, bs, rep, case):
    """Lanes through tables whose entries past each frontier point at the
    scratch block, twice in a row (the arrival counters are zero again
    after a call), against the plain version."""
    positions = PAGED_EDGE_POSITIONS[case]
    W, Hkv, D, mb = len(positions), 2, 128, 4160 // bs
    n = sum(p // bs + 1 for p in positions)
    perm = torch.randperm(n, device="cuda", generator=cuda).int()
    tables = torch.full((W, mb), n, dtype=torch.int32, device="cuda")
    take = 0
    for w, p in enumerate(positions):
        tables[w, :p // bs + 1] = perm[take:take + p // bs + 1]
        take += p // bs + 1
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    q = torch.randn(W, 1, Hkv * rep, D, device="cuda", generator=cuda).to(dtype)
    k = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=cuda).to(dtype)
    v = torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=cuda).to(dtype)
    want = da.paged_attention_reference(q, k, v, tables, pos)
    for _ in range(2):
        got = da.paged_flash_attention(q, k, v, tables, pos)
        torch.cuda.synchronize()
        _close(got, want, BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


# The serve CLI's --engine model on the card (d_model 128, heads of dim 32,
# vocab 32): every projection and the 32-column head, f32 x, at its decode
# width (4 lanes) and its prefill lengths (1-3 tokens).
@pytest.mark.parametrize("D,K", [(128, 128), (512, 128), (128, 512), (128, 32)])
@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_int8_cli_engine_shapes_match_plain(cuda, R, D, K):
    x = torch.randn(R, D, device="cuda", generator=cuda)
    q, s = qm.quantize_int8(
        torch.randn(D, K, device="cuda", generator=cuda) / math.sqrt(D))
    got = qm.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (R, K)
    _close(got, qm.int8_matmul_reference(x, q, s), F32_TOL)


# K6's decode route (R <= 16): R 1, 8 and 16; depths of 8 times an odd
# number (a last k16 block half past D); a last column tile past K (2064);
# the head (32000, unsplit) and the byte-level head (257, the byte-staged
# tile); the LM's fc_out depth (8192, split over a cluster of 8).
@pytest.mark.parametrize("D,K", [(2048, 2048), (8192, 2048), (1032, 2064), (24, 1024),
                                 (2040, 32000), (520, 257)])
@pytest.mark.parametrize("R", [1, 8, 16])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_skinny_route_matches_plain(cuda, dtype, R, D, K):
    assert qm.int8_route(R, D, K) == "skinny"
    x = torch.randn(R, D, device="cuda", generator=cuda).to(dtype)
    q, s = qm.quantize_int8(
        torch.randn(D, K, device="cuda", generator=cuda) / math.sqrt(D))
    before = (dict(qm.route_calls), build.launches["quant_matmul"])
    got = qm.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qm.route_calls["skinny"] == before[0]["skinny"] + 1
    assert build.launches["quant_matmul"] == before[1] + 1
    assert got.dtype == dtype and got.shape == (R, K)
    _close(got, qm.int8_matmul_reference(x, q, s),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


# The skinny route's cluster reduction at every cluster size, called
# directly past the split policy, at depths that leave most of a cluster's
# 64 warps with no k16 block (D 24: two blocks; D 136: nine) or a ragged
# share (D 1032): an empty warp still pushes its zero share into the other
# blocks' shared memory.
@pytest.mark.parametrize("D", [24, 136, 1032])
@pytest.mark.parametrize("R", [1, 8, 16])
def test_int8_skinny_cluster_splits_at_shallow_depth(cuda, R, D):
    K = 384
    x = torch.randn(R, D, device="cuda", generator=cuda).bfloat16()
    q, s = qm.quantize_int8(
        torch.randn(D, K, device="cuda", generator=cuda) / math.sqrt(D))
    want = qm.int8_matmul_reference(x, q, s)
    fn = build.function(qm.KERNEL, "w8a16_matmul", qm._ARGTYPES)
    for splits in range(1, qm.SKINNY_MAX_SPLITS + 1):
        out = torch.full((R, K), float("nan"), device="cuda", dtype=torch.bfloat16)
        status = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), R, D, K, 1,
                    splits, qm.ROUTES.index("skinny"), build.stream_handle(x.device))
        build.check(status, qm.KERNEL)
        torch.cuda.synchronize()
        _close(out, want, BF16_TOL)


# K = 257 (a byte-level LM head) and 40: columns not a multiple of 16.
@pytest.mark.parametrize("R,D,K", [(1, 64, 16), (8, 2048, 1024), (13, 320, 960),
                                   (300, 512, 2064), (8, 256, 257), (40, 64, 40)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_kernel_matches_plain(cuda, R, D, K, dtype):
    x = torch.randn(R, D, device="cuda", generator=cuda).to(dtype)
    q, s = qm.quantize_int8(
        torch.randn(D, K, device="cuda", generator=cuda) / math.sqrt(D))
    got = qm.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    # f32 outputs: the same bf16-exact products summed in another order.
    _close(got, qm.int8_matmul_reference(x, q, s),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


# The wgmma mainloop (R > 16, K % 16 == 0): ragged R (8 x 4095, 300, 17),
# the LM's fc_out depth (D 8192), a depth under one k-tile (D 40), a ragged
# last column tile (K 2064) and the vocabulary head (K 32000).
@pytest.mark.parametrize("R,D,K", [(8 * 4095, 2048, 1024), (300, 8192, 2048),
                                   (8 * 4095, 8192, 2048), (300, 2048, 32000),
                                   (4100, 2048, 2064), (17, 40, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_wgmma_route_matches_plain(cuda, R, D, K, dtype):
    assert qm.int8_route(R, D, K) == "wgmma"
    x = torch.randn(R, D, device="cuda", generator=cuda).to(dtype)
    q, s = qm.quantize_int8(
        torch.randn(D, K, device="cuda", generator=cuda) / math.sqrt(D))
    before = dict(qm.route_calls)
    got = qm.int8_matmul(x, q, s)
    torch.cuda.synchronize()
    assert qm.route_calls["wgmma"] == before["wgmma"] + 1
    assert got.dtype == dtype and got.shape == (R, K)
    _close(got, qm.int8_matmul_reference(x, q, s),
           BF16_TOL if dtype == torch.bfloat16 else F32_TOL)


# K4 split across blocks (decode_split), both modes, at B 1 and 8: pos 0,
# the first split edges (127/128: one chunk; 255/256: two), a chunk's last
# slot at 32 chunks of 128 (4095), the main path's middle decode step
# (4111) and, at S 32768, a long frontier and the last slot.
@pytest.mark.parametrize("S,pos", [(4608, 0), (4608, 127), (4608, 128), (4608, 255),
                                   (4608, 256), (4608, 4095), (4608, 4111),
                                   (32768, 20000), (32768, 32767)])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_decode_split_kernel_matches_plain(cuda, mode, B, S, pos):
    H, Hkv, D = 16, 4, 128
    q = torch.randn(B, 1, H, D, device="cuda", generator=cuda).bfloat16()
    if mode == "int8":
        kq, ks, vq, vs = _int8_cache(cuda, B, Hkv, S, D)
        args, name = (q, kq, vq, pos, ks, vs), "decode_attention_int8"
    else:
        kc = torch.randn(B, Hkv, S, D, device="cuda", generator=cuda).bfloat16()
        vc = torch.randn(B, Hkv, S, D, device="cuda", generator=cuda).bfloat16()
        args, name = (q, kc, vc, pos), "decode_attention"
    scales = dict(k_scale=args[4], v_scale=args[5]) if mode == "int8" else {}
    before = build.launches[name]
    got = da.cached_flash_attention(*args[:4], **scales)
    torch.cuda.synchronize()
    assert build.launches[name] == before + 1  # one per call, the combine included
    _close(got, da.cached_attention_reference(*args), BF16_TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 4, 2, 48, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_self_attention(x, x, x)
    with pytest.raises(ValueError, match="bf16 or f32"):
        fa.flash_self_attention(x.half(), x.half(), x.half())
    pool = torch.zeros(3, 2, 4, 48, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        da.paged_flash_attention(x[:, :1], pool, pool,
                                 torch.zeros(4, 1, dtype=torch.int32, device="cuda"),
                                 torch.zeros(4, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="D % 8"):
        qm.int8_matmul(torch.randn(2, 60, device="cuda"),
                       torch.zeros(60, 24, dtype=torch.int8, device="cuda"),
                       torch.ones(24, device="cuda"))


@pytest.mark.parametrize("dtype,quant", [(torch.float32, None),
                                         (torch.bfloat16, "int8")])
def test_model_on_the_card_matches_plain_path(cuda, dtype, quant):
    """A byte-level model of head dim 32 (the CLI's shapes, vocab 257) with a
    4090-token prompt: padded flash prefill, a 4096-slot cache on the decode
    kernel, and (int8) an LM head of 257 columns, each kernel held against
    the plain path of the same model."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.inference.generate import (
        make_generate_fn,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from distributed_machine_learning_tpu_torch.ops.quant import quantize_lm

    model = TransformerLM(vocab_size=257, d_model=64, n_layers=2, n_heads=2,
                          n_kv_heads=1, compute_dtype=dtype, device="cuda")
    init_params(model, seed=0)
    model = quantize_lm(model) if quant else model.to(dtype)
    prompt = torch.randint(0, 257, (2, 4090), device="cuda", generator=cuda)
    fn = make_generate_fn(model, 4, quantize=quant)
    build.reset_launch_counts()
    got = fn(prompt)
    assert build.launches["flash_fwd"] == 2
    assert build.launches["decode_attention"] == 2 * 3
    assert (build.launches["quant_matmul"] > 0) == (quant == "int8")
    with plain_kernels():
        want = fn(prompt)
    assert build.launches["flash_fwd"] == 2  # the plain path launched nothing
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_engine_on_the_card_matches_plain_path(cuda):
    """The continuous engine in f32 on the card (paged kernel, flash prefill
    of a 1024-token prompt, int8 lever): the same greedy tokens as with
    every kernel swapped for its plain version."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.inference.continuous import (
        ContinuousEngine,
        EngineConfig,
    )
    from distributed_machine_learning_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from distributed_machine_learning_tpu_torch.runtime.scheduler import (
        RegimeConfig,
        RegimeScheduler,
    )

    model = TransformerLM(vocab_size=257, d_model=128, n_layers=2, n_heads=4,
                          n_kv_heads=2, device="cuda")
    init_params(model, seed=0)
    prompts = [torch.randint(0, 257, (n,), generator=cuda, device="cuda").tolist()
               for n in (1024, 5, 40, 300, 17)]

    def serve():
        sched = RegimeScheduler(RegimeConfig(thin_width=1, wide_width=4, dwell_steps=2))
        eng = ContinuousEngine(model, EngineConfig(max_lanes=3, block_size=16,
                                                   num_blocks=256, max_len=1040),
                               scheduler=sched)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6 + 2 * i)
        done = {d["rid"]: d["tokens"] for d in eng.drain()}
        assert sched.flips >= 1
        return done

    build.reset_launch_counts()
    got = serve()
    assert all(build.launches[k] > 0 for k in ("paged_attention", "flash_fwd",
                                               "quant_matmul"))
    with plain_kernels():
        want = serve()
    assert got == want


def test_engine_fleet_on_the_card_matches_plain_path(cuda):
    """The serve CLI's engine fleet on the card: two live replicas and a
    spare (threads launching K5 and K6 at once, over one shared model and
    int8 twin) behind the router; every request's tokens equal a lone
    engine's with every kernel swapped for its plain version."""
    import threading

    from distributed_machine_learning_tpu_torch.cli import serve
    from distributed_machine_learning_tpu_torch.runtime.serving import (
        ServingConfig,
        ServingRouter,
    )
    from distributed_machine_learning_tpu_torch.runtime.serving_worker import (
        ServingWorkerConfig,
        start_worker_thread,
    )
    from distributed_machine_learning_tpu_torch.runtime.transport import (
        InProcHub,
        InProcTransport,
    )

    engines = serve.make_engines(3, 4, torch.device("cuda"))
    prompts = [[1 + (7 * i + j) % 13 for j in range(1 + i % 3)] for i in range(24)]
    hub = InProcHub()
    router = ServingRouter(InProcTransport(hub), ServingConfig(replicas=2, poll_s=0.002))
    stop = threading.Event()
    workers = [start_worker_thread(InProcTransport(hub), r, None, stop,
                                   ServingWorkerConfig(micro_batch=4), engine=e)
               for r, e in enumerate(engines)]
    rt = threading.Thread(target=router.run, args=(stop,), daemon=True)
    rt.start()
    build.reset_launch_counts()
    try:
        rids = [router.submit(p) for p in prompts]
        assert router.wait_idle(60.0), router.audit()
        got = [router.result(rid)["result"] for rid in rids]
    finally:
        verdict = router.close()
        stop.set()
        for t, _ in workers:
            t.join(10.0)
        rt.join(10.0)
    assert verdict["exactly_once"] and build.launches["paged_attention"] > 0
    with plain_kernels():
        lone = engines[0]
        lone.note_lever("latency")
        for i, p in enumerate(prompts):
            lone.submit(i, p)
        want = {d["rid"]: d["tokens"] for d in lone.drain()}
    assert got == [want[i] for i in range(len(prompts))]


# ---------------------------------------------------------------------------
# The int8 ring codec K8-K10: BITWISE equal to the plain versions (a
# truncated scale makes every q * scale exact; IEEE division, rint).
# ---------------------------------------------------------------------------


def _bits_equal(a, b):
    view = {4: torch.int32, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


# 9,231,114: the whole VGG gradient as one chunk, past what K8 stages on
# chip.  "max_last" and "nan_last" put the largest |v| or a NaN in the last
# element: K8's last block, its ragged tail where n % 4 != 0.  15, 16 and
# 17 sit around K9's and K10's 16-element lane vector.
@pytest.mark.parametrize("n", [1, 3, 4, 5, 15, 16, 17, 127, 4096, 4097, 669_379, 1_338_757,
                               9_231_114])
@pytest.mark.parametrize("kind", ["normal", "zero", "nan", "inf", "tiny", "max_last", "nan_last"])
def test_ring_codec_kernels_bitwise(cuda, n, kind):
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    v = torch.randn(n, device="cuda", generator=cuda) * 0.01
    if kind == "zero":
        v.zero_()
    elif kind == "nan":
        v[n // 2] = float("nan")
    elif kind == "inf":
        v[n // 3] = float("inf")
    elif kind == "tiny":
        v *= 1e-38  # subnormal scale: no flush to zero
    elif kind == "max_last":
        v[-1] = -1.0
    elif kind == "nan_last":
        v[-1] = float("nan")
    acc = torch.randn(n, device="cuda", generator=cuda)
    build.reset_launch_counts()
    q, scale, err = rc.encode_int8_residual(v)
    q2, scale2 = rc.encode_int8(v)
    added = rc.decode_add_int8(q, scale, acc.clone())
    dec = rc.decode_int8(q, scale, n)
    torch.cuda.synchronize()
    assert build.launches["ring_encode_int8"] == 2
    assert build.launches["ring_decode_add_int8"] == build.launches["ring_decode_int8"] == 1
    wq, wscale, werr = rc.encode_int8_residual_reference(v)
    for got, want in ((q, wq), (scale, wscale), (err, werr), (q2, wq), (scale2, wscale),
                      (added, rc.decode_add_int8_reference(wq, wscale, acc.clone())),
                      (dec, rc.decode_int8_reference(wq, wscale, n))):
        assert _bits_equal(got, want)


def test_ring_encode_graphs_replay_bitwise(cuda):
    """K8 captured on a fresh stream: one graph replayed twice, then two
    graphs replayed out of order, each time bit for bit the plain version
    (the per-stream partials buffer needs no reset between replays)."""
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs = []
    for n in (1_638_400, 669_379):
        v = torch.randn(n, device="cuda", generator=cuda) * 0.01
        v[n // 3] = 2.0
        with torch.cuda.stream(stream):
            rc.encode_int8_residual(v)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs = (*rc.encode_int8_residual(v), *rc.encode_int8(v))
        wq, ws, we = rc.encode_int8_residual_reference(v)
        graphs.append((graph, v, outs, (wq, ws, we, wq, ws)))  # v outlives the graph
    for i in (0, 0, 1, 0, 1, 1):
        graph, _, outs, want = graphs[i]
        for t in outs:
            t.fill_(3)
        graph.replay()
        torch.cuda.synchronize()
        assert all(_bits_equal(a, b) for a, b in zip(outs, want))


def test_ring_encode_refuses_a_grid_that_cannot_be_resident(cuda):
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    v = torch.randn(4 * rc.ENCODE_MAX_GRID * 64, device="cuda", generator=cuda)
    with pytest.raises(RuntimeError):
        rc._launch_encode(v, True, rc.EncodePlan(rc.ENCODE_MAX_GRID, 256, 256))
    torch.cuda.synchronize()


def test_ring_codec_kernels_refuse_what_they_do_not_take(cuda):
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    v = torch.randn(64, device="cuda", generator=cuda)
    q, scale = rc.encode_int8(v)
    with pytest.raises(ValueError):
        rc.encode_int8(v.double())
    with pytest.raises(ValueError):
        rc.encode_int8(v.view(8, 8))
    with pytest.raises(ValueError):
        rc.encode_int8(v[1:])  # not 16-byte aligned
    with pytest.raises(ValueError):
        rc.decode_add_int8(q.to(torch.int16), scale, v.clone())
    with pytest.raises(ValueError):
        rc.decode_add_int8(q, scale.double(), v.clone())
    with pytest.raises(ValueError):
        rc.decode_int8(q, scale, 63)
    with pytest.raises(ValueError):
        rc.decode_add_int8(q.cpu(), scale, v.clone())


# The all-gather's batched K10 at lengths around the 16-element lane vector
# and a path length (669,379 = 16 x 41,836 + 3).
@pytest.mark.parametrize("n", [1, 15, 16, 17, 669_379])
@pytest.mark.parametrize("world", [4, 40])
def test_ring_decode_rows_bitwise(cuda, n, world):
    """The batched K10 writes each payload's decode into its row of a
    padded out, rows out of order with the owner's among them, bit for bit
    the plain version, pad columns untouched; one launch per 32 rows."""
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    payloads = [rc.encode_int8(torch.randn(n, device="cuda", generator=cuda))
                for _ in range(world)]
    own = world // 2
    order = [own] + [i for i in torch.randperm(world, generator=cuda, device="cuda").tolist()
                     if i != own]
    out = torch.arange(world * (-(-n // 16) * 16 + 16), device="cuda", dtype=torch.int32)
    out = out.view(torch.float32).view(world, -1)
    want = rc.decode_rows_int8_reference(payloads, out.clone(), order, n)
    build.reset_launch_counts()
    rc.decode_rows_int8(payloads, out, order, n)
    torch.cuda.synchronize()
    assert build.launches["ring_decode_int8"] == -(-world // rc.DECODE_ROWS_MAX)
    assert _bits_equal(out, want)


def test_ring_decode_rows_refuses_what_it_does_not_take(cuda):
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc

    q, scale = rc.encode_int8(torch.randn(64, device="cuda", generator=cuda))
    out = torch.empty(4, 80, device="cuda")
    with pytest.raises(ValueError):  # a destination off 16-byte alignment
        rc._launch_decode_rows([q], [scale], [out[0, 1:65]], 64)
    with pytest.raises(ValueError):  # a row of another length
        rc._launch_decode_rows([q, q[:48]], [scale, scale], [out[0, :64], out[1, :64]], 64)
    with pytest.raises(ValueError):  # an int8 destination
        rc._launch_decode_rows([q], [scale], [torch.empty(64, dtype=torch.int8, device="cuda")],
                               64)
    rows = rc.DECODE_ROWS_MAX + 1  # more rows than one table holds, below the split
    big = torch.empty(rows, 64, device="cuda")
    with pytest.raises(ValueError):
        rc._launch_decode_rows([q] * rows, [scale] * rows, list(big), 64)
    with pytest.raises(ValueError):  # a CPU payload for a CUDA out
        rc.decode_rows_int8([(q.cpu(), scale)], out, [0], 64)


def test_int8_ring_step_kernels_match_plain_codec(cuda):
    """A world-1 ring has no hop, so the path's kernels are exercised on one
    process through the scheme's seams: encode with residual, decode-add,
    decode and the all-gather's batched decode of a VGG-sized bucket chunk,
    kernels vs the "xla" impl."""
    from distributed_machine_learning_tpu_torch.ops import ring

    v = torch.randn(1_338_757, device="cuda", generator=cuda)
    acc = torch.randn(1_338_757, device="cuda", generator=cuda)
    ks, ps = ring.Int8Scheme("pallas"), ring.Int8Scheme("xla")
    (kq, ks_), kerr = ks.encode_with_residual(v)
    (pq, ps_), perr = ps.encode_with_residual(v)
    a1, a2 = acc.clone(), acc.clone()
    ks.decode_add((kq, ks_), a1)
    ps.decode_add((pq, ps_), a2)
    outs = [torch.zeros(2, 1_338_768, device="cuda") for _ in "kp"]
    ks.decode_rows([(kq, ks_), (kq, ks_)], outs[0], [1, 0], v.numel())
    ps.decode_rows([(pq, ps_), (pq, ps_)], outs[1], [1, 0], v.numel())
    for got, want in ((kq, pq), (ks_, ps_), (kerr, perr), (a1, a2),
                      (ks.decode((kq, ks_), v.numel()), ps.decode((pq, ps_), v.numel())),
                      tuple(outs)):
        assert _bits_equal(got, want)


# The ring flash chunk kernels K11-K13 vs their plain versions: rank 1 of a
# two-chunk ring (q and dO of chunk 1; K/V of chunk 0 for the full step, of
# chunk 1 for the diagonal), a carry in from the step before, non-zero dq
# and traveling dK/dV accumulators, the lse and delta of the whole rows.
def _ring_case(gen, Lc, H, Hkv, D, dtype):
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    q, do = (torch.randn(1, Lc, H, D, device="cuda", generator=gen).to(dtype) for _ in "ab")
    kv = [torch.randn(1, Lc, Hkv, D, device="cuda", generator=gen).to(dtype) for _ in "abcd"]
    m = torch.full((1, H, Lc), -1e30, device="cuda")
    carry = rf.chunk_fwd_reference(q, kv[2], kv[3], m, torch.zeros_like(m),
                                   torch.zeros(1, Lc, H, D, device="cuda"), True)
    m1, l1, acc1 = rf.chunk_fwd_reference(q, kv[0], kv[1], *carry, False)
    out = (acc1 / l1.transpose(1, 2)[..., None]).to(dtype)
    lse = m1 + torch.log2(l1)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    acc = lambda n: torch.randn(1, Lc, n, D, device="cuda", generator=gen)  # noqa: E731
    return rf, q, do, kv, carry, lse, delta, acc(H), acc(Hkv), acc(Hkv)


@pytest.mark.parametrize("Lc", [32, 384, 1024])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_flash_kernels_match_plain(cuda, Lc, H, Hkv, D, dtype):
    rf, q, do, kv, carry, lse, delta, dq, dk, dv = _ring_case(cuda, Lc, H, Hkv, D, dtype)
    names = ("ring_flash_fwd", "ring_flash_dq", "ring_flash_dkv")
    before = [build.launches[n] for n in names]
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    gtol = BF16_TOL if dtype == torch.bfloat16 else F32_GRAD_TOL
    for causal, (k, v) in ((True, kv[2:]), (False, kv[:2])):
        start = carry if not causal else (torch.full_like(carry[0], -1e30),
                                          torch.zeros_like(carry[1]),
                                          torch.zeros_like(carry[2]))
        got = [t.clone() for t in start]
        rf._launch_fwd(q, k, v, *got, causal)
        want = rf.chunk_fwd_reference(q, k, v, *start, causal)
        gdq, gdk, gdv = dq.clone(), dk.clone(), dv.clone()
        rf._launch_dq(q, k, v, do, lse, delta, gdq, causal)
        rf._launch_dkv(q, k, v, do, lse, delta, gdk, gdv, causal)
        torch.cuda.synchronize()
        assert float((got[0] - want[0]).abs().max()) <= LSE_TOL
        assert float(((got[1] - want[1]) / want[1]).abs().max()) <= LSE_TOL
        _close(got[2], want[2], tol)
        _close(gdq, rf.chunk_dq_reference(q, k, v, do, lse, delta, dq, causal), gtol,
               GRAD_ROW_FLOOR[dtype])
        for g, w in zip((gdk, gdv), rf.chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv,
                                                           causal)):
            _close(g, w, gtol, GRAD_ROW_FLOOR[dtype])
    assert [build.launches[n] - b for n, b in zip(names, before)] == [2, 2, 2]


def _ring_fwd_check(gen, q, k, v, causal):
    """K11 from a random carry (m, l, acc) vs its plain version."""
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    _, Lc, H, D = q.shape
    m = torch.randn(1, H, Lc, device="cuda", generator=gen)
    l = torch.rand(1, H, Lc, device="cuda", generator=gen) + 0.5
    acc = torch.randn(1, Lc, H, D, device="cuda", generator=gen)
    got = [m.clone(), l.clone(), acc.clone()]
    before = build.launches["ring_flash_fwd"]
    rf._launch_fwd(q, k, v, *got, causal)
    torch.cuda.synchronize()
    assert build.launches["ring_flash_fwd"] == before + 1
    want = rf.chunk_fwd_reference(q, k, v, m, l, acc, causal)
    assert float((got[0] - want[0]).abs().max()) <= LSE_TOL
    assert float(((got[1] - want[1]) / want[1]).abs().max()) <= LSE_TOL
    _close(got[2], want[2], BF16_TOL)


# K11 (bf16) at chunk lengths below, at and past one 128-row tile, both step
# kinds; the carry in is random, so padded rows and masked keys show.
@pytest.mark.parametrize("Lc", [32, 100, 129, 200])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_forward_tile_edges(cuda, Lc, H, Hkv, D, causal):
    q = torch.randn(1, Lc, H, D, device="cuda", generator=cuda).bfloat16()
    k = torch.randn(1, Lc, Hkv, D, device="cuda", generator=cuda).bfloat16()
    v = torch.randn(1, Lc, Hkv, D, device="cuda", generator=cuda).bfloat16()
    _ring_fwd_check(cuda, q, k, v, causal)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_forward_reads_gqa_slices(cuda, D, causal):
    """K11 with q, k, v as head slices of one fused GQA projection."""
    H, Hkv = 8, 2
    x = torch.randn(1, 300, H + 2 * Hkv, D, device="cuda", generator=cuda).bfloat16()
    _ring_fwd_check(cuda, x[:, :, :H], x[:, :, H:H + Hkv], x[:, :, H + Hkv:], causal)


def _ring_bwd_check(gen, q, k, v, do, causal):
    """K12 and K13 (bf16) vs their plain versions, with small non-zero
    accumulators in (so the step's own contribution dominates each row) and
    the lse and delta of q's rows over a diagonal and a full step of k/v."""
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    _, Lc, H, D = q.shape
    Hkv = k.shape[2]
    m = torch.full((1, H, Lc), -1e30, device="cuda")
    carry = rf.chunk_fwd_reference(q, k, v, m, torch.zeros_like(m),
                                   torch.zeros(1, Lc, H, D, device="cuda"), True)
    m1, l1, acc1 = rf.chunk_fwd_reference(q, k, v, *carry, False)
    lse = m1 + torch.log2(l1)
    out = (acc1 / l1.transpose(1, 2)[..., None]).to(q.dtype)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = 1e-2 * torch.randn(1, Lc, H, D, device="cuda", generator=gen)
    dk, dv = (1e-2 * torch.randn(1, Lc, Hkv, D, device="cuda", generator=gen) for _ in "ab")
    got = [dq.clone(), dk.clone(), dv.clone()]
    names = ("ring_flash_dq", "ring_flash_dkv")
    before = [build.launches[n] for n in names]
    rf._launch_dq(q, k, v, do, lse, delta, got[0], causal)
    rf._launch_dkv(q, k, v, do, lse, delta, got[1], got[2], causal)
    torch.cuda.synchronize()
    assert [build.launches[n] - b for n, b in zip(names, before)] == [1, 1]
    floor = GRAD_ROW_FLOOR[torch.bfloat16]
    _close(got[0], rf.chunk_dq_reference(q, k, v, do, lse, delta, dq, causal), BF16_TOL, floor)
    for g, w in zip(got[1:], rf.chunk_dkv_reference(q, k, v, do, lse, delta, dk, dv, causal)):
        _close(g, w, BF16_TOL, floor)


# K12 and K13 (bf16) at chunk lengths that end inside and at the edge of
# their 64- and 128-row tiles, both step kinds.
@pytest.mark.parametrize("Lc", [100, 127, 128, 129, 200])
@pytest.mark.parametrize("H,Hkv,D", [(4, 4, 64), (8, 2, 128), (4, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_backward_tile_edges(cuda, Lc, H, Hkv, D, causal):
    q, do = (torch.randn(1, Lc, H, D, device="cuda", generator=cuda).bfloat16() for _ in "ab")
    k, v = (torch.randn(1, Lc, Hkv, D, device="cuda", generator=cuda).bfloat16() for _ in "ab")
    _ring_bwd_check(cuda, q, k, v, do, causal)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_backward_reads_gqa_slices(cuda, D, causal):
    """K12 and K13 with q, k, v as head slices of one fused GQA projection
    and dO a head slice of a wider tensor."""
    H, Hkv = 8, 2
    x = torch.randn(1, 300, H + 2 * Hkv, D, device="cuda", generator=cuda).bfloat16()
    y = torch.randn(1, 300, 2 * H, D, device="cuda", generator=cuda).bfloat16()
    _ring_bwd_check(cuda, x[:, :, :H], x[:, :, H:H + Hkv], x[:, :, H + Hkv:], y[:, :, H:],
                    causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_flash_world1_is_causal_flash(cuda, dtype):
    """A one-rank ring is one diagonal step forward and backward: kernel path
    (K11-K13) vs the plain flash forward and backward (K1-K3's plain
    versions)."""
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm

    q, k, v, do, lse, delta = _bwd_inputs(cuda, 2, 1024, 8, 2, 64, dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = rf.ring_flash_self_attention(q, k, v, Comm())
    grads = torch.autograd.grad(out, (q, k, v), do)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    _close(out, fa.flash_attention_reference(q.detach(), k.detach(), v.detach()), tol)
    want = fa.flash_attention_backward_reference(q.detach(), k.detach(), v.detach(), do,
                                                 lse, delta)
    for g, w in zip(grads, want):
        _close(g, w, BF16_TOL if dtype == torch.bfloat16 else F32_GRAD_TOL,
               GRAD_ROW_FLOOR[dtype])


def test_ring_flash_kernels_refuse_what_they_do_not_take(cuda):
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    q = torch.randn(1, 64, 4, 48, device="cuda")
    kv = torch.randn(1, 64, 2, 48, device="cuda")
    m = torch.zeros(1, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        rf._chunk_fwd(q, kv, kv, m, m.clone(), torch.zeros(1, 64, 4, 48, device="cuda"), True)
    q, kv = q[..., :32].half(), kv[..., :32].half()
    with pytest.raises(ValueError, match="bf16 or f32"):
        rf._chunk_fwd(q, kv, kv, m, m.clone(), torch.zeros(1, 64, 4, 32, device="cuda"), True)
    q, kv = q.float(), kv.float()
    with pytest.raises(ValueError, match="contiguous f32"):
        rf._chunk_dq(q, kv, kv, q, m, m, torch.zeros(1, 4, 64, 32, device="cuda"), True)


# -- the flat-shard and per-layer trainers on the card ------------------------------
FLAT_STEPS = 3
PL_MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1)


def _flat_rank(rank, world, init_method):
    """ZeRO-1 and FSDP's CNN step (VGGTEST, AdamW fused: K7 on each rank's
    shard; rank 1's ZeRO-1 slice misaligned), sync and overlap, and
    fsdp_pl's LM step (flash, bf16), on the card in 2 ranks."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.models.vgg import VGG, init_vgg
    from distributed_machine_learning_tpu_torch.parallel import fsdp, zero1
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )
    from distributed_machine_learning_tpu_torch.train.adamw import AdamWConfig
    from distributed_machine_learning_tpu_torch.train.state import TrainState

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method,
                                timeout_s=120)
    comm, dev = ctx.comm, ctx.device
    gen = torch.Generator().manual_seed(rank)
    x = torch.randint(0, 256, (8, 32, 32, 3), generator=gen, dtype=torch.uint8).to(dev)
    y = torch.randint(0, 10, (8,), generator=gen).to(dev)
    out = {}
    try:
        for scheme, (shard, make) in (("zero1", (zero1.shard_zero1_state,
                                                 zero1.make_zero1_train_step)),
                                      ("fsdp", (fsdp.shard_fsdp_state,
                                                fsdp.make_fsdp_train_step))):
            for overlap in (False, True):
                model = init_vgg(VGG("VGGTEST", use_bn=True, device=dev), 0)
                state, unravel, n = shard(TrainState.create(model, AdamWConfig(fused=True)),
                                          comm)
                step = make(model, comm, unravel, n, augment=True, overlap=overlap)
                build.reset_launch_counts()
                losses = [float(step(state, x, y)[1]) for _ in range(FLAT_STEPS)]
                full = step.join(state) if overlap else None
                params = (zero1.zero1_params(state, unravel, n) if scheme == "zero1"
                          else fsdp.gather_fsdp_params(state, unravel, n, comm, full=full))
                if overlap:
                    step.close()
                # numpy, not tensors: a tensor crosses the result queue as a
                # shared-memory handle that dies with this process
                out[(scheme, overlap)] = (losses, build.launches["fused_adamw"],
                                          torch.cat([p.reshape(-1) for p in params.values()])
                                          .cpu().numpy(), n)
        args = lm.make_parser().parse_args([
            "--parallel", "fsdp_pl", "--num-nodes", str(world), "--rank", str(rank),
            "--d-model", "128", "--n-layers", "2", "--n-heads", "2", "--n-kv-heads", "1",
            "--vocab", "256", "--seq-len", "512", "--batch-size", "4",
            "--compute-dtype", "bfloat16", "--fused-update", "--attn", "flash",
            "--max-iters", str(FLAT_STEPS)])
        step, state, place, model = lm.build(args, ctx)
        build.reset_launch_counts()
        losses = [float(step(state, *place(a, b))[1]) for a, b in lm.synthetic_batches(args)]
        torch.cuda.synchronize()
        out["fsdp_pl"] = (losses, dict(build.launches), sum(1 for _ in model.parameters()),
                          {k: v.float().cpu().numpy() for k, v in step.params_fn(state).items()})
        return out
    finally:
        ctx.shutdown()


def test_flat_and_per_layer_trainers_on_the_card(cuda):
    """In 2 ranks sharing the card: ZeRO-1's and FSDP's CNN steps launch K7
    once a step a rank (rank 1's ZeRO-1 slice starts off a 16-byte boundary:
    the step updates an aligned copy), their overlap builds bit for bit the
    sync builds; fsdp_pl launches K1-K3 n_layers a step and K7 once a leaf a
    step, its ranks agree bit for bit, and its losses match one-process dp
    (flash, bf16) within 1e-3 relative (the same bf16 products, another
    batch split)."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    ranks = spawn(_flat_rank, 2, timeout_s=600)
    for r, out in enumerate(ranks):
        for scheme in ("zero1", "fsdp"):
            sync, over = out[(scheme, False)], out[(scheme, True)]
            if scheme == "zero1":
                assert (sync[3] // 2) % 4 != 0  # the misaligned slice
            assert sync[1] == over[1] == FLAT_STEPS, (r, scheme)
            assert sync[0] == over[0] and (sync[2] == over[2]).all(), (r, scheme)
        losses, launches, leaves, _ = out["fsdp_pl"]
        assert launches["fused_adamw"] == leaves * FLAT_STEPS
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == PL_MODEL["n_layers"] * FLAT_STEPS, name
    for k, v in ranks[0]["fsdp_pl"][3].items():
        assert (ranks[1]["fsdp_pl"][3][k] == v).all(), k
    args = lm.make_parser().parse_args([
        "--d-model", "128", "--n-layers", "2", "--n-heads", "2", "--n-kv-heads", "1",
        "--vocab", "256", "--seq-len", "512", "--batch-size", "4", "--compute-dtype",
        "bfloat16", "--fused-update", "--attn", "flash", "--max-iters", str(FLAT_STEPS)])
    step, state, place, _ = lm.build(args)
    dp = [float(step(state, *place(a, b))[1]) for a, b in lm.synthetic_batches(args)]
    for a, b in zip(ranks[0]["fsdp_pl"][0], dp):
        assert abs(a - b) <= 1e-3 * abs(b), (ranks[0]["fsdp_pl"][0], dp)


def test_speculative_and_moe_on_the_card(cuda):
    """The A8 serving paths on the card, in f32 (exact greedy headroom):
    speculative decoding with a head-dim-32 target and draft (K1 prefills
    both; the draft's decode steps take K4 at S 4096; the verify pass takes
    neither) gives vanilla greedy's tokens, at B 1 and batched (per-row
    frontiers: no K4); an MoE model's cached decode on the card (experts
    through the dropless grouped path) gives its teacher-forced argmax."""
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.inference.generate import make_generate_fn
    from distributed_machine_learning_tpu_torch.inference.speculative import (
        make_speculative_generate_fn,
    )
    from distributed_machine_learning_tpu_torch.models.moe import MoETransformerLM

    target = transformer.TransformerLM(vocab_size=512, d_model=128, n_layers=2, n_heads=4,
                                       n_kv_heads=2, device="cuda")
    draft = transformer.TransformerLM(vocab_size=512, d_model=64, n_layers=1, n_heads=2,
                                      device="cuda")
    init_params(target, seed=0)
    init_params(draft, seed=7)
    prompt = torch.randint(0, 512, (4, 4000), generator=cuda, device="cuda")
    for rows in (prompt[:1], prompt):
        build.reset_launch_counts()
        fn = make_speculative_generate_fn(target, draft, 16, gamma=3)
        got = fn(rows)
        launches = dict(build.launches)
        assert torch.equal(got, make_generate_fn(target, 16)(rows))
        assert launches["flash_fwd"] == 3
        want_k4 = fn.stats["rounds"] * 4 if rows.shape[0] == 1 else 0
        assert launches["decode_attention"] == want_k4, (launches, fn.stats)
    moe = MoETransformerLM(vocab_size=256, d_model=64, n_layers=2, n_heads=2,
                           n_experts=4, moe_impl="grouped", device="cuda")
    init_params(moe, seed=3)
    short = torch.randint(0, 256, (2, 8), generator=cuda, device="cuda")
    out = make_generate_fn(moe, 6)(short)
    with torch.no_grad():
        full = moe(out)
    assert torch.equal(out[:, 8:], full[:, 7:-1].argmax(-1))


def test_model_parallel_paths_on_the_card(cuda):
    """The training-time TP layout at W 1 (Megatron's f/g pair, the
    vocabulary-split embedding and head, the vocabulary-parallel loss) on the
    card, f32, flash attention: its loss and every gradient against the plain
    model's on the same weights and batch (summation order only), the loss
    against ``F.cross_entropy``; then ``cli.lm --parallel pp`` (1F1B) and
    ``--parallel 3d`` at one rank each: K1-K3 once a layer a microbatch and
    K7 once a leaf a step, losses finite."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.convert import init_params
    from distributed_machine_learning_tpu_torch.parallel.tensor_parallel import (
        tp_lm_loss,
        vocab_parallel_cross_entropy,
    )
    from distributed_machine_learning_tpu_torch.runtime.distributed import Comm
    from distributed_machine_learning_tpu_torch.train.losses import lm_cross_entropy

    shape = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                 attn_impl="flash")
    plain = transformer.TransformerLM(**shape, device="cuda")
    init_params(plain, seed=1)
    tp = transformer.TransformerLM(**shape, device="cuda", vocab_parallel="both",
                                   tp_comm=Comm(0, 1, "nccl", torch.device("cuda", 0)))
    tp.load_state_dict(plain.state_dict())
    x = torch.randint(0, 512, (2, 512), generator=cuda, device="cuda")
    y = torch.randint(0, 512, (2, 512), generator=cuda, device="cuda")
    build.reset_launch_counts()
    want = lm_cross_entropy(plain(x), y)
    want.backward()
    got = tp_lm_loss(tp, x, y)
    got.backward()
    assert dict(build.launches)["flash_bwd_dq"] == 4
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    grads = dict(tp.named_parameters())
    for name, p in plain.named_parameters():
        g, w = grads[name].grad, p.grad
        assert float((g - w).norm() / w.norm()) <= 1e-4, name
    logits = torch.randn(64, 512, generator=cuda, device="cuda") * 4
    targets = torch.randint(0, 512, (64,), generator=cuda, device="cuda")
    ce = vocab_parallel_cross_entropy(logits, targets, Comm(0, 1))
    ref = torch.nn.functional.cross_entropy(logits, targets)
    assert abs(float(ce) - float(ref)) <= 1e-6 * abs(float(ref))
    for scheme in (["pp", "--microbatches", "2"], ["3d", "--dp", "1", "--pp", "1", "--tp", "1",
                                                   "--microbatches", "2"]):
        args = lm.make_parser().parse_args([
            "--parallel", *scheme, "--d-model", "128", "--n-layers", "2", "--n-heads", "4",
            "--n-kv-heads", "2", "--vocab", "512", "--seq-len", "512", "--batch-size", "4",
            "--compute-dtype", "bfloat16", "--fused-update", "--attn", "flash",
            "--max-iters", "2"])
        step, state, place, model = lm.build(args)
        build.reset_launch_counts()
        losses = [float(step(state, *place(a, b))[1]) for a, b in lm.synthetic_batches(args)]
        launches = dict(build.launches)
        assert all(math.isfinite(v) for v in losses), (scheme, losses)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches[name] == 2 * 2 * 2, (scheme, name, launches)
        assert launches["fused_adamw"] == 2 * sum(1 for _ in model.parameters()), scheme


EP_FLAGS = ["--parallel", "ep", "--moe-impl", "grouped", "--ep", "2", "--ep-seq", "2",
            "--n-experts", "4", "--d-model", "128", "--n-layers", "2", "--n-heads", "4",
            "--n-kv-heads", "2", "--vocab", "512", "--seq-len", "2048", "--batch-size", "2",
            "--compute-dtype", "bfloat16", "--fused-update", "--attn", "flash",
            "--max-iters", "2"]


def _ep_rank(rank, world, init_method):
    """``cli.lm --parallel ep --moe-impl grouped --ep-seq 2`` in 4 ranks
    sharing the card (dp 1 x ep 2 x seq 2, chunk 1024: ring_flash), then one
    more K7 update of this rank's block of the first ``w_in`` (its 2 of the
    4 experts, with the moments the run left) against the plain version."""
    from distributed_machine_learning_tpu_torch.cli import lm
    from distributed_machine_learning_tpu_torch.runtime.distributed import (
        initialize_from_flags,
    )

    ctx = initialize_from_flags(rank=rank, num_nodes=world, init_method=init_method,
                                timeout_s=120)
    try:
        args = lm.make_parser().parse_args([*EP_FLAGS, "--num-nodes", str(world),
                                            "--rank", str(rank)])
        step, state, place, model = lm.build(args, ctx)
        build.reset_launch_counts()
        losses = [float(step(state, *place(a, b))[1]) for a, b in lm.synthetic_batches(args)]
        torch.cuda.synchronize()
        launches = dict(build.launches)
        name = "blocks.0.moe.w_in"
        p, mu, nu = (state.params[name].detach(), state.momentum["mu"][name],
                     state.momentum["nu"][name])
        g = 1e-3 * torch.randn(p.shape, device=p.device,
                               generator=torch.Generator(p.device).manual_seed(rank))
        got = [t.clone() for t in (p, mu, nu, g)]
        want = [t.clone() for t in (p, mu, nu, g)]
        hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
        scalars = (3e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3)
        fadam.fused_adamw_leaf(*got, *scalars, **hyper)
        torch.cuda.synchronize()
        fadam.fused_adamw_reference(*want, *scalars, **hyper)
        terms = ([p], [0.9 * mu, 0.1 * g], [0.999 * nu, 0.001 * g * g])
        ulps = [_ulp_err(got[i], want[i], *terms[i]) for i in range(3)]
        return (losses, launches, sum(1 for _ in model.parameters()), model.attn_impl,
                step.mesh["seq"].rank, tuple(p.shape), ulps)
    finally:
        ctx.shutdown()


def test_expert_parallel_paths_on_the_card(cuda):
    """In 4 ranks sharing the card, ``--parallel ep --moe-impl grouped
    --ep-seq 2``: the ring flash kernels K11-K13 n_layers x (seq rank + 1) a
    step, K1-K3 never (the sequence is sharded), K7 once a local leaf a step
    (each rank's expert leaves its 2 of 4 experts), losses finite and equal
    on every rank; K7 on an expert shard within 8 ulp of the plain
    version."""
    from distributed_machine_learning_tpu_torch.runtime.launch import spawn

    ranks = spawn(_ep_rank, 4, timeout_s=600)
    for losses, launches, leaves, attn, seq_rank, shard, ulps in ranks:
        assert attn == "ring_flash" and shard == (2, 128, 512)
        assert all(math.isfinite(v) for v in losses) and losses == ranks[0][0]
        assert launches["fused_adamw"] == leaves * 2
        for name in ("ring_flash_fwd", "ring_flash_dq", "ring_flash_dkv"):
            assert launches[name] == 2 * (seq_rank + 1) * 2, (name, launches)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert launches.get(name, 0) == 0, (name, launches)
        assert max(ulps) <= ADAMW_ULP_TOL, ulps
