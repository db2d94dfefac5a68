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


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, tol):
    elem_tol, rms_tol = tol
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    assert torch.isfinite(got).all()
    err = got - want
    tiny = torch.finfo(torch.float32).tiny
    elem = err.abs().amax(-1) / want.abs().amax(-1).clamp_min(tiny)
    rms = err.square().mean(-1).sqrt() / want.square().mean(-1).sqrt().clamp_min(tiny)
    assert float(elem.max()) <= elem_tol, f"worst row elem error {float(elem.max()):.3e}"
    assert float(rms.max()) <= rms_tol, f"worst row rms error {float(rms.max()):.3e}"


@contextlib.contextmanager
def plain_kernels():
    """The model's kernel entry points routed to their plain versions."""
    swaps = [(transformer, "flash_self_attention", fa.flash_attention_reference),
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


@pytest.mark.parametrize("bs", [4, 16, 128])
@pytest.mark.parametrize("D", [64, 128])
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
