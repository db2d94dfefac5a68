#!/usr/bin/env python3
"""Kernel and prefill timings of one checkout, for parent-vs-change pairs.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/ab_kernels.py TREE [--codec-only]

TREE is a directory holding a checkout of the repo (this one, or an older
commit unpacked with ``git archive``).  Imports that tree's
``chip_smoke.py`` and port package (nothing of the running checkout),
builds its kernels into ``TREE/build/kernels``, runs its kernel checks
with their timings (K1, K4 in both modes, K6, K2/K3, K11-K13; each beside
its library call), times K5 at the engine's decode step (inputs built
here: :func:`paged_step_inputs`; called through ``paged_flash_attention``,
whose signature every tree shares; beside the gather of the pages + SDPA),
then times its bf16 and int8-weight generate (prefill + first token and the
decode step, ``chip_smoke.time_serving``).  The int8 ring codec: the
tree's ``check_codec`` (bit for bit), then K8 with and without the
residual, K9 and K10 at the VGG path's four chunk lengths, operands rotated
out of L2 (``chip_smoke.time_codec``), and the ring all-gather's decode
work per ring call at the path's four (world, chunk) points: a tree whose
ring decodes row by row (no ``ring_codec.decode_rows_int8``) is timed
here on a copy of that loop (:func:`rowwise_allgather`), with the same
harness, bound and library call as the tree's ``time_allgather`` that
times one batched call.  ``--codec-only`` builds ``ring_codec.cu`` alone
and times the codec alone.
Prints one line per timed kernel and a last JSON line of every row's
numbers.  Compare two versions inside one call, in turns: parent, change,
change, parent.
"""

import json
import math
import sys
import time
from pathlib import Path

# The lanes' positions at the engine decode step that chip_smoke.py's engine
# phase times K5 at (its seeded traffic gives these; it logs them).
ENGINE_STEP_POSITIONS = (4097, 301, 2944, 3504, 2193, 1808, 3697, 650)


# The all-gather's (world, chunk length) points, as chip_smoke.CODEC_ALLGATHER.
ALLGATHER = ((4, 1_638_400), (4, 669_379), (2, 3_276_800), (2, 1_338_757))


def time_codec(torch, smoke, rc, rows: dict) -> None:
    """The tree's codec checks and timings; for a tree whose all-gather
    decodes row by row, that loop's timing too."""
    smoke.check_codec(torch, rc, rows, False)
    smoke.time_codec(torch, rc, rows)
    if not hasattr(rc, "decode_rows_int8"):
        time_rowwise_allgather(torch, smoke, rc, rows)


def rowwise_allgather(torch, rc, payloads, order, stride: int, n: int):
    """The all-gather's decode as ``ops/ring.py`` did it before the batched
    K10 (its lines 220-233 at the parent commit): a zeroed out, then a K10
    call and a copy into the row for each payload."""
    out = torch.zeros(len(payloads), stride, device="cuda")
    for (q, scale), i in zip(payloads, order):
        out[i, :n] = rc.decode_int8(q, scale, n)
    return out


def time_rowwise_allgather(torch, smoke, rc, rows: dict) -> None:
    """:func:`rowwise_allgather` at each ALLGATHER point, timed as the
    batched call's ``chip_smoke.time_allgather`` times it (operands rotated
    out of L2, the same bound and library call), under the same row keys."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    for world, n in ALLGATHER:
        sets = max(smoke.CODEC_SETS, math.ceil(smoke.CODEC_ROTATE_BYTES / (5 * world * n)))
        stride = -(-n // 16) * 16
        order = [1 % world] + [(-s) % world for s in range(world - 1)]
        cases = [[rc.encode_int8(0.01 * torch.randn(n, device="cuda", generator=gen))
                  for _ in range(world)] for _ in range(sets)]
        outs = [torch.empty(world, stride, device="cuda") for _ in range(sets)]
        stacked = [(torch.stack([q for q, _ in p]), torch.cat([s for _, s in p])) for p in cases]

        def library(i):
            q2d, scales = stacked[i]
            torch.mul(q2d, scales.view(-1, 1), out=outs[i][:, :n])

        def per_call(fn, iters: int = 10) -> float:
            return smoke.time_ms(lambda: [fn(i) for i in range(sets)], iters=iters) / sets

        key = f"ring_decode_int8:rows={world},n={n}"
        rows[key] = dict(
            ms=per_call(lambda i: rowwise_allgather(torch, rc, cases[i], order, stride, n)),
            library_ms=per_call(library),
            **smoke.bound(1.0 * world * n, smoke.F32_FLOPS, 5 * world * n + 4 * world))
        smoke.log(f"  {key}, row by row (zeroed out, {world} K10 calls and row copies): "
                  f"{rows[key]['ms']:.5f} ms, bound {rows[key]['bound_ms']:.5f}, library "
                  f"{rows[key]['library_ms']:.5f}")
        del cases, outs, stacked


def paged_step_inputs(torch, smoke):
    """K5's inputs at the engine's decode step, as ``chip_smoke.ENGINE``
    lays them out: bf16 pools of 2080 blocks of 16 slots plus the scratch
    block, 4 kv heads of 128; 8 lanes at ENGINE_STEP_POSITIONS, each
    lane's table a run of a seeded permutation of the pool's blocks up to
    its frontier and the scratch block past it; a random bf16 query of 16
    heads."""
    H, Hkv = smoke.MODEL["n_heads"], smoke.MODEL["n_kv_heads"]
    D = smoke.MODEL["d_model"] // H
    bs, n = smoke.ENGINE["block_size"], smoke.ENGINE["num_blocks"]
    mb = smoke.ENGINE["max_len"] // bs
    gen = torch.Generator(device="cuda").manual_seed(5)
    perm = torch.randperm(n, generator=gen, device="cuda").int()
    tables = torch.full((len(ENGINE_STEP_POSITIONS), mb), n, dtype=torch.int32, device="cuda")
    take = 0
    for w, p in enumerate(ENGINE_STEP_POSITIONS):
        tables[w, :p // bs + 1] = perm[take:take + p // bs + 1]
        take += p // bs + 1
    k, v = (torch.randn(n + 1, Hkv, bs, D, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    q = torch.randn(len(ENGINE_STEP_POSITIONS), 1, H, D, device="cuda", generator=gen).bfloat16()
    positions = torch.tensor(ENGINE_STEP_POSITIONS, dtype=torch.int32, device="cuda")
    return q, k, v, tables, positions


def time_paged_step(torch, smoke, da, rows: dict) -> None:
    """K5 at the engine's decode step against its plain version (the row
    gates), timed beside its bytes bound and the gather of the pages into a
    dense cache + SDPA (two PyTorch calls, context only)."""
    q, k, v, tables, positions = paged_step_inputs(torch, smoke)
    W, H, (Hkv, bs, D) = q.shape[0], q.shape[2], k.shape[1:]
    failed = []
    err = smoke.compare(f"paged_attention engine step positions {list(ENGINE_STEP_POSITIONS)}",
                        da.paged_flash_attention(q, k, v, tables, positions),
                        da.paged_attention_reference(q, k, v, tables, positions), failed)
    smoke.raise_failed(failed)
    n = sum(p + 1 for p in ENGINE_STEP_POSITIONS)
    nbytes = (2 * n * Hkv * D * 2 + 4 * sum(p // bs + 1 for p in ENGINE_STEP_POSITIONS)
              + 4 * W + 2 * W * H * D * 2)
    S = tables.shape[1] * bs
    mask = torch.arange(S, device="cuda")[None, :] <= positions[:, None].long()

    def gather_sdpa():
        kd = k[tables.long()].transpose(1, 2).reshape(W, Hkv, S, D)
        vd = v[tables.long()].transpose(1, 2).reshape(W, Hkv, S, D)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), kd.repeat_interleave(H // Hkv, 1),
            vd.repeat_interleave(H // Hkv, 1), attn_mask=mask[:, None, None, :])

    row = rows["paged_attention:engine_step"] = dict(
        max_abs_err=err,
        ms=smoke.time_ms(lambda: da.paged_flash_attention(q, k, v, tables, positions),
                         iters=50),
        context_ms=smoke.time_ms(gather_sdpa, iters=20),
        **smoke.bound(4.0 * H * D * n, smoke.F32_FLOPS, nbytes))
    smoke.log(f"  paged_attention at the engine step: {row['ms']:.4f} ms, "
              f"{nbytes / row['ms'] / 1e6:.1f} GB/s, bound {row['bound_ms']:.4f} ms, "
              f"gather + SDPA {row['context_ms']:.4f} ms")


def main(argv) -> int:
    codec_only = "--codec-only" in argv
    argv = [a for a in argv if a != "--codec-only"]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[0]).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as smoke
    import distributed_machine_learning_tpu_torch as pkg
    from distributed_machine_learning_tpu_torch.ops import build
    from distributed_machine_learning_tpu_torch.ops import decode_attention as da
    from distributed_machine_learning_tpu_torch.ops import flash_attention as fa
    from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm
    from distributed_machine_learning_tpu_torch.ops import ring_codec as rc
    from distributed_machine_learning_tpu_torch.ops import ring_flash_attention as rf

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    if Path(smoke.__file__).resolve().parent != tree:
        raise RuntimeError(f"imported {smoke.__file__}, not the tree's chip_smoke.py")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"tree {tree}; card: {smoke.card_line()}")
    t0 = time.perf_counter()
    build.build_all(["ring_codec"] if codec_only else build.SOURCES)
    smoke.log(f"build {time.perf_counter() - t0:.1f} s")
    rows: dict = {}
    time_codec(torch, smoke, rc, rows)
    if codec_only:
        return report(tree, rows)
    smoke.check_flash(torch, fa, rows, True)
    smoke.check_decode(torch, da, rows, True)
    smoke.check_decode_int8(torch, da, rows, True)
    smoke.check_int8(torch, qm, rows, True)
    time_paged_step(torch, smoke, da, rows)
    smoke.check_flash_bwd(torch, fa, rows, True)
    smoke.check_ring_flash(torch, rf, rows, True)
    models, prompt = smoke.make_models(torch, pkg)
    fns = smoke.generate_fns(models)
    for mode in ("bf16", "int8"):
        smoke.time_serving(torch, mode, models[mode], fns[mode], prompt)
    return report(tree, rows)


def report(tree: Path, rows: dict) -> int:
    keep = ("ms", "library_ms", "context_ms", "bound_ms", "diag_ms")
    print(json.dumps({"tree": str(tree), "rows": {
        name: {k: row[k] for k in keep if row.get(k) is not None}
        for name, row in rows.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
