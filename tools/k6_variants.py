#!/usr/bin/env python3
"""Where K6's wgmma route spends its time: timed variants of the mainloop.

Run from the root of a checkout on a machine with a CUDA card:
    python3 tools/k6_variants.py

Builds ``ops/csrc/quant_matmul.cu`` as it is and in variants that each
leave one piece of work out (under ``build/k6_variants/``; the checkout is
not touched), all with ``ops/build.py``'s flags and one nvcc each, in
parallel.  Times each variant's wgmma route (CUDA events, 10 calls after 2)
at the LM's prefill shapes (R = 8 x 4096: the q/out, kv, fc_in and fc_out
projections) beside one ``torch.matmul`` on the dequantized bf16 weight.
The variants other than ``kernel`` compute wrong products on purpose:
their error against the plain version is printed, and only their times
mean anything.

- ``kernel``: the source as it is;
- ``no-widen-stores``: the widening loads and converts but stores nothing;
- ``no-widening``: no widening at all (wgmma reads a stale buffer);
- ``no-epilogue-store``: every TMA store of the output tile skipped.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from distributed_machine_learning_tpu_torch.ops import build  # noqa: E402
from distributed_machine_learning_tpu_torch.ops import quant_matmul as qm  # noqa: E402

STORES = ("        *reinterpret_cast<uint4*>(row + ((p ^ (r & 7)) << 4)) = lo;\n"
          "        *reinterpret_cast<uint4*>(row + (((p + 1) ^ (r & 7)) << 4)) = hi;")
# name: [(text in quant_matmul.cu, replacement), ...]
VARIANTS = {
    "kernel": [],
    "no-widen-stores": [(STORES, "        if (K < 0) {\n" + STORES + "\n        }")],
    "no-widening": [("    widen(0);\n", "\n"), ("        widen(j + 1);\n", "\n")],
    "no-epilogue-store": [("if (col0 + b * COLS < K) tma_store_2d",
                           "if (K < 0) tma_store_2d")],
}
# (R, D, K) of the prefill projections: q and out, kv, fc_in, fc_out.
SHAPES = [(32768, 2048, 2048), (32768, 2048, 1024), (32768, 2048, 8192), (32768, 8192, 2048)]


def build_variants(source: str, variants: dict, dest: str) -> dict:
    """{name: loaded library} of ``ops/csrc/<source>.cu`` with each variant's
    edits ([(text, replacement), ...], each text there once), built under
    ``build/<dest>/<source>/<name>/`` with ``ops/build.py``'s flags, one
    nvcc each, in parallel."""
    text0 = (build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, edits in variants.items():
        text = text0
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{source} {name}: the text to edit is not there once")
            text = text.replace(old, new)
        d = build.BUILD_DIR.parent / dest / source / name
        d.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            (d / header.name).write_text(header.read_text())
        (d / f"{source}.cu").write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), d)
    libs = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"{source} {name}: nvcc exit {proc.returncode}\n{log}")
        libs[name] = ctypes.CDLL(str(d / "lib.so"))
    return libs


def w8a16_functions(libs: dict) -> dict:
    """{name: the library's ``w8a16_matmul``, typed}."""
    fns = {}
    for name, lib in libs.items():
        fn = lib.w8a16_matmul
        fn.argtypes, fn.restype = qm._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def event_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(f"card: {card.stdout.strip()}", flush=True)
    fns = w8a16_functions(build_variants("quant_matmul", VARIANTS, "k6_variants"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    wgmma = qm.ROUTES.index("wgmma")
    for R, D, K in SHAPES:
        x = torch.randn(R, D, device="cuda", generator=gen).bfloat16()
        q, s = qm.quantize_int8(torch.randn(D, K, device="cuda", generator=gen) / D ** 0.5)
        wd = (q.float() * s).bfloat16()
        out = torch.empty(R, K, device="cuda", dtype=torch.bfloat16)
        want = qm.int8_matmul_reference(x, q, s).float()
        tflop = 2.0 * R * D * K / 1e9
        lib = event_ms(lambda: torch.matmul(x, wd))
        cells = [f"torch.matmul (bf16 weight) {lib:.4f} ms {tflop / lib:.0f} TFLOP/s"]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for name, fn in fns.items():
            def call(fn=fn):
                status = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                            R, D, K, 1, 1, wgmma, stream)
                if status:
                    raise RuntimeError(f"{name}: cudaError_t {status}")
            call()
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            ms = event_ms(call)
            cells.append(f"{name} {ms:.4f} ms {tflop / ms:.0f} TFLOP/s (max err {err:.2e})")
        print(f"R={R} D={D} K={K}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
