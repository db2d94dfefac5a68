"""Build and load the port's CUDA kernels; count their launches.

Each ``ops/csrc/<name>.cu`` has a plain C interface and is compiled on
its own by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repo
root (git-ignored) the first time a wrapper needs it, then loaded with
``ctypes``.  The library name carries a hash of the source, of every
shared header (``csrc/*.cuh``) and of the flags, so an edited source or
header is never served by a stale build.  ``build_all``
starts one ``nvcc`` per source at once, so the kernels build in
parallel.  A failed build raises with the compiler's output.

``launches`` holds one plain int per kernel (``KERNELS``; one source may
hold several, as ``decode_attention.cu`` holds K4's bf16/f32 and int8
modes, ``flash_bwd.cu`` dQ and dK/dV, ``ring_codec.cu`` the three codec
kernels and ``ring_flash.cu`` the three ring chunk steps).  A wrapper adds one where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels
(``reset_launch_counts`` zeroes them).  Serving replicas are threads of
one process that launch from several threads at once, so a count moves
under a lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd", "flash_bwd", "decode_attention", "quant_matmul",
           "paged_attention", "fused_adamw", "ring_codec", "ring_flash")
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
           "decode_attention_int8", "quant_matmul", "paged_attention", "fused_adamw",
           "ring_encode_int8", "ring_decode_add_int8", "ring_decode_int8", "ring_flash_fwd",
           "ring_flash_dq", "ring_flash_dkv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: dict[str, int] = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_sms: dict = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every named source not built yet, one ``nvcc`` process per
    source, all started together.  Returns the wall seconds each build
    took (0.0 for a library already on disk); raises on any failure.
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept in ``build/kernels/<name>.log``."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        seconds = {}
        for name in names:
            out = _target(name)
            if out.exists():
                seconds[name] = 0.0
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, out, time.perf_counter(),
            )
        failures = []
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            (BUILD_DIR / f"{name}.log").write_text(log)
            if proc.returncode != 0:
                failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                tmp.replace(out)
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(name: str, symbol: str, argtypes: list):
    """C entry point ``symbol`` of source ``name`` with its argument types
    declared (every pointer and the stream as ``c_void_p``) and a
    cudaError_t (int) result."""
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(status: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a nonzero cudaError_t."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {status}")


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (cached per device)."""
    if device not in _sms:
        import torch

        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
