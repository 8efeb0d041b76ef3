"""Hopper kernel registry, shared padding, and the kernel library build.

Counterpart of ``onnx_quantize_tpu/ops/kernels/__init__.py``. Matmul kernels
register by predicate; :func:`select_kernel` returns the first whose predicate
covers a QTensor's config. The attention kernels (``flash_attention``,
``flash_decode``) and the fused MLP (``mlp_w4``) are called by the model
directly. Each kernel module holds
a wrapper that launches its CUDA kernel for CUDA tensors and runs the
kernel's plain PyTorch version for CPU tensors.

The CUDA sources in ``onnx_quantize_tpu_torch/csrc`` are compiled at first
use with ``nvcc`` for ``sm_90a`` (one nvcc process per source, all at once,
then one link) into a shared library with a plain C interface, cached under
``onnx_quantize_tpu_torch/_build`` by a hash of the sources, and loaded with
ctypes. Nothing is compiled or loaded on import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

__all__ = ["register_kernel", "select_kernel", "pad_to_multiple", "kernel_library",
           "build_kernel_library", "check_launch", "ptr", "stream_ptr", "four_columns_fill",
           "split_scratch"]

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_KERNELS: list[tuple[Callable, Callable]] = []  # (predicate, kernel entry)
_LIBRARY: ctypes.CDLL | None = None


def register_kernel(predicate: Callable) -> Callable:
    def deco(fn: Callable) -> Callable:
        _KERNELS.append((predicate, fn))
        return fn

    return deco


def select_kernel(x, qt, bias):
    for predicate, kernel in _KERNELS:
        if predicate(x, qt, bias):
            return kernel
    return None


def pad_to_multiple(t: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """Zero-pad ``dim`` of ``t`` up to a multiple of ``multiple``."""
    pad = (-t.shape[dim]) % multiple
    if pad == 0:
        return t
    widths = [0, 0] * t.ndim
    widths[2 * (t.ndim - 1 - (dim % t.ndim)) + 1] = pad
    return torch.nn.functional.pad(t, widths)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_kernel_library() -> tuple[Path, str, float]:
    """Compile ``csrc/*.cu`` into the cached library if it is not built yet.

    Returns ``(library path, nvcc log, seconds spent building)``; the log and
    time are from the build that made the file (read back from the cache).
    """
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib_path = BUILD_DIR / f"liboqt_kernels_{digest.hexdigest()[:16]}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    outputs = [proc.communicate()[0] for proc in procs]
    steps = [(f"nvcc -c {src.name}", proc.returncode, out)
             for src, proc, out in zip(sources, procs, outputs)]
    if all(rc == 0 for _, rc, _ in steps):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        steps.append(("nvcc -shared", link.returncode, link.stdout + link.stderr))
    for obj in objects:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(f"== {name}\n{out}" for name, _, out in steps)
    if any(rc != 0 for _, rc, _ in steps):
        raise RuntimeError(f"kernel build failed:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    return lib_path, log, seconds


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIBRARY
    if _LIBRARY is None:
        lib_path, _, _ = build_kernel_library()
        lib = ctypes.CDLL(str(lib_path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.oqt_w4_matmul.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p]
        lib.oqt_w4_matmul.restype = i
        lib.oqt_w8_matmul.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p]
        lib.oqt_w8_matmul.restype = i
        lib.oqt_w4a8_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p]
        lib.oqt_w4a8_matmul.restype = i
        lib.oqt_w8a8_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.oqt_w8a8_matmul.restype = i
        lib.oqt_flash_decode.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.oqt_flash_decode.restype = i
        lib.oqt_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                            ctypes.POINTER(ctypes.c_longlong), i, i, i, i, p]
        lib.oqt_flash_attention.restype = i
        lib.oqt_q8_matmul.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                      i, i, i, i, p, p, p]
        lib.oqt_q8_matmul.restype = i
        lib.oqt_mlp_w4.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.oqt_mlp_w4.restype = i
        _LIBRARY = lib
    return _LIBRARY


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def four_columns_fill(N: int, sms: int) -> bool:
    """Give each thread 4 adjacent columns (one 32-bit load per weight row)
    when N allows it and the wider blocks still fill each of ``sms`` SMs once."""
    return N % 4 == 0 and -(-N // 128) >= sms


# Scratch of the K split of the tensor-core kernels (W4, W8, Q8, W4A8), per
# (device, stream, plan type, tiles, splits, scratch size): the partials
# (4-byte elements: float32 tiles for W4 and W8, int32 tiles for Q8, int32
# per-group dots and row sums for W4A8) and one counter a tile, made zeroed
# once. Each kernel leaves every counter at 0 when it ends (W4A8 its partials
# too, which it adds into). Launches that share an entry run in the order of
# their one stream (or of a graph replayed on it).
SPLIT_SCRATCH: dict = {}


def split_scratch(device: torch.device, plan) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials, counters) for a launch ``plan`` with ``tiles``, ``splits``
    and ``scratch_elems`` that splits K."""
    key = (device, torch.cuda.current_stream(device).cuda_stream, type(plan).__name__,
           plan.tiles, plan.splits, plan.scratch_elems)
    scratch = SPLIT_SCRATCH.get(key)
    if scratch is None:
        scratch = (torch.zeros(plan.scratch_elems, dtype=torch.int32, device=device),
                   torch.zeros(plan.tiles, dtype=torch.int32, device=device))
        SPLIT_SCRATCH[key] = scratch
    return scratch


# Import kernel modules so they register. Order matters: the A8 predicates
# are strict subsets of the weight-only ones, so they register first; Q8
# (QLINEAR) shares no config with the others.
from onnx_quantize_tpu_torch.ops.kernels import (  # noqa: E402,F401,I001
    matmul_q8,
    matmul_w4a8,
    matmul_w8a8,
    matmul_w4,
    matmul_w8,
    flash_attention,
    flash_decode,
    mlp_w4,
)
