"""The run's environment: build and kernel caches inside the checkout, the
process's start time, the card, and the look for JAX in ``sys.modules``."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["set_cache_dirs", "process_start", "card", "jax_modules", "FORBIDDEN"]

# Top-level module names the port must not load, compared whole: the port's
# own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "onnx_quantize_tpu")


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernel library into ``onnx_quantize_tpu_torch/_build``
    by itself), the allocator's settings, and libraries kept from loading
    JAX. Call before torch is imported."""
    cache = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    # Admissions allocate large transient blocks of changing sizes: grow the
    # allocator's segments rather than splitting fixed ones.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """The process's start on ``time.monotonic``'s clock (Linux: from
    /proc/self/stat; elsewhere the first call's time)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot_now = time.clock_gettime(time.CLOCK_BOOTTIME)
        started = ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - (boot_now - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic()


def card() -> dict:
    """The card's name, count in use and power limit."""
    import torch

    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        info["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = "unavailable"
    return info


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(name for name in list(sys.modules) if name.split(".", 1)[0] in FORBIDDEN)
