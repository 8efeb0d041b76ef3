"""Kernel benchmark and roofline accounting.

Counterpart of ``onnx_quantize_tpu/tools/benchmark.py``: times one quantized
matmul configuration as the slope between two trip counts and reports the
achieved TFLOP/s, the memory rate and the share of the roofline that the
chip's published peaks give.

Peaks default to one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
700 W): bf16 989 TFLOP/s, int8 1,979 TOP/s, float32 67 TFLOP/s outside the
tensor cores, HBM 3,350 GB/s. Pass another :class:`ChipSpec` for another
card. On the CUDA device unless ``--cpu``:

    python -m onnx_quantize_tpu_torch.tools.benchmark --kernel w4 --m 1024 --k 2048 --n 2048

It prints one JSON line: the report of :func:`bench_quantized_matmul` plus
the device and, on CUDA, the card's name and power limit as ``nvidia-smi``
gives them.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch

from onnx_quantize_tpu_torch.nn.qtensor import QTensor

__all__ = ["ChipSpec", "bench_fn", "bench_quantized_matmul", "H100"]


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_tflops: float
    peak_int8_tops: float
    hbm_gbps: float
    peak_f32_tflops: float

    def peak_ops_per_s(self, kind: str) -> float:
        """Peak operations a second for operands of ``kind`` ("bf16", "int8"
        or "float32")."""
        return 1e12 * {"bf16": self.peak_bf16_tflops, "int8": self.peak_int8_tops,
                       "float32": self.peak_f32_tflops}[kind]

    @property
    def hbm_bytes_per_s(self) -> float:
        return 1e9 * self.hbm_gbps


H100 = ChipSpec(name="h100", peak_bf16_tflops=989.0, peak_int8_tops=1979.0, hbm_gbps=3350.0,
                peak_f32_tflops=67.0)


def _nbytes(obj) -> int:
    """Bytes of every tensor in ``obj`` (tensors, QTensors, tuples of them)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, QTensor):
        return sum(_nbytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, tuple):
        return sum(_nbytes(o) for o in obj)
    return 0


def bench_fn(fn, x, *operands, iters: int = 200) -> float:
    """Seconds per call of ``fn(x, *operands)``: the slope between two trip
    counts, so the fixed cost of a timed run cancels.

    The JAX tool chains its calls through a ``tanh`` carry in one jitted
    loop, since XLA would hoist or fuse independent calls. Eager PyTorch does
    neither: each call launches what ``fn`` launches, so ``fn`` is timed alone.

    On the CPU, a trip is one call, timed by ``time.perf_counter``. On CUDA,
    a trip is one replay of a CUDA graph captured from ``fn`` over copies of
    ``(x, *operands)`` that together pass twice the card's L2 cache, so each
    call reads its operands from device memory, as a decode step finds its
    weights (a loop over one set of operands under ~50 MB would read L2 and
    time less than the bytes allow); CUDA events time the replays, so the
    host's dispatch of each call is not in the time.
    """
    if x.device.type == "cuda":
        run, calls = _graph_trips(fn, (x, *operands))
    else:
        def run(n):
            for _ in range(n):
                fn(x, *operands)
        calls = 1

    def timed(n):
        run(1)  # warm: the first call builds and loads the kernels
        times = []
        for _ in range(3):
            times.append(_seconds(run, n, x.device))
        return float(np.median(times))

    # lo stays strictly below hi even for tiny iters.
    lo = max(iters // 4, 10)
    hi = max(iters, 2 * lo)
    est = max(timed(hi) - timed(lo), 1e-9) / (hi - lo)
    # Rescale the trip counts so that t_hi - t_lo is about 300 ms when the
    # pilot estimate is small (a short difference reads timer noise).
    want_hi = int(0.3 / est)
    if want_hi > 2 * hi:
        hi = min(want_hi, 200_000)
        lo = hi // 4
        est = max(timed(hi) - timed(lo), 1e-9) / (hi - lo)
    return est / calls


def _seconds(run, n: int, device: torch.device) -> float:
    if device.type != "cuda":
        t = time.perf_counter()
        run(n)
        return time.perf_counter() - t
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run(n)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _graph_trips(fn, args: tuple):
    """(replay n times, calls a replay) of a CUDA graph of ``fn`` over copies
    of ``args`` that together hold at least twice the L2 cache."""
    l2 = torch.cuda.get_device_properties(args[0].device).L2_cache_size
    copies = max(1, math.ceil(2 * l2 / max(_nbytes(args), 1)))
    sets = [args] + [copy.deepcopy(args) for _ in range(copies - 1)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # fills the per-stream caches (K-split scratch)
        for s in sets:
            fn(*s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for s in sets:
            fn(*s)

    def run(n):
        for _ in range(n):
            graph.replay()

    return run, len(sets)


def _operand_kind(qt: QTensor, dtype: torch.dtype, impl: str) -> str:
    """The operand type whose peak bounds the product: int8 for a site that
    quantizes its input to int8 (W4A8), float32 for float32 x, else bf16."""
    if impl != "dense" and qt.meta.input_quant.mode == "dynamic":
        return "int8"
    return "float32" if dtype == torch.float32 else "bf16"


def bench_quantized_matmul(qt: QTensor, M: int, *, chip: ChipSpec = H100, iters: int = 50,
                           dtype: torch.dtype = torch.bfloat16, impl: str = "kernel",
                           with_control: bool = False) -> dict:
    """Benchmark one QTensor matmul on the QTensor's device; returns the
    measurement and its share of the roofline.

    ``impl``: "kernel" is ``ops.quantized_matmul``, the Hopper kernel on a
    CUDA tensor (pass a tree baked by ``engine.prepare_kernel_scales``, as the
    engine serves it); it refuses a CPU tensor, where the wrapper would run
    the kernel's plain version. "plain" is ``ops.reference.quantized_matmul_ref``.
    "dense" is the library control: a ``torch.matmul`` in ``dtype`` on the
    weight dequantized once.

    The bytes are the weight's data, scales and zero points, x and the
    output, each once; the operations ``2 M K N`` at the peak of the operand
    type (int8 for a W4A8 site, float32 for float32 x, else bf16).

    ``with_control=True`` measures the dense control in the same call and
    adds ``pct_of_dense_control`` (the kernel's byte rate as a percent of the
    control's) and ``speedup_vs_dense`` (time ratio; above 1 the quantized
    matmul is faster).
    """
    from onnx_quantize_tpu_torch.ops import quantized_matmul
    from onnx_quantize_tpu_torch.ops.reference import dequantize_weight, quantized_matmul_ref

    K, N = qt.meta.shape
    device = qt.data.device
    if impl == "kernel" and device.type != "cuda":
        raise ValueError("impl='kernel' needs a CUDA QTensor: on the CPU the kernel wrappers "
                         "run their plain versions")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((M, K))).to(device, dtype)

    if impl == "dense":
        w_dense = dequantize_weight(qt).to(dtype)
        operands, weight_bytes = (w_dense,), _nbytes(w_dense)

        def call(a, w):
            return torch.matmul(a, w)
    elif impl in ("kernel", "plain"):
        operands = (qt,)
        weight_bytes = _nbytes((qt.data, qt.scale, qt.zero_point))
        matmul = quantized_matmul if impl == "kernel" else quantized_matmul_ref

        def call(a, w):
            return matmul(a, w, None)
    else:
        raise ValueError(f"impl must be 'kernel', 'plain' or 'dense', got {impl!r}")
    y = call(x, *operands)
    sec = bench_fn(call, x, *operands, iters=iters)

    flops = 2 * M * K * N
    bytes_accessed = weight_bytes + _nbytes(x) + _nbytes(y)
    tflops = flops / sec / 1e12
    gbps = bytes_accessed / sec / 1e9
    compute_ceiling = flops / chip.peak_ops_per_s(_operand_kind(qt, dtype, impl))
    memory_ceiling = bytes_accessed / chip.hbm_bytes_per_s
    ceiling_sec = max(compute_ceiling, memory_ceiling)
    out = {
        "shape": f"{M}x{K}x{N}",
        "quant": f"{qt.meta.quant_type}/{qt.meta.strategy}/g{qt.meta.group_size}",
        "time_us": round(sec * 1e6, 1),
        "tflops": round(tflops, 2),
        "hbm_gbps": round(gbps, 1),
        "bound": "compute" if compute_ceiling >= memory_ceiling else "memory",
        "pct_roofline": round(100 * ceiling_sec / sec, 1),
        "chip": chip.name,
    }
    if with_control and impl != "dense":
        ctrl = bench_quantized_matmul(qt, M, chip=chip, iters=iters, dtype=dtype, impl="dense")
        out["dense_time_us"] = ctrl["time_us"]
        out["dense_hbm_gbps"] = ctrl["hbm_gbps"]
        out["pct_of_dense_control"] = round(100 * gbps / ctrl["hbm_gbps"], 1)
        out["speedup_vs_dense"] = round(ctrl["time_us"] / out["time_us"], 2)
    return out


def build_qtensor(kernel: str, k: int, n: int, group_size: int) -> QTensor:
    """The CPU QTensor the command line benchmarks: a (k, n) weight drawn at
    0.1 standard deviations from ``default_rng(0)``, RTN-quantized per group,
    asymmetric (uint4 for w4 and w4a8, int8 for w8); w4a8 quantizes its input
    to int8 per tensor at run time."""
    from onnx_quantize_tpu_torch.algorithms.rtn import rtn_quantize
    from onnx_quantize_tpu_torch.core.dtypes import QuantType
    from onnx_quantize_tpu_torch.core.enums import QuantizationStrategy
    from onnx_quantize_tpu_torch.nn.qtensor import ActQuantSpec, make_qtensor

    rng = np.random.default_rng(0)
    w = torch.from_numpy((0.1 * rng.standard_normal((k, n))).astype(np.float32))
    qt_type = QuantType.QUInt4 if kernel in ("w4", "w4a8") else QuantType.QInt8
    q, s, zp = rtn_quantize(w, qt_type, QuantizationStrategy.GROUP, group_size, False, False)
    extra = {}
    if kernel == "w4a8":
        extra["input_quant"] = ActQuantSpec(mode="dynamic", dtype="int8", symmetric=True)
    return make_qtensor(q, s, zp, quant_type=qt_type, strategy=QuantizationStrategy.GROUP,
                        group_size=group_size, symmetric=False, reduce_range=False, **extra)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel", choices=["w4", "w8", "w4a8"], default="w4")
    parser.add_argument("--m", type=int, default=1024)
    parser.add_argument("--k", type=int, default=2048)
    parser.add_argument("--n", type=int, default=2048)
    parser.add_argument("--group-size", type=int, default=128)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--impl", choices=["kernel", "plain", "dense"], default="kernel")
    parser.add_argument("--control", action="store_true",
                        help="also measure the same-shape dense bf16 control and report "
                             "pct_of_dense_control")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU, not the CUDA device.")
    args = parser.parse_args(argv)
    if args.cpu and args.impl == "kernel":
        parser.error("--impl kernel needs the CUDA device: on the CPU the kernel wrappers run "
                     "their plain versions")

    from onnx_quantize_tpu_torch.engine import prepare_kernel_scales

    device = "cpu" if args.cpu else "cuda"
    qt = prepare_kernel_scales({"w": build_qtensor(args.kernel, args.k, args.n,
                                                   args.group_size).to(device)})["w"]
    result = bench_quantized_matmul(qt, args.m, iters=args.iters, impl=args.impl,
                                    with_control=args.control)
    result["device"] = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    result["card"] = None if args.cpu else card_line()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
