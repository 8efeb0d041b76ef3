"""The port's kernel benchmark tool (``tools/benchmark.py``) against the JAX
package's, on the CPU.

Counterpart of ``tests/tools/test_benchmark.py``. A CPU time is no device
number, so these tests pin the tool's contract: the slope is positive; the
report's roofline arithmetic is consistent, at the peak of the operand type
(bf16, float32, or int8 for a W4A8 site) and with the zero points among the
weight's bytes, under ``H100`` and under chips built here; the report has
the JAX report's keys, shape and quant on the same QTensor; the command
line's QTensor equals the JAX command line's recipe bit for bit; the command
line prints one JSON line; and the kernel is refused on CPU tensors, where
its wrapper would run the plain version.
"""

import json

import numpy as np
import pytest
import torch

from onnx_quantize_tpu.algorithms.rtn import rtn_quantize as jrtn_quantize
from onnx_quantize_tpu.core.dtypes import QuantType as JQuantType
from onnx_quantize_tpu.core.enums import QuantizationStrategy as JStrategy
from onnx_quantize_tpu.nn.qtensor import ActQuantSpec as JActQuantSpec
from onnx_quantize_tpu.nn.qtensor import make_qtensor as jmake_qtensor
from onnx_quantize_tpu.tools.benchmark import bench_quantized_matmul as jbench_quantized_matmul
from onnx_quantize_tpu_torch.engine import prepare_kernel_scales
from onnx_quantize_tpu_torch.interop import from_jax_params
from onnx_quantize_tpu_torch.tools import benchmark
from onnx_quantize_tpu_torch.tools.benchmark import (
    H100,
    ChipSpec,
    bench_fn,
    bench_quantized_matmul,
    build_qtensor,
)

torch.set_num_threads(1)

M, K, N, GS = 8, 64, 128, 16


def jax_recipe(kernel: str, k: int, n: int, group_size: int):
    """The JAX command line's QTensor (``onnx_quantize_tpu/tools/benchmark.py:174-190``)."""
    rng = np.random.default_rng(0)
    w = (0.1 * rng.standard_normal((k, n))).astype(np.float32)
    qt_type = JQuantType.QUInt4 if kernel in ("w4", "w4a8") else JQuantType.QInt8
    q, s, zp = jrtn_quantize(w, qt_type, JStrategy.GROUP, group_size, False, False)
    extra = {}
    if kernel == "w4a8":
        extra["input_quant"] = JActQuantSpec(mode="dynamic", dtype="int8", symmetric=True)
    return jmake_qtensor(q, s, zp, quant_type=qt_type, strategy=JStrategy.GROUP,
                         group_size=group_size, symmetric=False, reduce_range=False, **extra)


def test_bench_fn_measures_positive_slope():
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    assert bench_fn(lambda a, wt: a @ wt, x, w, iters=12) > 0


@pytest.mark.parametrize("kernel", ["w4", "w8", "w4a8"])
def test_command_line_qtensor_equals_jax_recipe(kernel):
    """data, scale, zero point and meta bit for bit, on shapes with a pad
    group (K = 320 is 5 groups of 64) and a single group."""
    for k, n, gs in ((320, 96, 64), (K, N, GS)):
        ours = build_qtensor(kernel, k, n, gs)
        jqt = jax_recipe(kernel, k, n, gs)
        for field in ("data", "scale", "zero_point"):
            a, b = getattr(ours, field).numpy(), np.asarray(getattr(jqt, field))
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field
        assert ours.meta == from_jax_params({"w": jqt}, device="cpu")["w"].meta


def test_report_keys_shape_and_quant_equal_jax():
    jqt = jax_recipe("w4", K, N, GS)
    want = jbench_quantized_matmul(jqt, M=M, iters=8, impl="jnp")
    got = bench_quantized_matmul(from_jax_params({"w": jqt}, device="cpu")["w"], M=M,
                                 iters=8, impl="plain")
    assert list(got) == list(want)
    assert got["shape"] == want["shape"] == f"{M}x{K}x{N}"
    assert got["quant"] == want["quant"]
    assert got["chip"] == "h100"
    assert got["bound"] in ("compute", "memory")
    # A CPU time: the rates round to 0 at two decimals.
    assert got["time_us"] > 0 and got["tflops"] >= 0 and got["hbm_gbps"] >= 0


def weight_bytes(qt) -> int:
    return sum(t.numel() * t.element_size() for t in (qt.data, qt.scale, qt.zero_point))


# name -> (kernel, x dtype, the peak the product is bounded by)
KINDS = {"w4_bf16": ("w4", torch.bfloat16, "bf16"),
         "w4_float32": ("w4", torch.float32, "float32"),
         "w4a8_bf16": ("w4a8", torch.bfloat16, "int8"),
         "w8_bf16": ("w8", torch.bfloat16, "bf16")}


@pytest.mark.parametrize("name", list(KINDS))
def test_plain_report_roofline_arithmetic(name):
    """pct_roofline is 100 x the larger ceiling over the time: under H100, and
    under two chips built here, one whose tiny operation peaks make the
    product compute-bound at the peak of its operand type, and one whose tiny
    memory rate makes it memory-bound over bytes that include the zero
    points."""
    kernel, dtype, kind = KINDS[name]
    qt = prepare_kernel_scales({"w": build_qtensor(kernel, K, N, GS)})["w"]
    flops = 2 * M * K * N
    nbytes = weight_bytes(qt) + M * K * dtype.itemsize + M * N * 4
    compute_bound = ChipSpec("compute-bound", peak_bf16_tflops=1e-9, peak_int8_tops=3e-9,
                             hbm_gbps=1e6, peak_f32_tflops=2e-9)
    memory_bound = ChipSpec("memory-bound", peak_bf16_tflops=1e6, peak_int8_tops=1e6,
                            hbm_gbps=1e-6, peak_f32_tflops=1e6)
    for chip in (H100, compute_bound, memory_bound):
        report = bench_quantized_matmul(qt, M=M, chip=chip, iters=8, dtype=dtype, impl="plain")
        assert report["chip"] == chip.name
        compute = flops / chip.peak_ops_per_s(kind)
        memory = nbytes / (chip.hbm_gbps * 1e9)
        sec = report["time_us"] / 1e6
        assert report["bound"] == ("compute" if compute >= memory else "memory")
        assert report["pct_roofline"] == pytest.approx(100 * max(compute, memory) / sec,
                                                       rel=2e-3, abs=0.1)
        assert report["tflops"] == pytest.approx(flops / sec / 1e12, rel=2e-3, abs=0.01)
        assert report["hbm_gbps"] == pytest.approx(nbytes / sec / 1e9, rel=2e-3, abs=0.1)
    assert 0 <= bench_quantized_matmul(qt, M=M, iters=8, dtype=dtype,
                                       impl="plain")["pct_roofline"] <= 100


def test_dense_control_in_the_same_call():
    qt = prepare_kernel_scales({"w": build_qtensor("w4", K, N, GS)})["w"]
    report = bench_quantized_matmul(qt, M=M, iters=8, impl="plain", with_control=True)
    assert report["dense_time_us"] > 0 and report["dense_hbm_gbps"] > 0
    assert report["speedup_vs_dense"] == pytest.approx(
        report["dense_time_us"] / report["time_us"], rel=1e-2, abs=0.01)


def test_main_prints_one_json_line(capsys):
    result = benchmark.main(["--kernel", "w4", "--m", str(M), "--k", str(K), "--n", str(N),
                             "--group-size", str(GS), "--iters", "8", "--impl", "plain",
                             "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result
    assert result["shape"] == f"{M}x{K}x{N}" and result["quant"] == "uint4/group/g16"
    assert result["device"] == "cpu" and result["card"] is None


def test_kernel_on_cpu_tensors_raises():
    with pytest.raises(SystemExit):
        benchmark.main(["--impl", "kernel", "--cpu", "--m", str(M), "--k", str(K),
                        "--n", str(N), "--group-size", str(GS)])
    qt = build_qtensor("w4", K, N, GS)
    with pytest.raises(ValueError, match="CUDA"):
        bench_quantized_matmul(qt, M=M, iters=8, impl="kernel")


def test_port_carries_no_tpu_spec():
    assert not hasattr(benchmark, "V5E")
    assert benchmark.__all__ == ["ChipSpec", "bench_fn", "bench_quantized_matmul", "H100"]
    assert (H100.peak_bf16_tflops, H100.peak_int8_tops, H100.peak_f32_tflops,
            H100.hbm_gbps) == (989.0, 1979.0, 67.0, 3350.0)
