"""The PyTorch port stands alone: no module of ``onnx_quantize_tpu_torch``, nor
``chip_smoke.py`` or the GPU tests, imports JAX or the JAX package, and
importing the port builds and loads no kernel (the CPU test machine has no
nvcc and no triton).

Checked on the sources, since the test process itself has JAX loaded."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# chip_smoke.py and the GPU tests run on the card's machine, which has no JAX.
# The rank bodies of tests/torch_world.py run in spawned processes, which
# must not import JAX either.
PORT_FILES = sorted((REPO / "onnx_quantize_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
    REPO / "tests" / "torch_world.py"]
FORBIDDEN = ("jax", "jaxlib", "onnx_quantize_tpu", "ml_dtypes", "pydantic", "triton")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_sources_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "gemma3.py", "matmul_w4.py", "matmul_w8.py", "flash_attention.py",
            "flash_decode.py", "perplexity.py", "matmul_w4a8.py", "matmul_w8a8.py",
            "matmul_q8.py", "mlp_w4.py", "chip_smoke.py"} <= names
    # The calibration and pre-pass subpackages, QuaRot, the Llama and
    # structured models, packing, checkpoints, the interop, the serving
    # scheduler, the MoE family, the package logger and speculative decoding
    # are scanned too.
    scanned = {str(p.relative_to(REPO / "onnx_quantize_tpu_torch")) for p in PORT_FILES
               if p.is_relative_to(REPO / "onnx_quantize_tpu_torch")}
    assert {"calibration/__init__.py", "calibration/base.py", "calibration/calibrate.py",
            "calibration/factory.py", "calibration/minmax.py", "calibration/percentile.py",
            "calibration/entropy.py", "algorithms/gptq.py", "algorithms/hqq.py",
            "prepasses/__init__.py", "prepasses/awq.py", "prepasses/smooth_quant.py",
            "prepasses/rotate.py", "models/llama.py", "models/structured.py", "core/pack.py",
            "checkpoint.py", "interop.py", "engine/scheduler.py", "engine/sampling.py",
            "models/moe.py", "_logging.py", "engine/speculative.py",
            "engine/spec_scheduler.py", "parallel/__init__.py", "parallel/mesh.py",
            "parallel/comm.py", "parallel/tp.py", "parallel/sharding.py", "parallel/tp_ops.py",
            "parallel/collective.py", "parallel/ep.py", "parallel/pp.py",
            "parallel/cp.py"} <= scanned
    assert "torch_world.py" in names


@pytest.mark.parametrize("path", sorted((REPO / "onnx_quantize_tpu_torch" / "parallel").glob(
    "*.py")), ids=lambda p: p.name)
def test_parallel_package_spawns_no_process(path):
    """The caller starts the ranks: the package imports no process launcher."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("multiprocessing", "subprocess")
           or m.startswith("torch.multiprocessing")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_builds_no_kernel():
    import onnx_quantize_tpu_torch.engine  # noqa: F401
    import onnx_quantize_tpu_torch.models  # noqa: F401
    import onnx_quantize_tpu_torch.parallel  # noqa: F401
    import onnx_quantize_tpu_torch.tools  # noqa: F401
    from onnx_quantize_tpu_torch.ops import kernels

    assert kernels._LIBRARY is None
    assert {p.name for p in kernels.CSRC_DIR.glob("*.cu")} == {
        "matmul_w4.cu", "matmul_w8.cu", "flash_attention.cu", "flash_decode.cu",
        "matmul_w4a8.cu", "matmul_w8a8.cu", "matmul_q8.cu", "mlp_w4.cu"}
