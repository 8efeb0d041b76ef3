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
PORT_FILES = sorted((REPO / "onnx_quantize_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]
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
    # The calibration and pre-pass subpackages are scanned too.
    scanned = {str(p.relative_to(REPO / "onnx_quantize_tpu_torch")) for p in PORT_FILES
               if p.is_relative_to(REPO / "onnx_quantize_tpu_torch")}
    assert {"calibration/__init__.py", "calibration/base.py", "calibration/calibrate.py",
            "calibration/factory.py", "calibration/minmax.py",
            "prepasses/__init__.py"} <= scanned


def test_importing_the_port_builds_no_kernel():
    import onnx_quantize_tpu_torch.engine  # noqa: F401
    import onnx_quantize_tpu_torch.models  # noqa: F401
    import onnx_quantize_tpu_torch.tools  # noqa: F401
    from onnx_quantize_tpu_torch.ops import kernels

    assert kernels._LIBRARY is None
    assert {p.name for p in kernels.CSRC_DIR.glob("*.cu")} == {
        "matmul_w4.cu", "matmul_w8.cu", "flash_attention.cu", "flash_decode.cu",
        "matmul_w4a8.cu", "matmul_w8a8.cu", "matmul_q8.cu", "mlp_w4.cu"}
