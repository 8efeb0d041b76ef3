"""No module under h100bench/ imports JAX, jaxlib, flax or the JAX package,
judged by top-level name compared whole (the port's name begins with the
JAX package's), and the reference imports nothing of the port."""

import ast

from h100bench.benchlib.cells import BENCH
from h100bench.benchlib.env import FORBIDDEN, jax_modules


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    found = {}
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        bad = [m for m in _imports(path) if m.split(".", 1)[0] in FORBIDDEN]
        if bad:
            found[str(path.relative_to(BENCH))] = bad
    assert not found


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert "onnx_quantize_tpu_torch" not in tops, path


def test_the_port_is_not_taken_for_the_jax_package():
    import sys

    import onnx_quantize_tpu_torch  # noqa: F401

    assert "onnx_quantize_tpu_torch" in sys.modules
    assert all(name.split(".", 1)[0] in FORBIDDEN for name in jax_modules())
    assert not any(name.split(".", 1)[0] == "onnx_quantize_tpu_torch" for name in jax_modules())
