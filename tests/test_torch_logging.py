"""The port's package logger (``onnx_quantize_tpu_torch/_logging.py``) against
the JAX package's: one colored stream handler on ``onnx_quantize_tpu_torch``,
level INFO, no propagation, the same line for each level, ``set_log_level``
by name and by constant, and no second handler when the module runs again."""

import importlib
import logging

import pytest

import onnx_quantize_tpu._logging as jax_logging
import onnx_quantize_tpu_torch as oqt
import onnx_quantize_tpu_torch._logging as port_logging

LEVELS = [logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR, logging.CRITICAL]


def _package_logger():
    return logging.getLogger("onnx_quantize_tpu_torch")


def test_package_logger_configured():
    logger = _package_logger()
    assert len(logger.handlers) == 1
    assert isinstance(logger.handlers[0], logging.StreamHandler)
    assert logger.propagate is False
    assert logger.level == logging.INFO
    assert oqt.set_log_level is port_logging.set_log_level


@pytest.mark.parametrize("level", LEVELS, ids=logging.getLevelName)
def test_colored_format_equals_jax(level):
    def line(formatter, name):
        record = logging.LogRecord(name, level, __file__, 1, "message %d", (7,), None)
        return formatter.format(record)

    port = _package_logger().handlers[0].formatter
    jax_fmt = logging.getLogger("onnx_quantize_tpu").handlers[0].formatter
    assert isinstance(jax_fmt, jax_logging._ColorFormatter)
    assert line(port, "pkg.mod") == line(jax_fmt, "pkg.mod")
    assert line(port, "pkg.mod").endswith("] pkg.mod: message 7")
    assert port_logging._COLORS[level] in line(port, "pkg.mod")


@pytest.mark.parametrize("level", ["DEBUG", logging.WARNING], ids=["name", "constant"])
def test_set_log_level(level):
    logger = _package_logger()
    try:
        oqt.set_log_level(level)
        want = logging.getLevelName(level) if isinstance(level, str) else level
        assert logger.level == want
        # Module loggers are children of the package logger.
        child = port_logging.get_logger("onnx_quantize_tpu_torch.engine.speculative")
        assert child.getEffectiveLevel() == want
    finally:
        oqt.set_log_level(logging.INFO)


def test_second_import_adds_no_handler():
    before = list(_package_logger().handlers)
    importlib.reload(port_logging)
    importlib.reload(oqt)
    assert _package_logger().handlers == before
