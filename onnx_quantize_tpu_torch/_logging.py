"""Package logging: a colored stream formatter and ``set_log_level``.

Counterpart of ``onnx_quantize_tpu/_logging.py``: the package logger
``onnx_quantize_tpu_torch`` is configured on import (one stream handler on
stderr, level INFO, no propagation to the root logger, colored level names).
The modules' ``logging.getLogger(__name__)`` loggers are its children.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["set_log_level", "get_logger"]

_PACKAGE = "onnx_quantize_tpu_torch"

_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[35m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        record.levelname = f"{color}{record.levelname}{_RESET}"
        return super().format(record)


def _configure() -> logging.Logger:
    logger = logging.getLogger(_PACKAGE)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_ColorFormatter("[%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


def set_log_level(level: int | str) -> None:
    """Set the package-wide log level (a logging constant or its name)."""
    logging.getLogger(_PACKAGE).setLevel(level)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


_configure()
