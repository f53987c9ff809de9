"""Structured logging with a verbosity gate (-v 0/1/2+ -> warning/info/debug)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname).1s] %(message)s"
_ROOT = "biogpt_tpu_torch"


def _configure() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.setLevel(logging.WARNING)
    return root


def get_logger(name: str = "") -> logging.Logger:
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def set_verbosity(level: int) -> None:
    """0 = warnings, 1 = info, 2+ = debug."""
    _configure().setLevel(logging.WARNING if level <= 0
                          else logging.INFO if level == 1 else logging.DEBUG)
