"""Logging: one stdlib logger per module, printing to stdout.

Counterpart of `smb_vision_tpu/utils/logging.py::get_logger`; the metrics
sink (`MetricLogger`) comes with the trainers."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s - %(levelname)s - %(name)s - %(message)s"


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%m/%d/%Y %H:%M:%S"))
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level)
    return logger
