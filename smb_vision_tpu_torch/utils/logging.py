"""Logging: one stdlib logger per module, printing to stdout, and the
trainers' metrics sink.

Counterpart of `smb_vision_tpu/utils/logging.py` (`get_logger`,
`MetricLogger` without its wandb sink)."""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, Optional

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


class MetricLogger:
    """Console + `metrics.jsonl` metric sink: one JSON record a line, with
    the wall time added as `time` and, when the run has a name, the name
    as `run_name`."""

    def __init__(self, out_dir, run_name: Optional[str] = None):
        self.run_name = run_name
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / "metrics.jsonl"
        self.logger = get_logger("metrics")

    def log(self, record: Dict) -> None:
        record = dict(record)
        record.setdefault("time", time.time())
        if self.run_name:
            record.setdefault("run_name", self.run_name)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        show = {k: (round(v, 5) if isinstance(v, float) else v)
                for k, v in record.items() if k != "time"}
        self.logger.info("%s", show)
