"""Logging: one stdlib logger per module, printing to stdout, and the
trainers' metrics sink.

Counterpart of `smb_vision_tpu/utils/logging.py` (`get_logger`,
`MetricLogger` with its optional wandb sink)."""

from __future__ import annotations

import json
import logging
import os
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
    as `run_name`. report_to="wandb" also logs each record to wandb (the
    project from WANDB_PROJECT); without the `wandb` package it warns and
    keeps to metrics.jsonl."""

    def __init__(self, out_dir, report_to: str = "none",
                 run_name: Optional[str] = None):
        self.run_name = run_name
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / "metrics.jsonl"
        self.logger = get_logger("metrics")
        if report_to not in ("none", "", "wandb"):
            raise ValueError(f"report_to {report_to!r}: expected none or "
                             "wandb")
        self._wandb = None
        if report_to == "wandb":
            try:
                import wandb
            except ImportError:
                self.logger.warning(
                    "report_to=wandb requested but wandb is not installed; "
                    "falling back to jsonl only")
            else:
                self._wandb = wandb
                if wandb.run is None:
                    wandb.init(project=os.environ.get("WANDB_PROJECT",
                                                      "smb-vision-tpu"),
                               name=run_name)

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
        if self._wandb is not None:
            self._wandb.log(record, step=record.get("step"))
