"""Logging: one stdlib logger per module, printing to stdout, and the
trainers' metrics sink.

Counterpart of `smb_vision_tpu/utils/logging.py` (`get_logger`,
`MetricLogger` with its optional wandb sink). Under torch.distributed only
rank 0 prints below WARNING, and other ranks' warnings and errors carry
their rank; only rank 0's MetricLogger writes."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional

_FORMAT = "%(asctime)s - %(levelname)s - %(name)s - %(message)s"


def _rank() -> int:
    try:
        import torch.distributed as dist
    except ImportError:
        return 0
    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


class RankFilter(logging.Filter):
    """Rank 0 logs everything; another rank only warnings and errors,
    tagged with its rank."""

    def filter(self, record: logging.LogRecord) -> bool:
        r = _rank()
        if r == 0:
            return True
        if record.levelno < logging.WARNING:
            return False
        if not getattr(record, "_rank_tagged", False):
            record.msg = f"[rank {r}] {record.msg}"
            record._rank_tagged = True
        return True


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%m/%d/%Y %H:%M:%S"))
        h.addFilter(RankFilter())
        logger.addHandler(h)
        logger.propagate = False
    logger.setLevel(level)
    return logger


class MetricLogger:
    """Console + `metrics.jsonl` metric sink: one JSON record a line, with
    the wall time added as `time` and, when the run has a name, the name
    as `run_name`. report_to="wandb" also logs each record to wandb (the
    project from WANDB_PROJECT); without the `wandb` package it warns and
    keeps to metrics.jsonl. enabled=False (a rank other than 0) logs
    nothing."""

    def __init__(self, out_dir, report_to: str = "none",
                 run_name: Optional[str] = None, enabled: bool = True):
        self.enabled = enabled
        self.run_name = run_name
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.out_dir / "metrics.jsonl"
        self.logger = get_logger("metrics")
        if report_to not in ("none", "", "wandb"):
            raise ValueError(f"report_to {report_to!r}: expected none or "
                             "wandb")
        self._wandb = None
        if report_to == "wandb" and enabled:
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
        if not self.enabled:
            return
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
