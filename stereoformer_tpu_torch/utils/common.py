"""Logger, the loss-schedule file and a running-average meter.

Counterpart of ``stereoformer_tpu/utils/common.py``.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional


def get_logger(logfile: Optional[str] = None,
               name: str = "stereoformer_tpu_torch"):
    """The package's logger, to stdout; with ``logfile``, to that file too,
    in place of the file of an earlier call (a second training run in one
    process logs to its own file only)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False  # no second line through the root logger
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s [%(levelname)s] %(message)s", "%Y-%m-%d %H:%M:%S"
        )
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if logfile:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(logfile)
        fh.setFormatter(logger.handlers[0].formatter)
        logger.addHandler(fh)
    return logger


def load_loss_scheme(path: str) -> dict:
    """The loss-schedule JSON: {"round", "loss_scale", "loss_weights",
    "epoches"} (``config/loss_config_disp.json``)."""
    with open(path) as f:
        return json.load(f)


class AverageMeter:
    """The last value, sum, count and average of what it was given."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
