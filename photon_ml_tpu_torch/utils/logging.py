"""Job logging (the PhotonLogger role: leveled logs to console + a per-job
file; reference: photon-lib .../util/PhotonLogger.scala:34-553)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"


def setup_logging(level: str = "INFO", log_file: Optional[str] = None):
    logger = logging.getLogger("photon_ml_tpu_torch")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(console)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger
