"""Named stdout loggers (port of `omfs4d.core.logging.get_logger`)."""

from __future__ import annotations

import logging
import os
import sys

_LOGGERS: dict[str, logging.Logger] = {}


def get_logger(tag: str) -> logging.Logger:
    if tag in _LOGGERS:
        return _LOGGERS[tag]
    logger = logging.getLogger(f"omfs4d_torch.{tag}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(f"[{tag}] %(message)s"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("OMFS4D_LOGLEVEL", "INFO"))
        logger.propagate = False
    _LOGGERS[tag] = logger
    return logger
