"""Per-rank logging (the port of ``paddle_tpu/utils/log_util.py``; parity:
python/paddle/distributed/fleet/utils/log_util.py — a logger whose records carry the trainer rank, so multi-
process logs interleave attributably; plus VLOG-style verbosity via the
framework flag system).

The default logger is ``paddle_tpu_torch.utils``, not the package's root
logger: it stops propagation, and the package's other loggers keep
propagating to the root handlers.
"""
from __future__ import annotations

import logging
import os
import sys

__all__ = ["logger", "get_logger", "set_log_level", "vlog"]


def _rank():
    return os.environ.get("PADDLE_TRAINER_ID", "0")


class _RankFilter(logging.Filter):
    def filter(self, record):
        record.rank = _rank()
        return True


def get_logger(name="paddle_tpu_torch.utils", level=None, fmt=None):
    log = logging.getLogger(name)
    if not log.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            fmt or "%(asctime)s [rank %(rank)s] %(levelname)s "
                   "%(name)s: %(message)s"))
        h.addFilter(_RankFilter())
        log.addHandler(h)
        log.propagate = False
    if level is not None:
        log.setLevel(level)
    elif log.level == logging.NOTSET:
        log.setLevel(os.environ.get("PADDLE_LOG_LEVEL", "INFO"))
    return log


logger = get_logger()


def set_log_level(level):
    logger.setLevel(level)


def vlog(verbosity, msg, *args):
    """glog VLOG(n) analog: emits when FLAGS_v >= verbosity (env
    GLOG_v / FLAGS_v, reference platform/init.cc InitGLOG)."""
    try:
        from ..core.flags import flag

        v = flag("v") or 0
    except Exception:
        v = 0
    v = max(int(v), int(os.environ.get("GLOG_v", "0")))
    if v >= verbosity:
        logger.info(msg, *args)
