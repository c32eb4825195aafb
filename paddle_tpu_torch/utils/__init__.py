"""Utilities (the port of ``paddle_tpu/utils``): logging (log_util),
runtime counters (monitor)."""
from . import log_util, monitor
from .log_util import get_logger, logger, set_log_level, vlog
from .monitor import (StatRegistry, device_memory_stats, stat_add, stat_get,
                      stat_reset)

__all__ = ["log_util", "monitor", "logger", "get_logger", "set_log_level",
           "vlog", "StatRegistry", "stat_add", "stat_get", "stat_reset",
           "device_memory_stats"]
