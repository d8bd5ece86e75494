"""Logging, timing and checkpoint / resume (ports of
hackathonopticalflow_tpu/utils/)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .logging import get_logger, setup_logging
from .profiling import FpsCounter, Timer, device_trace

__all__ = [
    "get_logger", "setup_logging", "Timer", "FpsCounter", "device_trace", "save_checkpoint",
    "load_checkpoint",
]
