"""Logging and checkpoint / resume (ports of hackathonopticalflow_tpu/utils/)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .logging import get_logger, setup_logging

__all__ = ["get_logger", "setup_logging", "save_checkpoint", "load_checkpoint"]
