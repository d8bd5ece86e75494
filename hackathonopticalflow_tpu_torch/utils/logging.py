"""Structured logging bootstrap (the port's copy of
hackathonopticalflow_tpu/utils/logging.py).

Mirrors the reference's logging.conf dictConfig split (file handler +
stderr, ERROR threshold on handlers, DEBUG root — logging.conf:1-35,
pathfinder_viewer.py:35-44) with a programmatic config.
"""

from __future__ import annotations

import logging
import logging.config
import os

_FORMAT = "%(asctime)s | %(name)s | %(levelname)s | %(message)s"
_CONFIGURED = False


def setup_logging(
    log_dir: str = "logs",
    file_name: str = "pathfinder_viewer.log",
    handler_level: str = "ERROR",
    root_level: str = "DEBUG",
) -> None:
    """dictConfig equivalent of the reference's logging.conf."""
    global _CONFIGURED
    os.makedirs(log_dir, exist_ok=True)
    logging.config.dictConfig(
        {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": {"default": {"format": _FORMAT}},
            "handlers": {
                "file": {
                    "class": "logging.FileHandler",
                    "filename": os.path.join(log_dir, file_name),
                    "mode": "w",
                    "level": handler_level,
                    "formatter": "default",
                },
                "stderr": {
                    "class": "logging.StreamHandler",
                    "level": handler_level,
                    "formatter": "default",
                },
            },
            "root": {"level": root_level, "handlers": ["file", "stderr"]},
        }
    )
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"hof.{name}")
