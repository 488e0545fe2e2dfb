"""Utilities of the PyTorch port: logging, task serialization and config
(``utils.config``)."""

from .log import app_log
from .serialize import dump_task, load_result

__all__ = ["app_log", "dump_task", "load_result"]
