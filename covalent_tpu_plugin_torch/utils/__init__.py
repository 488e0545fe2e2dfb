"""Utilities of the PyTorch port: logging and task serialization."""

from .log import app_log
from .serialize import dump_task, load_result

__all__ = ["app_log", "dump_task", "load_result"]
