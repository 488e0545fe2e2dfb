"""Framework logger (own copy of ``covalent_tpu_plugin/utils/log.py``).

The reference borrows Covalent's shared logger
(``covalent_ssh_plugin/ssh.py:30,36-37``).  When the ``covalent`` package is
installed we do the same so log records land in the server's debug log;
otherwise a standard-library logger configured from the environment is used,
keeping the plugin importable standalone.
"""

from __future__ import annotations

import logging
import os

try:  # pragma: no cover - exercised only when covalent is installed
    from covalent._shared_files import logger as _ct_logger

    app_log = _ct_logger.app_log
except Exception:
    app_log = logging.getLogger("covalent_tpu_plugin_torch")
    if not app_log.handlers:
        _handler = logging.StreamHandler()
        _handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] %(name)s: %(message)s")
        )
        app_log.addHandler(_handler)
    # Validate before setLevel: an invalid value would raise ValueError at
    # import time and take down every `import covalent_tpu_plugin_torch` with it.
    _raw = os.environ.get("COVALENT_TPU_LOG_LEVEL", "WARNING").strip().upper()
    _level = int(_raw) if _raw.isdigit() else logging.getLevelName(_raw)
    if not isinstance(_level, int):
        app_log.setLevel(logging.WARNING)
        app_log.warning(
            "invalid COVALENT_TPU_LOG_LEVEL %r; falling back to WARNING", _raw
        )
    else:
        app_log.setLevel(_level)

__all__ = ["app_log"]
