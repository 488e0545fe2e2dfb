"""Config resolution for the GPU executor.

Own copy of ``covalent_tpu_plugin/utils/config.py``.  Every
``GPUExecutor`` constructor field resolves through a three-level chain:
explicit argument -> ``get_config("executors.gpu.<key>")`` -> hardcoded
default (the reference's pattern, ``covalent_ssh_plugin/ssh.py:94-124``).

* If the ``covalent`` package is installed, ``get_config`` delegates to its
  config manager, so the plugin shares the server's ``[executors.gpu]``
  section.
* Otherwise it reads and writes a standalone TOML file at
  ``$COVALENT_TPU_CONFIG`` (default ``~/.config/covalent_tpu/config.toml``,
  the file the JAX package's ``[executors.tpu]`` section lives in too).

Keys are dotted paths, e.g. ``get_config("executors.gpu.remote_workdir")``.
``gpu.py`` merges its defaults into ``[executors.gpu]``, the SSH keys of
the reference's ``[executors.tpu]`` among them (``transport``,
``hostname``, ``username``, ``ssh_key_file``, ``known_host_key_file``,
``strict_host_keys``, ``conda_env``, ``max_connection_attempts``,
``retry_wait_time``, ``run_local_on_dispatch_fail``, ``compress``,
``bundle``).  ``fleet.pools`` holds the pool specs
``fleet.pools.PoolRegistry.from_environment`` reads when
``COVALENT_TPU_POOLS`` is unset.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    try:
        import tomli as tomllib  # type: ignore[no-redef]
    except ModuleNotFoundError:  # no TOML parser at all: reads degrade
        tomllib = None  # type: ignore[assignment]

try:  # covered by the stub-covalent interop tier when importable
    from covalent._shared_files.config import get_config as _ct_get_config
    from covalent._shared_files.config import set_config as _ct_set_config

    _HAVE_COVALENT = True
except Exception:
    _HAVE_COVALENT = False

_lock = threading.Lock()
_cache: dict[str, Any] | None = None


def _config_path() -> Path:
    return Path(
        os.environ.get(
            "COVALENT_TPU_CONFIG",
            os.path.join(
                os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config")),
                "covalent_tpu",
                "config.toml",
            ),
        )
    )


def _load() -> dict[str, Any]:
    global _cache
    if _cache is None:
        path = _config_path()
        if path.is_file() and tomllib is not None:
            with open(path, "rb") as f:
                _cache = tomllib.load(f)
        else:
            if path.is_file():
                import warnings

                warnings.warn(
                    f"no TOML parser available (python < 3.11 without tomli); "
                    f"ignoring config file {path}",
                    RuntimeWarning,
                    stacklevel=2,
                )
            _cache = {}
    return _cache


def _toml_value(value: Any) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_toml_value(v) for v in value) + "]"
    text = str(value).replace("\\", "\\\\").replace('"', '\\"')
    return f'"{text}"'


def _dump_toml(data: dict[str, Any]) -> str:
    """Minimal TOML writer: emits dotted ``[section]`` headers with scalar keys."""
    out: list[str] = []

    def walk(node: dict[str, Any], path: str) -> None:
        scalars = {k: v for k, v in node.items() if not isinstance(v, dict)}
        tables = {k: v for k, v in node.items() if isinstance(v, dict)}
        if scalars:
            if path:
                out.append(f"[{path}]")
            for key, value in scalars.items():
                out.append(f"{key} = {_toml_value(value)}")
            out.append("")
        for key, sub in tables.items():
            walk(sub, f"{path}.{key}" if path else key)

    walk(data, "")
    return "\n".join(out) + ("\n" if out else "")


def _write(data: dict[str, Any]) -> None:
    path = _config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(_dump_toml(data))


def get_config(key: str, default: Any = None) -> Any:
    """Look up a dotted config key; return ``default`` when unset.

    Mirrors the lookup at ``covalent_ssh_plugin/ssh.py:100-104`` but never
    raises on a missing key — the executor constructor supplies the default.
    """
    if _HAVE_COVALENT:
        try:
            return _ct_get_config(key)
        except Exception:
            return default
    with _lock:
        node: Any = _load()
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def set_config(key: str, value: Any) -> None:
    """Set a single dotted key and persist it."""
    if _HAVE_COVALENT:
        _ct_set_config({key: value})
        return
    with _lock:
        data = _load()
        node = data
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
        _write(data)


def update_config(defaults: dict[str, Any], section: str = "executors.gpu") -> None:
    """Merge plugin defaults under ``section`` without clobbering user values.

    This is what Covalent's plugin loader does with
    ``_EXECUTOR_PLUGIN_DEFAULTS`` (``covalent_ssh_plugin/ssh.py:39-50``); the
    standalone path replicates it so a bare install self-registers.
    """
    if _HAVE_COVALENT:
        # Merge into the server's config manager so `executor="gpu"` resolves
        # defaults there; only keys the user hasn't set already.
        updates = {}
        for key, value in defaults.items():
            full_key = f"{section}.{key}"
            try:
                _ct_get_config(full_key)
            except Exception:
                updates[full_key] = value
        if updates:
            _ct_set_config(updates)
        return
    with _lock:
        data = _load()
        node = data
        for part in section.split("."):
            node = node.setdefault(part, {})
        changed = False
        for key, value in defaults.items():
            if key not in node:
                node[key] = value
                changed = True
        # Persist only when a config file already exists (or the user pointed
        # COVALENT_TPU_CONFIG somewhere) — a bare import must not scribble
        # files into the home directory.  The in-memory merge above is what
        # get_config() reads either way.
        if changed and not _HAVE_COVALENT and _config_path().is_file():
            _write(data)


def _reset_cache_for_tests() -> None:
    global _cache
    with _lock:
        _cache = None
