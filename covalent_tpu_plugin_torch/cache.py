"""Content addressing of staged artifacts (own copy of the part of
``covalent_tpu_plugin/cache.py`` the serving session uses).

A serving session's factory payload is staged under its sha256 in the
worker's ``{remote_cache}/cas/`` and verified by digest there before it is
unpickled.  The rest of the reference's CAS (probing, pruning, the result
cache) comes with slice 5.
"""

from __future__ import annotations

import hashlib

#: Directory of digest-named artifacts under a remote cache.
CAS_DIR = "cas"


def bytes_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def cas_path(remote_cache: str, digest: str, suffix: str = "") -> str:
    """Digest-addressed remote path under ``{remote_cache}/cas/``."""
    return f"{remote_cache}/{CAS_DIR}/{digest}{suffix}"
