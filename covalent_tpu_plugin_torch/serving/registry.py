"""CAS-keyed adapter registry: named LoRA bundles for live sessions.

Own copy of ``covalent_tpu_plugin/serving/registry.py``: a bundle either
package packs installs into the other's engine.  Multi-adapter serving
splits one model into a resident base and N cheap rank-r adapters; this
module owns the *artifact* side of that split on the dispatcher:

* **Wire form** — an adapter travels as its ordered ``lora_a``/``lora_b``
  leaf list (:func:`~..models.lora.adapter_leaves` extracts it from a
  training tree), packed by :func:`pack_adapter` into a versioned
  cloudpickle the worker's engine splices directly into its bank.  The
  leaf list (not the params tree) is the portable form: float and
  quantized serving twins of one architecture share it.
* **Identity** — two digests per bundle, deliberately distinct.  The
  *file* digest (sha256 of the pickled bytes) is the CAS key: it names
  the staged artifact and is what the worker verifies before unpickling
  anything.  The *content* digest (:func:`adapter_content_digest`:
  sha256 over each leaf's shape, dtype, and bytes; numpy only, so the
  dispatcher never imports torch, and ``models.lora.adapter_digest``
  calls it) is the adapter's semantic identity: it survives
  re-pickling, names the generation in journal records, and is how a
  disaggregated KV bundle detects a stale adapter after a hot swap.
* **Book-keeping** — :class:`AdapterRegistry` is a local name → record
  book over a CAS directory: ``put`` packs/stages/deduplicates, ``get``
  answers with everything a ``serve_attach`` needs (path + both
  digests).  Supervisors and replica sets consult it; the journal
  persists the per-session attachment view for crash recovery.

Nothing here touches torch: like the rest of the serving tier this runs
in routing processes that must never drag an accelerator runtime in.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Any, Iterable

import cloudpickle

from ..cache import bytes_digest

__all__ = [
    "AdapterRegistry",
    "adapter_content_digest",
    "pack_adapter",
    "unpack_adapter",
]

#: Bundle schema version: the worker refuses versions it does not know
#: instead of guessing at leaf semantics.
BUNDLE_VERSION = 1


def adapter_content_digest(leaves: Iterable[Any]) -> str:
    """Content digest of an ordered adapter leaf list.

    sha256 over each leaf's shape, dtype, and bytes.  The worker's engine
    announces the same function's digest (``models.lora.adapter_digest``
    calls this one) after splicing the adapter in, so a digest computed
    here, on the dispatcher from numpy arrays, names the same adapter.
    """
    import numpy as np

    h = hashlib.sha256()
    for leaf in leaves:
        arr = np.asarray(leaf)
        h.update(repr((tuple(arr.shape), str(arr.dtype))).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def pack_adapter(
    leaves: Iterable[Any],
    name: str = "",
    rank: int | None = None,
    alpha: float = 16.0,
) -> bytes:
    """Pack an ordered adapter leaf list into its CAS bundle bytes.

    ``rank`` defaults to the trailing dimension of the first leaf —
    ``lora_a`` leaves sort first in the canonical flatten order, and
    their shape is ``(..., features, rank)``.  The content digest is
    computed here and carried INSIDE the bundle, so the worker can
    install without re-hashing and a reader can identify a bundle
    without the leaves' originating tree.
    """
    import numpy as np

    arrs = [np.asarray(leaf) for leaf in leaves]
    if not arrs:
        raise ValueError("adapter bundle needs at least one leaf")
    if rank is None:
        rank = int(arrs[0].shape[-1])
    return cloudpickle.dumps({
        "v": BUNDLE_VERSION,
        "name": str(name),
        "rank": int(rank),
        "alpha": float(alpha),
        "leaves": arrs,
        "digest": adapter_content_digest(arrs),
    })


def unpack_adapter(data: bytes) -> dict:
    """Decode one packed bundle; validates shape and version."""
    obj = cloudpickle.loads(data)
    if not isinstance(obj, dict) or "leaves" not in obj:
        raise ValueError("not an adapter bundle (no leaves)")
    version = int(obj.get("v") or 0)
    if version != BUNDLE_VERSION:
        raise ValueError(
            f"adapter bundle version {version} is not supported "
            f"(expected {BUNDLE_VERSION})"
        )
    return obj


class AdapterRegistry:
    """Local name → adapter-record book over a CAS directory.

    One record per *name*; re-``put`` of a name with different content
    is a generation swap (the old record is replaced, its CAS file left
    for any session still referencing it — CAS files are immutable and
    the cache's usual pruning owns their lifetime).  Thread-safe: the
    serving tier touches this from the event loop and from
    ``asyncio.to_thread`` staging helpers.
    """

    def __init__(self, cache_dir: str) -> None:
        self.cache_dir = str(cache_dir)
        self._dir = os.path.join(self.cache_dir, "cas")
        self._records: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- write ---------------------------------------------------------------

    def put(
        self,
        name: str,
        payload: Any,
        rank: int | None = None,
        alpha: float = 16.0,
    ) -> dict:
        """Register ``name`` → a packed bundle; returns its record.

        ``payload`` is packed bundle bytes, a leaf list/tuple, or an
        already-decoded bundle dict — anything else refuses.  The bytes
        land in the CAS (digest-named, write-once) and the record holds
        both identities plus the local path a supervisor stages from.
        """
        if isinstance(payload, (bytes, bytearray)):
            data = bytes(payload)
            bundle = unpack_adapter(data)
        elif isinstance(payload, dict):
            bundle = dict(payload)
            data = pack_adapter(
                bundle["leaves"], name=name,
                rank=bundle.get("rank") or rank,
                alpha=float(bundle.get("alpha") or alpha),
            )
            bundle = unpack_adapter(data)
        elif isinstance(payload, (list, tuple)):
            data = pack_adapter(payload, name=name, rank=rank, alpha=alpha)
            bundle = unpack_adapter(data)
        else:
            raise ValueError(
                f"adapter payload must be bundle bytes, a bundle dict, or "
                f"a leaf list, got {type(payload).__name__}"
            )
        digest = bytes_digest(data)
        path = os.path.join(self._dir, f"{digest}.lora")
        if not os.path.exists(path):
            os.makedirs(self._dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        record = {
            "name": str(name),
            "digest": digest,
            "content": str(bundle.get("digest") or ""),
            "path": path,
            "size": len(data),
            "rank": int(bundle.get("rank") or 0),
            "alpha": float(bundle.get("alpha") or 0.0),
        }
        with self._lock:
            self._records[str(name)] = record
        return dict(record)

    def remove(self, name: str) -> dict | None:
        """Drop a name from the book (CAS file stays; it is immutable
        and may still back a live session's attachment)."""
        with self._lock:
            return self._records.pop(str(name), None)

    # -- read ----------------------------------------------------------------

    def get(self, name: str) -> dict | None:
        with self._lock:
            record = self._records.get(str(name))
        return dict(record) if record is not None else None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._records)

    def records(self) -> dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._records.items()}

    def digests(self) -> dict[str, str]:
        """name → *content* digest (the semantic identity view the
        scheduler's adapter-affinity rank and /status consume)."""
        with self._lock:
            return {
                k: str(v.get("content") or "")
                for k, v in self._records.items()
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, name: object) -> bool:
        with self._lock:
            return str(name) in self._records
