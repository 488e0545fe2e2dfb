"""Wire codec: compression and bundled transfers for what crosses a
transport (own copy of ``covalent_tpu_plugin/transport/codec.py``).

* **Codecs**: ``zlib`` (stdlib) and ``zstd`` (the optional ``zstandard``
  package), negotiated per connection by the executor's pre-flight probe
  (:func:`probe_clause`/:func:`parse_probe`) with a raw fallback.  Files
  under :data:`MIN_COMPRESS_BYTES` and payloads that do not shrink below
  :data:`MAX_COMPRESS_RATIO` ship raw.
* **Single-file publish** (:func:`put_file`), the CAS upload: the payload
  goes to a temporary name, then ONE remote exec decompresses it, checks
  the sha256 of the decompressed bytes against the CAS digest and
  publishes it atomically.  Raw files take put + rename.
* **Bundles** (:meth:`~.base.Transport.put_bundle`): several files packed
  into one tar, one ``put`` and one unpack exec (:func:`build_bundle`,
  :func:`unpack_command`).
* **Fetch** (:func:`get_file`): compressed on the wire when a codec is
  pinned, at the cost of one remote pack exec.
* **Wire accounting**: every byte that crosses a transport is counted in
  ``covalent_tpu_wire_bytes_total{direction,codec}``.

A torn or corrupt payload fails the remote check and raises
:class:`CodecIntegrityError`, a ``RuntimeError`` and not a
``TransportError``: the classifier reads it as PERMANENT, since a retry
would ship the same torn bytes.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import shlex
import tarfile
import tempfile
import uuid
import zlib
from typing import TYPE_CHECKING, Sequence

from ..obs.metrics import REGISTRY

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from .base import Transport

__all__ = [
    "Codec",
    "CodecIntegrityError",
    "WIRE_BYTES_TOTAL",
    "MIN_COMPRESS_BYTES",
    "available_codecs",
    "get_codec",
    "pick_codec",
    "probe_clause",
    "parse_probe",
    "build_bundle",
    "unpack_command",
    "put_file",
    "get_file",
]

#: Files below this size ship raw: the compression header + remote exec
#: can't pay for themselves on tiny payloads (pid files, small specs).
MIN_COMPRESS_BYTES = 512

#: Compressed output must beat this fraction of the input or the file
#: ships raw — incompressible payloads (already-compressed checkpoints,
#: random tensors) must not pay a decompress exec for zero byte savings.
MAX_COMPRESS_RATIO = 0.9

#: Marker printed by the remote publish/unpack helpers on verification
#: failure, so the caller can classify corruption apart from exec errors.
_INTEGRITY_MARKER = "COVALENT_TPU_INTEGRITY"
_INTEGRITY_EXIT = 9

#: Prefix of the codec-capability line the pre-flight probe prints.
PROBE_PREFIX = "COVALENT_TPU_CODECS="

WIRE_BYTES_TOTAL = REGISTRY.counter(
    "covalent_tpu_wire_bytes_total",
    "Bytes shipped across transports by direction (up/down) and codec",
    ("direction", "codec"),
)


class CodecIntegrityError(RuntimeError):
    """Payload failed digest/decompress verification after transfer.

    A RuntimeError (not TransportError) on purpose: resilience.classify_error
    maps unknown non-transport types to PERMANENT, which is correct for
    content corruption — retrying re-ships the same torn bytes (the chaos
    suite's truncated-bundle case must not start a retry storm).
    """


class Codec:
    """One named compression algorithm with local compress/decompress."""

    def __init__(self, name: str) -> None:
        self.name = name

    def compress(self, data: bytes) -> bytes:
        if self.name == "zlib":
            return zlib.compress(data, 6)
        if self.name == "zstd":
            import zstandard

            return zstandard.ZstdCompressor().compress(data)
        raise ValueError(f"unknown codec {self.name!r}")

    def decompress(self, data: bytes) -> bytes:
        if self.name == "zlib":
            return zlib.decompress(data)
        if self.name == "zstd":
            import zstandard

            return zstandard.ZstdDecompressor().decompress(data)
        raise ValueError(f"unknown codec {self.name!r}")


def available_codecs() -> list[str]:
    """Codec names this (dispatcher) side can use, best first."""
    import importlib.util

    names = []
    if importlib.util.find_spec("zstandard") is not None:
        names.append("zstd")
    names.append("zlib")  # stdlib: always present alongside python3
    return names


def get_codec(name: str) -> Codec | None:
    """Codec instance for ``name``; None for "raw"/empty/unknown."""
    if name in ("zlib", "zstd"):
        return Codec(name)
    return None


def pick_codec(remote_names: Sequence[str]) -> Codec | None:
    """Best codec both ends support; None means raw."""
    remote = set(remote_names)
    for name in available_codecs():
        if name in remote:
            return Codec(name)
    return None


def probe_clause(python_path: str, compress: str = "auto") -> str | None:
    """Shell clause for the pre-flight compound probing remote codecs.

    Prints ``COVALENT_TPU_CODECS=zlib[,zstd]`` on its own line; always
    exits 0 so a probe failure degrades to the raw codec instead of
    failing pre-flight.  zlib is probed under ``-E -S`` (stdlib, no site
    processing — a site hook importing heavy ML runtimes must not slow
    the probe); zstd needs site-packages, so its plain-interpreter probe
    is only included when the *local* side could use the answer.
    """
    if compress == "off":
        return None
    py = python_path
    clauses = [
        f"{py} -E -S -c 'import zlib; print(\"{PROBE_PREFIX}zlib\")'"
    ]
    if compress in ("auto", "zstd") and "zstd" in available_codecs():
        clauses.append(
            f"{py} -c 'import zstandard; print(\"{PROBE_PREFIX}zstd\")'"
        )
    joined = "; ".join(f"({c}) 2>/dev/null" for c in clauses)
    return f"({joined}; true)"


def parse_probe(stdout: str) -> list[str]:
    """Remote codec names from pre-flight stdout ([] -> raw fallback)."""
    names: list[str] = []
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith(PROBE_PREFIX):
            names.extend(
                t for t in line[len(PROBE_PREFIX):].split(",") if t
            )
    return names


def record_wire(direction: str, codec_name: str, nbytes: int) -> None:
    WIRE_BYTES_TOTAL.labels(direction=direction, codec=codec_name).inc(nbytes)


# --------------------------------------------------------------------------
# Remote helper programs (run via `python -c` in ONE exec each).
# Failure protocol: verification problems print the integrity marker and
# exit _INTEGRITY_EXIT; anything else is an environment/exec error.
# --------------------------------------------------------------------------

# argv: src dst codec digest("-" = skip).  Decompress src, verify the
# sha256 of the DECOMPRESSED bytes, atomically publish to dst, unlink src.
_PUBLISH_PROGRAM = """
import hashlib, os, sys
src, dst, codec, digest = sys.argv[1:5]
try:
    data = open(src, 'rb').read()
    if codec == 'zlib':
        import zlib; data = zlib.decompress(data)
    elif codec == 'zstd':
        import zstandard; data = zstandard.ZstdDecompressor().decompress(data)
    if digest != '-' and hashlib.sha256(data).hexdigest() != digest:
        raise ValueError('digest mismatch for ' + dst)
    d = os.path.dirname(dst)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = dst + '.pub-' + str(os.getpid())
    with open(tmp, 'wb') as f:
        f.write(data)
    os.replace(tmp, dst)
except Exception as e:
    sys.stderr.write('{marker}: %r\\n' % (e,))
    sys.exit({exit})
finally:
    try: os.unlink(src)
    except OSError: pass
""".strip().format(marker=_INTEGRITY_MARKER, exit=_INTEGRITY_EXIT)

# argv: bundle codec.  Decompress, untar, verify each member's sha256
# against the embedded manifest, publish each atomically, unlink bundle.
_UNPACK_PROGRAM = """
import hashlib, io, json, os, sys, tarfile
path, codec = sys.argv[1:3]
try:
    data = open(path, 'rb').read()
    if codec == 'zlib':
        import zlib; data = zlib.decompress(data)
    elif codec == 'zstd':
        import zstandard; data = zstandard.ZstdDecompressor().decompress(data)
    tf = tarfile.open(fileobj=io.BytesIO(data))
    manifest = json.load(tf.extractfile('MANIFEST.json'))
    for m in manifest:
        buf = tf.extractfile(m['name']).read()
        if m.get('sha256') and hashlib.sha256(buf).hexdigest() != m['sha256']:
            raise ValueError('digest mismatch for ' + m['dest'])
        d = os.path.dirname(m['dest'])
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = m['dest'] + '.pub-' + str(os.getpid())
        with open(tmp, 'wb') as f:
            f.write(buf)
        os.replace(tmp, m['dest'])
except Exception as e:
    sys.stderr.write('{marker}: %r\\n' % (e,))
    sys.exit({exit})
finally:
    try: os.unlink(path)
    except OSError: pass
""".strip().format(marker=_INTEGRITY_MARKER, exit=_INTEGRITY_EXIT)

# argv: src tmp min_bytes codec.  Compress src to tmp when it's large
# enough to be worth it; print which path the download should take.
_PACK_PROGRAM = """
import os, sys
src, tmp, min_bytes, codec = sys.argv[1:5]
data = open(src, 'rb').read()
out = None
if len(data) >= int(min_bytes):
    if codec == 'zlib':
        import zlib; out = zlib.compress(data, 6)
    elif codec == 'zstd':
        import zstandard; out = zstandard.ZstdCompressor().compress(data)
if out is None or len(out) >= len(data):
    print('RAW %d' % len(data))
else:
    with open(tmp, 'wb') as f:
        f.write(out)
    print('Z %d' % len(out))
""".strip()


def _helper_python(python_path: str, codec_name: str) -> str:
    """Interpreter invocation for the remote helper programs.

    ``-E -S`` skips site/sitecustomize processing — the helpers are pure
    stdlib, and a site hook importing heavy ML runtimes (as ML images do)
    would turn a ~30 ms exec into seconds.  zstd lives in site-packages,
    so only that codec pays the full interpreter start.
    """
    if codec_name == "zstd":
        return python_path
    return f"{python_path} -E -S"


def _check_exec(result, what: str):
    """Map a helper program's exit into the right exception type."""
    from .base import TransportError

    stderr = (result.stderr or "").strip()
    if result.exit_status == _INTEGRITY_EXIT or _INTEGRITY_MARKER in stderr:
        raise CodecIntegrityError(
            f"{what} failed digest/decompress verification "
            f"(torn or corrupt payload): {stderr}"
        )
    if result.exit_status != 0:
        raise TransportError(f"{what} failed: {stderr}")
    return result


def build_bundle(
    items: Sequence[tuple[str, str, str]], codec: Codec | None
) -> tuple[bytes, str]:
    """Pack ``(local, remote, digest)`` items into one (maybe compressed)
    tar payload; returns ``(payload, codec_name)``.

    The manifest (member name -> destination + expected sha256) travels
    inside the tar, so the single remote exec needs no other input.  The
    incompressible-skip heuristic applies to the whole bundle: if the
    compressed tar doesn't shrink, the raw tar ships.
    """
    buf = io.BytesIO()
    manifest = []
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for i, (local, remote, digest) in enumerate(items):
            name = f"m{i}"
            manifest.append({"name": name, "dest": remote, "sha256": digest})
            tf.add(local, arcname=name)
        man_bytes = json.dumps(manifest).encode()
        info = tarfile.TarInfo("MANIFEST.json")
        info.size = len(man_bytes)
        tf.addfile(info, io.BytesIO(man_bytes))
    raw = buf.getvalue()
    if codec is not None and len(raw) >= MIN_COMPRESS_BYTES:
        packed = codec.compress(raw)
        if len(packed) < len(raw) * MAX_COMPRESS_RATIO:
            return packed, codec.name
    return raw, "raw"


def unpack_command(
    python_path: str, bundle_path: str, codec_name: str
) -> str:
    return (
        f"{_helper_python(python_path, codec_name)} "
        f"-c {shlex.quote(_UNPACK_PROGRAM)} "
        f"{shlex.quote(bundle_path)} {codec_name}"
    )


async def put_file(
    conn: "Transport",
    local_path: str,
    remote_path: str,
    *,
    codec: Codec | None = None,
    python_path: str = "python3",
    digest: str = "",
) -> dict:
    """Ship one file with atomic publish, compressed when profitable.

    Raw path: temp put + rename (the CAS publish shape).  Compressed
    path: temp put + ONE exec that decompresses, verifies ``digest``
    against the *decompressed* bytes, and publishes — the same round-trip
    count, fewer bytes.  Returns ``{"ops", "wire_bytes", "codec"}``.
    """
    payload: bytes | None = None
    codec_name = "raw"
    if codec is not None:
        def _maybe_compress() -> bytes | None:
            data = open(local_path, "rb").read()
            if len(data) < MIN_COMPRESS_BYTES:
                return None
            packed = codec.compress(data)
            if len(packed) >= len(data) * MAX_COMPRESS_RATIO:
                return None
            return packed

        payload = await asyncio.to_thread(_maybe_compress)
    if payload is not None:
        codec_name = codec.name
        tmp_remote = f"{remote_path}.z.tmp-{uuid.uuid4().hex[:8]}"
        fd, tmp_local = tempfile.mkstemp(prefix="covalent-tpu-wire-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            await conn.put(tmp_local, tmp_remote)
        finally:
            try:
                os.unlink(tmp_local)
            except OSError:
                pass
        cmd = (
            f"{_helper_python(python_path, codec_name)} "
            f"-c {shlex.quote(_PUBLISH_PROGRAM)} "
            f"{shlex.quote(tmp_remote)} {shlex.quote(remote_path)} "
            f"{codec_name} {digest or '-'}"
        )
        _check_exec(await conn.run(cmd), f"publish of {remote_path}")
        record_wire("up", codec_name, len(payload))
        return {"ops": 2, "wire_bytes": len(payload), "codec": codec_name}
    # Raw: temp name + atomic rename (readers never see a torn artifact).
    tmp_remote = f"{remote_path}.tmp-{uuid.uuid4().hex[:8]}"
    await conn.put(local_path, tmp_remote)
    await conn.rename(tmp_remote, remote_path)
    size = os.path.getsize(local_path)
    record_wire("up", "raw", size)
    return {"ops": 2, "wire_bytes": size, "codec": "raw"}


async def get_file(
    conn: "Transport",
    remote_path: str,
    local_path: str,
    *,
    codec: Codec | None = None,
    python_path: str = "python3",
) -> dict:
    """Fetch one file, compressed on the wire when profitable.

    Costs one extra round trip (the remote pack exec), so callers engage
    it only when the operator pinned a codec — the remote side still
    ships raw (``RAW`` token) when the file is too small to win.
    """
    if codec is None:
        await conn.get(remote_path, local_path)
        try:
            size = os.path.getsize(local_path)
        except OSError:
            size = 0
        record_wire("down", "raw", size)
        return {"ops": 1, "wire_bytes": size, "codec": "raw"}
    tmp_remote = f"{remote_path}.z"
    cmd = (
        f"{_helper_python(python_path, codec.name)} "
        f"-c {shlex.quote(_PACK_PROGRAM)} "
        f"{shlex.quote(remote_path)} {shlex.quote(tmp_remote)} "
        f"{MIN_COMPRESS_BYTES} {codec.name}"
    )
    result = _check_exec(await conn.run(cmd), f"pack of {remote_path}")
    token = result.stdout.strip().splitlines()[-1] if result.stdout.strip() else ""
    if token.startswith("Z "):
        await conn.get(tmp_remote, local_path)
        packed = open(local_path, "rb").read()
        data = await asyncio.to_thread(codec.decompress, packed)
        with open(local_path, "wb") as f:
            f.write(data)
        record_wire("down", codec.name, len(packed))
        return {"ops": 2, "wire_bytes": len(packed), "codec": codec.name}
    await conn.get(remote_path, local_path)
    try:
        size = os.path.getsize(local_path)
    except OSError:
        size = 0
    record_wire("down", "raw", size)
    return {"ops": 2, "wire_bytes": size, "codec": "raw"}
