"""The port's wire codec against the JAX package's.

``covalent_tpu_plugin_torch/transport/codec.py`` is the port's own copy of
``covalent_tpu_plugin/transport/codec.py``.  A bundle built by either
package unpacks under the other's ``unpack_command`` (one remote exec) to
byte-equal files, raw and under each codec; both negotiate the same codec
from the same probe; a torn payload raises ``CodecIntegrityError`` in
both.  Remote commands run in a local shell here: the codec's helpers are
``python -c`` programs that do not care which transport carried the bytes.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import shutil
import subprocess
import sys

import pytest

from covalent_tpu_plugin.transport import codec as ref_codec
from covalent_tpu_plugin.transport.base import Transport as RefTransport
from covalent_tpu_plugin_torch.transport import codec
from covalent_tpu_plugin_torch.transport.base import CommandResult, Transport

PACKAGES = {"port": codec, "reference": ref_codec}
CODECS = [None, "zlib"] + (["zstd"] if "zstd" in codec.available_codecs() else [])


def _files(tmp_path) -> list[tuple[str, str, str]]:
    """(local, remote, digest): a compressible file, a random one, a tiny one."""
    src = tmp_path / "src"
    src.mkdir()
    contents = {"text.txt": b"electron staging " * 4000, "noise.bin": os.urandom(50_000),
                "tiny.json": b'{"a": 1}'}
    items = []
    for name, data in contents.items():
        (src / name).write_bytes(data)
        items.append((str(src / name), str(tmp_path / "remote" / "cas" / name),
                      hashlib.sha256(data).hexdigest()))
    return items


def _sh(command: str) -> subprocess.CompletedProcess:
    return subprocess.run(["/bin/sh", "-c", command], capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("name", CODECS, ids=lambda n: n or "raw")
@pytest.mark.parametrize("packer,unpacker", [("port", "reference"), ("reference", "port"),
                                              ("port", "port")])
def test_bundles_cross_unpack_byte_equal(tmp_path, packer, unpacker, name):
    items = _files(tmp_path)
    build, unpack = PACKAGES[packer], PACKAGES[unpacker]
    payload, used = build.build_bundle(items, build.get_codec(name) if name else None)
    assert used == (name or "raw")
    # the other package's build of the same files decompresses to the same tar members
    bundle = tmp_path / "bundle.tar"
    bundle.write_bytes(payload)
    proc = _sh(unpack.unpack_command(sys.executable, str(bundle), used))
    assert proc.returncode == 0, proc.stderr
    for local, remote, _ in items:
        with open(local, "rb") as a, open(remote, "rb") as b:
            assert a.read() == b.read()
    assert not bundle.exists()  # the unpack removes the bundle


def test_both_packages_negotiate_the_same_codec():
    assert codec.available_codecs() == ref_codec.available_codecs()
    assert (codec.MIN_COMPRESS_BYTES, codec.MAX_COMPRESS_RATIO) == (
        ref_codec.MIN_COMPRESS_BYTES, ref_codec.MAX_COMPRESS_RATIO) == (512, 0.9)
    for compress in ("auto", "zlib", "zstd", "off"):
        assert codec.probe_clause("python3", compress) == ref_codec.probe_clause(
            "python3", compress)
    probe = codec.probe_clause(sys.executable, "auto")
    out = _sh(probe).stdout
    assert codec.parse_probe(out) == ref_codec.parse_probe(out)
    for remote in ([], ["zlib"], ["zlib", "zstd"], ["zstd"], ["brotli"]):
        ours, theirs = codec.pick_codec(remote), ref_codec.pick_codec(remote)
        assert (ours and ours.name) == (theirs and theirs.name)
    # zstd first whenever zstandard is installed on both ends
    if "zstd" in codec.available_codecs():
        assert codec.pick_codec(["zlib", "zstd"]).name == "zstd"


def _shell_transport(base):
    """A transport of ``base``'s package that runs commands in a local shell
    and copies files, optionally cutting each upload short (a torn put)."""

    class Shell(base):
        address = "shell"

        def __init__(self, tear: bool = False):
            self.tear = tear

        async def run(self, command, timeout=None):
            proc = await asyncio.to_thread(_sh, command)
            return CommandResult(proc.returncode, proc.stdout, proc.stderr)

        async def put(self, local_path, remote_path):
            data = open(local_path, "rb").read()
            with open(remote_path, "wb") as f:
                f.write(data[: len(data) // 2] if self.tear else data)

        async def get(self, remote_path, local_path):
            shutil.copyfile(remote_path, local_path)

        async def close(self):
            pass

    return Shell


@pytest.mark.parametrize("package", ["port", "reference"])
@pytest.mark.parametrize("name", CODECS, ids=lambda n: n or "raw")
def test_a_torn_bundle_raises_codec_integrity_error(tmp_path, run_async, package, name):
    mod = PACKAGES[package]
    shell = _shell_transport(Transport if package == "port" else RefTransport)
    items = _files(tmp_path)
    (tmp_path / "remote" / "cas").mkdir(parents=True)
    conn = shell(tear=True)
    chosen = mod.get_codec(name) if name else None
    with pytest.raises(mod.CodecIntegrityError):
        run_async(conn.put_bundle(items, str(tmp_path / "remote" / "b.tar"),
                                  python_path=sys.executable, codec=chosen))
    # and whole, the same bundle publishes every member
    stats = run_async(shell().put_bundle(items, str(tmp_path / "remote" / "b.tar"),
                                         python_path=sys.executable, codec=chosen))
    assert stats["members"] == 3 and stats["ops"] == 2
    for local, remote, _ in items:
        assert open(local, "rb").read() == open(remote, "rb").read()


def test_put_file_checks_the_digest_remotely_and_get_file_round_trips(tmp_path, run_async):
    local, _, digest = _files(tmp_path)[0]
    (tmp_path / "remote" / "cas").mkdir(parents=True)
    conn = _shell_transport(Transport)()
    target = str(tmp_path / "remote" / "cas" / "published.txt")
    zlib = codec.get_codec("zlib")
    stats = run_async(codec.put_file(conn, local, target, codec=zlib,
                                     python_path=sys.executable, digest=digest))
    assert stats["codec"] == "zlib" and stats["wire_bytes"] < os.path.getsize(local)
    assert open(target, "rb").read() == open(local, "rb").read()
    with pytest.raises(codec.CodecIntegrityError):
        run_async(codec.put_file(conn, local, target + ".bad", codec=zlib,
                                 python_path=sys.executable, digest="0" * 64))
    before = codec.WIRE_BYTES_TOTAL.labels(direction="down", codec="zlib").value
    back = str(tmp_path / "back.txt")
    stats = run_async(codec.get_file(conn, target, back, codec=zlib,
                                     python_path=sys.executable))
    assert stats["codec"] == "zlib" and open(back, "rb").read() == open(local, "rb").read()
    assert codec.WIRE_BYTES_TOTAL.labels(direction="down", codec="zlib").value == (
        before + stats["wire_bytes"])
