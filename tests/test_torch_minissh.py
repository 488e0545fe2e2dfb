"""The port's pure-Python SSH-2 stack against the JAX package's, on one wire.

``covalent_tpu_plugin_torch/transport/minissh.py`` is the port's own copy
of ``covalent_tpu_plugin/transport/minissh.py``.  These tests hold the two
to one protocol:

* across packages, both ways (the port's client against the reference's
  server, and the reference's client against the port's server), over a
  real TCP socket: key exchange, publickey and password authentication,
  exec with separate stdout/stderr and the exit status, and a put/get of a
  file larger than a channel's 2 MiB window;
* byte for byte: given the same keys, IV and sequence number (and the same
  padding bytes), ``_PacketStream.wrap`` makes the same packets and
  ``_kexinit_payload`` the same KEXINIT;
* authentication and host-key verdicts fail on the first attempt: no
  retry can change them, and both packages classify them permanent.
"""

from __future__ import annotations

import asyncio
import os

import pytest

pytest.importorskip("cryptography", reason="minissh needs the `cryptography` package")

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519

from covalent_tpu_plugin import resilience as ref_resilience
from covalent_tpu_plugin.transport import minissh as ref_minissh
from covalent_tpu_plugin.transport import ssh as ref_ssh
from covalent_tpu_plugin_torch import resilience
from covalent_tpu_plugin_torch.transport import minissh, ssh
from covalent_tpu_plugin_torch.transport.base import TransportError

#: Larger than one channel window (2 MiB), so the transfer must wait for
#: WINDOW_ADJUST in both directions.
BIG = 3 * (1 << 20) + 12345
PACKAGES = {"port": (minissh, ssh), "reference": (ref_minissh, ref_ssh)}


def _client_key(tmp_path):
    key = ed25519.Ed25519PrivateKey.generate()
    path = tmp_path / "id_ed25519"
    path.write_bytes(key.private_bytes(serialization.Encoding.PEM,
                                       serialization.PrivateFormat.OpenSSH,
                                       serialization.NoEncryption()))
    os.chmod(path, 0o600)
    return key, str(path)


@pytest.mark.parametrize("auth", ["publickey", "password"])
@pytest.mark.parametrize("client,server", [("port", "reference"), ("reference", "port")])
def test_the_wire_is_one_protocol_across_packages(tmp_path, run_async, client, server, auth):
    server_mod, client_ssh = PACKAGES[server][0], PACKAGES[client][1]
    key, key_path = _client_key(tmp_path)
    payload = os.urandom(BIG)
    (tmp_path / "up.bin").write_bytes(payload)

    async def flow():
        srv = await server_mod.serve(
            authorized_keys={"tester": [key]} if auth == "publickey" else (),
            users={"tester": "s3cret"} if auth == "password" else None)
        try:
            t = client_ssh.SSHTransport(
                hostname="127.0.0.1", port=srv.port, username="tester", backend="minissh",
                ssh_key_file=key_path if auth == "publickey" else "",
                password="s3cret" if auth == "password" else "",
                strict_host_keys=True, known_host_key=srv.host_key.public_key())
            await client_ssh.connect_with_retries(t, max_attempts=1)
            try:
                res = await t.run("echo out; echo err >&2; exit 7")
                await t.put(str(tmp_path / "up.bin"), str(tmp_path / "remote.bin"))
                await t.get(str(tmp_path / "remote.bin"), str(tmp_path / "down.bin"))
                streamed = await t.run(f"wc -c < {tmp_path / 'remote.bin'}")
            finally:
                await t.close()
        finally:
            srv.close()
            await srv.wait_closed()
        return res, streamed

    res, streamed = run_async(flow())
    assert (res.exit_status, res.stdout, res.stderr) == (7, "out\n", "err\n")
    assert int(streamed.stdout) == BIG
    assert (tmp_path / "remote.bin").read_bytes() == payload
    assert (tmp_path / "down.bin").read_bytes() == payload


def test_a_persistent_process_over_the_port_client(tmp_path, run_async):
    """``start_process`` on the minissh backend: lines both ways, a line
    longer than asyncio's 64 KiB default, and the command's death when the
    channel closes."""
    key, key_path = _client_key(tmp_path)
    pid_file = tmp_path / "pid"

    async def flow():
        srv = await minissh.serve(authorized_keys={"tester": [key]})
        t = ssh.SSHTransport(hostname="127.0.0.1", port=srv.port, username="tester",
                             backend="minissh", ssh_key_file=key_path,
                             known_host_key=srv.host_key.public_key())
        try:
            await ssh.connect_with_retries(t, max_attempts=1)
            proc = await t.start_process(f"echo $$ > {pid_file}; exec cat", describe="cat")
            await proc.write_line("ping")
            first = await proc.read_line(timeout=30)
            long = "x" * (200 * 1024)
            await proc.write_line(long)
            echoed = await proc.read_line(timeout=30)
            assert proc.returncode is None
            await proc.close(kill=True)
            for _ in range(200):  # the server kills the command with its channel
                alive = (await t.run(f"kill -0 $(cat {pid_file}) 2>/dev/null && echo up")).stdout
                if not alive.strip():
                    break
                await asyncio.sleep(0.05)
            return first, echoed == long, alive.strip()
        finally:
            await t.close()
            srv.close()
            await srv.wait_closed()

    assert run_async(flow()) == ("ping", True, "")


def test_packets_and_kexinit_are_byte_equal(monkeypatch):
    """Same keys, IV, sequence number and padding bytes: the same packets,
    unarmed and armed (aes128-ctr + hmac-sha2-256), across a sequence-number
    wrap, and the same KEXINIT."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) % 256 for i in range(n)))
    key, iv, mac = bytes(range(16)), bytes(range(16, 32)), bytes(range(32, 64))
    payloads = [b"", b"\x05", b"\x5e" * 100, bytes(range(256)) * 130]
    for seq, armed in ((0, False), (0, True), (41, True), (0xFFFFFFFE, True)):
        streams = [minissh._PacketStream(), ref_minissh._PacketStream()]
        for stream in streams:
            stream.seq = seq
            if armed:
                stream.arm(key, iv, mac, encrypt=True)
        for payload in payloads:
            port_packet, ref_packet = (stream.wrap(payload) for stream in streams)
            assert port_packet == ref_packet
        assert streams[0].seq == streams[1].seq == (seq + len(payloads)) & 0xFFFFFFFF
    assert minissh._kexinit_payload() == ref_minissh._kexinit_payload()
    assert minissh._mpint(2 ** 255 + 19) == ref_minissh._mpint(2 ** 255 + 19)


def test_a_port_packet_reads_back_in_the_reference(run_async):
    key, iv, mac = bytes(16), bytes(range(16)), bytes(32)
    out, inp = minissh._PacketStream(), ref_minissh._PacketStream()
    out.arm(key, iv, mac, encrypt=True)
    inp.arm(key, iv, mac, encrypt=False)

    async def read(wire: bytes):
        reader = asyncio.StreamReader()
        reader.feed_data(wire)
        reader.feed_eof()
        return [await inp.read_packet(reader) for _ in range(3)]

    messages = [b"\x5e" + bytes(1000), b"\x14kexinit", b"\x02"]
    wire = b"".join(out.wrap(m) for m in messages)
    assert run_async(read(wire)) == messages


@pytest.mark.parametrize("verdict", ["auth", "host_key"])
def test_auth_and_host_key_verdicts_are_never_retried(tmp_path, run_async, verdict):
    key, key_path = _client_key(tmp_path)
    stranger = ed25519.Ed25519PrivateKey.generate()

    async def flow():
        srv = await minissh.serve(
            authorized_keys={"tester": [stranger if verdict == "auth" else key]})
        attempts = []
        t = ssh.SSHTransport(
            hostname="127.0.0.1", port=srv.port, username="tester", backend="minissh",
            ssh_key_file=key_path, known_host_key=(
                srv.host_key.public_key() if verdict == "auth"
                else ed25519.Ed25519PrivateKey.generate().public_key()))
        opened = t._open

        async def counted():
            attempts.append(1)
            await opened()

        t._open = counted
        try:
            with pytest.raises(minissh.MiniSSHAuthError if verdict == "auth"
                               else minissh.MiniSSHHostKeyError) as caught:
                await ssh.connect_with_retries(t, max_attempts=5, retry_wait_time=0.01)
        finally:
            srv.close()
            await srv.wait_closed()
        return len(attempts), caught.value

    attempts, error = run_async(flow())
    assert attempts == 1
    label = "ssh_auth" if verdict == "auth" else "ssh_host_key"
    assert resilience.classify_error(error) == (resilience.FaultClass.PERMANENT, label)
    # the verdict stays permanent under an aggregating wrapper (_connect_all's)
    wrapped = TransportError("failed to connect to 1/1 workers")
    wrapped.__cause__ = error
    assert resilience.classify_error(wrapped)[0] is resilience.FaultClass.PERMANENT
    # the reference classifies the bare verdict permanent too
    assert ref_resilience.classify_error(error)[0].value == "permanent"
