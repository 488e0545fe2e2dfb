"""A minimal, real SSH-2.0 implementation, client and server, on asyncio
(own copy of ``covalent_tpu_plugin/transport/minissh.py``; the wire is
the same, and a test holds each side against the other package's).

Hosts with no SSH stack at all (no ``sshd``, no OpenSSH client binaries,
no asyncssh) still tend to ship ``cryptography``.  This module implements
the SSH 2.0 wire protocol on top of it:

* transport layer (RFC 4253): version exchange, binary packet protocol,
  ``curve25519-sha256`` key exchange (RFC 8731), ``ssh-ed25519`` host keys
  (RFC 8709), ``aes128-ctr`` encryption (RFC 4344) and ``hmac-sha2-256``
  integrity (RFC 6668) in both directions;
* authentication (RFC 4252): ``password`` and ``publickey`` (ed25519,
  signature verified over the session identifier per §7);
* connection layer (RFC 4254): ``session`` channels with ``exec``
  requests, stdin/stdout/stderr streaming, window flow control and
  ``exit-status`` delivery.

The algorithm lists are honest SSH name-lists, so the stack negotiates
with real peers.  Scope cuts: one kex/cipher/mac suite, no re-keying
(RFC 4253 §9 recommends a rekey after 1 GB), no compression, no port
forwarding, no SFTP subsystem (file transfer rides ``exec`` + ``cat``,
see :meth:`MiniSSHConnection.put`), no pty.  None of these are needed by
a control plane whose jobs are "stage files, launch harness, poll pid,
fetch result, hold the pool server's channel".

One departure from the reference copy: a client channel's stdout reader
takes lines up to 16 MiB (:data:`_LINE_LIMIT`), as the local transport's
pipes do, since a pool server's protocol line (a factory's open error, a
stats record) may pass asyncio's 64 KiB default.

Import it only where it is used (:class:`~.ssh.SSHTransport` does so in
``_open``): it needs ``cryptography`` at import.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac as hmac_mod
import os
import shlex
import struct
from dataclasses import dataclass

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519, x25519
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

__all__ = [
    "MiniSSHError",
    "MiniSSHAuthError",
    "MiniSSHHostKeyError",
    "MiniSSHConnection",
    "MiniSSHServer",
    "connect",
    "serve",
    "generate_host_key",
    "host_key_fingerprint",
]

_VERSION = b"SSH-2.0-minissh_0.1 covalent_tpu_plugin_torch"

# Message numbers (RFC 4253 §12, RFC 4252 §6, RFC 4254 §9).
MSG_DISCONNECT = 1
MSG_IGNORE = 2
MSG_UNIMPLEMENTED = 3
MSG_DEBUG = 4
MSG_SERVICE_REQUEST = 5
MSG_SERVICE_ACCEPT = 6
MSG_KEXINIT = 20
MSG_NEWKEYS = 21
MSG_KEX_ECDH_INIT = 30
MSG_KEX_ECDH_REPLY = 31
MSG_USERAUTH_REQUEST = 50
MSG_USERAUTH_FAILURE = 51
MSG_USERAUTH_SUCCESS = 52
MSG_USERAUTH_BANNER = 53
MSG_GLOBAL_REQUEST = 80
MSG_REQUEST_SUCCESS = 81
MSG_REQUEST_FAILURE = 82
MSG_CHANNEL_OPEN = 90
MSG_CHANNEL_OPEN_CONFIRMATION = 91
MSG_CHANNEL_OPEN_FAILURE = 92
MSG_CHANNEL_WINDOW_ADJUST = 93
MSG_CHANNEL_DATA = 94
MSG_CHANNEL_EXTENDED_DATA = 95
MSG_CHANNEL_EOF = 96
MSG_CHANNEL_CLOSE = 97
MSG_CHANNEL_REQUEST = 98
MSG_CHANNEL_SUCCESS = 99
MSG_CHANNEL_FAILURE = 100

_KEX_ALG = b"curve25519-sha256"
_HOSTKEY_ALG = b"ssh-ed25519"
_CIPHER_ALG = b"aes128-ctr"
_MAC_ALG = b"hmac-sha2-256"
_COMP_ALG = b"none"

_WINDOW = 1 << 21  # 2 MiB initial window per channel side
_MAX_PACKET = 1 << 15
_LINE_LIMIT = 16 << 20  # longest stdout line a client channel's reader takes


class MiniSSHError(ConnectionError):
    """Protocol or connection failure (subclasses ConnectionError so the
    transport retry classifier treats it as retryable)."""


class MiniSSHAuthError(RuntimeError):
    """Authentication rejected by the server.

    Deliberately NOT a ConnectionError: auth verdicts are deterministic,
    so the transport's bounded-retry classifier must fail them fast
    instead of reconnecting five times (asyncssh's PermissionDenied has
    the same non-OSError property).
    """


class MiniSSHHostKeyError(RuntimeError):
    """Server host key does not match the pinned key (possible MITM).

    Never retryable — a mismatch is a security verdict, not a transient.
    """


# -- wire primitives (RFC 4251 §5) ----------------------------------------

def _u32(n: int) -> bytes:
    return struct.pack(">I", n)


def _byte(n: int) -> bytes:
    return struct.pack(">B", n)


def _string(b: bytes) -> bytes:
    return _u32(len(b)) + b


def _mpint(n: int) -> bytes:
    if n == 0:
        return _u32(0)
    raw = n.to_bytes((n.bit_length() + 8) // 8, "big")  # sign byte space
    raw = raw.lstrip(b"\x00") if raw[0] == 0 and not raw[1] & 0x80 else raw
    if raw[0] & 0x80:
        raw = b"\x00" + raw
    return _string(raw)


class _Reader:
    """Cursor over one decoded packet payload."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def byte(self) -> int:
        self.off += 1
        return self.data[self.off - 1]

    def boolean(self) -> bool:
        return self.byte() != 0

    def u32(self) -> int:
        self.off += 4
        return struct.unpack(">I", self.data[self.off - 4:self.off])[0]

    def string(self) -> bytes:
        n = self.u32()
        self.off += n
        return self.data[self.off - n:self.off]

    def namelist(self) -> list[bytes]:
        raw = self.string()
        return raw.split(b",") if raw else []


# -- key material -----------------------------------------------------------

def generate_host_key() -> ed25519.Ed25519PrivateKey:
    """Fresh ed25519 host key (fixtures regenerate per test server)."""
    return ed25519.Ed25519PrivateKey.generate()


def _ed25519_blob(pub: ed25519.Ed25519PublicKey) -> bytes:
    raw = pub.public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    return _string(_HOSTKEY_ALG) + _string(raw)


def _ed25519_from_blob(blob: bytes) -> ed25519.Ed25519PublicKey:
    r = _Reader(blob)
    alg = r.string()
    if alg != _HOSTKEY_ALG:
        raise MiniSSHError(f"unsupported key algorithm {alg!r}")
    return ed25519.Ed25519PublicKey.from_public_bytes(r.string())


def _ed25519_sig_blob(sig: bytes) -> bytes:
    return _string(_HOSTKEY_ALG) + _string(sig)


def _ed25519_sig_from_blob(blob: bytes) -> bytes:
    r = _Reader(blob)
    if r.string() != _HOSTKEY_ALG:
        raise MiniSSHError("unsupported signature algorithm")
    return r.string()


def host_key_fingerprint(key) -> str:
    """``SHA256:<hex>`` fingerprint of a public (or private) host key."""
    if hasattr(key, "public_key"):
        key = key.public_key()
    return "SHA256:" + hashlib.sha256(_ed25519_blob(key)).hexdigest()


# -- binary packet protocol (RFC 4253 §6) -----------------------------------

class _PacketStream:
    """Framing + (optional) aes128-ctr / hmac-sha2-256 for one direction.

    The classic SSH construction: MAC over (sequence_number || plaintext
    packet), cipher over the whole packet including its length field.
    CTR keystream state persists across packets (RFC 4344 §4).
    """

    def __init__(self) -> None:
        self.seq = 0
        self._cipher = None
        self._mac_key = b""
        self.block = 8

    def arm(self, key: bytes, iv: bytes, mac_key: bytes, encrypt: bool) -> None:
        c = Cipher(algorithms.AES(key), modes.CTR(iv))
        self._cipher = c.encryptor() if encrypt else c.decryptor()
        self._mac_key = mac_key
        self.block = 16

    def _mac(self, seq: int, packet: bytes) -> bytes:
        return hmac_mod.new(
            self._mac_key, _u32(seq) + packet, hashlib.sha256
        ).digest()

    def wrap(self, payload: bytes) -> bytes:
        pad = self.block - (5 + len(payload)) % self.block
        if pad < 4:
            pad += self.block
        packet = (
            _u32(1 + len(payload) + pad) + _byte(pad) + payload
            + os.urandom(pad)
        )
        out = packet
        mac = b""
        if self._cipher is not None:
            mac = self._mac(self.seq, packet)
            out = self._cipher.update(packet)
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        return out + mac

    async def read_packet(self, reader: asyncio.StreamReader) -> bytes:
        head = await reader.readexactly(self.block)
        if self._cipher is not None:
            head_plain = self._cipher.update(head)
        else:
            head_plain = head
        length = struct.unpack(">I", head_plain[:4])[0]
        if not 1 <= length <= 4 * _MAX_PACKET:
            raise MiniSSHError(f"bad packet length {length}")
        # RFC 4253 §6: the total packet (4-byte length field + payload)
        # must be a whole number of cipher blocks.  A garbled/hostile
        # length that violates this would otherwise feed readexactly a
        # negative count (ValueError) or desync the CTR keystream —
        # reject it as a clean protocol error instead.
        if length < self.block - 4 or (4 + length) % self.block:
            raise MiniSSHError(
                f"invalid packet length {length} for cipher block size "
                f"{self.block}"
            )
        rest = await reader.readexactly(4 + length - self.block)
        if self._cipher is not None:
            rest_plain = self._cipher.update(rest) if rest else b""
            packet = head_plain + rest_plain
            mac = await reader.readexactly(32)
            if not hmac_mod.compare_digest(mac, self._mac(self.seq, packet)):
                raise MiniSSHError("MAC verification failed")
        else:
            packet = head_plain + rest
        pad = packet[4]
        payload = packet[5:4 + length - pad]
        self.seq = (self.seq + 1) & 0xFFFFFFFF
        return payload


def _kexinit_payload() -> bytes:
    lists = [
        _KEX_ALG,          # kex_algorithms
        _HOSTKEY_ALG,      # server_host_key_algorithms
        _CIPHER_ALG,       # encryption c2s
        _CIPHER_ALG,       # encryption s2c
        _MAC_ALG,          # mac c2s
        _MAC_ALG,          # mac s2c
        _COMP_ALG,         # compression c2s
        _COMP_ALG,         # compression s2c
        b"",               # languages c2s
        b"",               # languages s2c
    ]
    out = _byte(MSG_KEXINIT) + os.urandom(16)
    for item in lists:
        out += _string(item)
    return out + _byte(0) + _u32(0)


def _check_kexinit(payload: bytes) -> bool:
    """Verify the peer offers our one suite (RFC 4253 §7.1 negotiation
    degenerates to set-intersection against singleton lists).

    Returns whether a *wrongly guessed* first kex packet follows the
    peer's KEXINIT (RFC 4253 §7, ``first_kex_packet_follows``): the guess
    is only right when the peer's FIRST-listed kex and host-key
    algorithms match the negotiated (our singleton) choice; a mismatched
    guess means the caller must read and discard one packet before the
    real key exchange, instead of desyncing the handshake on it.
    """
    r = _Reader(payload)
    r.byte()
    r.off += 16  # cookie
    wanted = [_KEX_ALG, _HOSTKEY_ALG, _CIPHER_ALG, _CIPHER_ALG,
              _MAC_ALG, _MAC_ALG, _COMP_ALG, _COMP_ALG]
    offered_lists = []
    for want in wanted:
        offered = r.namelist()
        offered_lists.append(offered)
        if want not in offered:
            raise MiniSSHError(
                f"no common algorithm: need {want.decode()}, "
                f"peer offers {b','.join(offered).decode()!r}"
            )
    r.namelist()  # languages client-to-server
    r.namelist()  # languages server-to-client
    first_kex_packet_follows = r.boolean()
    guess_right = (
        offered_lists[0][:1] == [_KEX_ALG]
        and offered_lists[1][:1] == [_HOSTKEY_ALG]
    )
    return first_kex_packet_follows and not guess_right


def _derive(letter: bytes, k_mp: bytes, h: bytes, session_id: bytes,
            size: int) -> bytes:
    """RFC 4253 §7.2 key derivation, extended as needed."""
    out = hashlib.sha256(k_mp + h + letter + session_id).digest()
    while len(out) < size:
        out += hashlib.sha256(k_mp + h + out).digest()
    return out[:size]


# -- channels ---------------------------------------------------------------

class _Channel:
    """One RFC 4254 session channel (either side)."""

    def __init__(self, conn: "_Connection", local_id: int) -> None:
        self.conn = conn
        self.local_id = local_id
        self.remote_id = -1
        self.send_window = 0
        self.max_packet = _MAX_PACKET
        self.recv_left = _WINDOW
        self.opened = asyncio.get_event_loop().create_future()
        self.reply: asyncio.Future | None = None
        self.stdout = asyncio.StreamReader(limit=_LINE_LIMIT)
        self.stderr_buf = bytearray()
        self.exit_status: int | None = None
        self.closed = asyncio.Event()
        self.eof_sent = False
        self.close_sent = False
        self._window_free = asyncio.Event()
        # Server side: the local process this channel drives, plus the
        # stdin queue its pump drains (window replenished on consumption).
        self.proc: asyncio.subprocess.Process | None = None
        self.stdin_q: asyncio.Queue | None = None
        self.pump_tasks: list[asyncio.Task] = []

    def grant(self, n: int) -> None:
        self.send_window += n
        if self.send_window > 0:
            self._window_free.set()

    async def send_data(self, data: bytes, ext: int | None = None) -> None:
        """Window-respecting CHANNEL_DATA writes (RFC 4254 §5.2)."""
        view = memoryview(data)
        while view:
            while self.send_window <= 0:
                if self.closed.is_set():
                    raise MiniSSHError("channel closed while writing")
                self._window_free.clear()
                if self.closed.is_set() or self.send_window > 0:
                    continue  # closed (or credit) raced the clear
                await self._window_free.wait()
            if self.closed.is_set():
                raise MiniSSHError("channel closed while writing")
            n = min(len(view), self.send_window, self.max_packet - 64)
            chunk = bytes(view[:n])
            view = view[n:]
            self.send_window -= n
            if ext is None:
                await self.conn.send(
                    _byte(MSG_CHANNEL_DATA) + _u32(self.remote_id)
                    + _string(chunk)
                )
            else:
                await self.conn.send(
                    _byte(MSG_CHANNEL_EXTENDED_DATA) + _u32(self.remote_id)
                    + _u32(ext) + _string(chunk)
                )

    async def consume(self, n: int) -> None:
        """Account received bytes; replenish the peer's window at half."""
        self.recv_left -= n
        if self.recv_left < _WINDOW // 2 and self.remote_id >= 0:
            add = _WINDOW - self.recv_left
            self.recv_left = _WINDOW
            await self.conn.send(
                _byte(MSG_CHANNEL_WINDOW_ADJUST) + _u32(self.remote_id)
                + _u32(add)
            )

    async def send_eof(self) -> None:
        if not self.eof_sent and self.remote_id >= 0:
            self.eof_sent = True
            await self.conn.send(
                _byte(MSG_CHANNEL_EOF) + _u32(self.remote_id)
            )

    async def send_close(self) -> None:
        if self.remote_id >= 0 and not self.close_sent:
            self.close_sent = True
            await self.conn.send(
                _byte(MSG_CHANNEL_CLOSE) + _u32(self.remote_id)
            )


class _Connection:
    """Shared post-kex machinery: the encrypted packet loop + channels."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        self.inbound = _PacketStream()
        self.outbound = _PacketStream()
        self.session_id = b""
        self.channels: dict[int, _Channel] = {}
        self._next_channel = 0
        self._send_lock = asyncio.Lock()
        self.loop_task: asyncio.Task | None = None
        self.lost_error: BaseException | None = None
        self.lost = asyncio.Event()

    async def send(self, payload: bytes) -> None:
        async with self._send_lock:
            self.writer.write(self.outbound.wrap(payload))
            await self.writer.drain()

    def new_channel(self) -> _Channel:
        ch = _Channel(self, self._next_channel)
        self.channels[self._next_channel] = ch
        self._next_channel += 1
        return ch

    # -- version + kex (role-parameterized) -------------------------------

    async def _exchange_versions(self) -> bytes:
        self.writer.write(_VERSION + b"\r\n")
        await self.writer.drain()
        # RFC 4253 §4.2: peers may send banner lines before the version.
        for _ in range(32):
            line = await asyncio.wait_for(self.reader.readline(), 30)
            if line.startswith(b"SSH-"):
                return line.rstrip(b"\r\n")
        raise MiniSSHError("no SSH version line from peer")

    async def _kex(self, *, server: bool, host_key=None,
                   expected_host_key=None) -> None:
        peer_version = await self._exchange_versions()
        if not peer_version.startswith(b"SSH-2.0-"):
            raise MiniSSHError(f"unsupported SSH version {peer_version!r}")
        my_kexinit = _kexinit_payload()
        await self.send(my_kexinit)
        peer_kexinit = await self.inbound.read_packet(self.reader)
        if peer_kexinit[0] != MSG_KEXINIT:
            raise MiniSSHError("expected KEXINIT")
        discard_guess = _check_kexinit(peer_kexinit)

        if server:
            v_c, v_s = peer_version, _VERSION
            i_c, i_s = peer_kexinit, my_kexinit
            if discard_guess:
                # RFC 4253 §7: the peer optimistically sent its first kex
                # packet for an algorithm we didn't negotiate — ignore it;
                # the peer re-sends the correct one.
                await self.inbound.read_packet(self.reader)
            pkt = await self.inbound.read_packet(self.reader)
            if pkt[0] != MSG_KEX_ECDH_INIT:
                raise MiniSSHError("expected KEX_ECDH_INIT")
            q_c = _Reader(pkt[1:]).string()
            eph = x25519.X25519PrivateKey.generate()
            q_s = eph.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
            shared = eph.exchange(
                x25519.X25519PublicKey.from_public_bytes(q_c)
            )
            k_s = _ed25519_blob(host_key.public_key())
            k_mp = _mpint(int.from_bytes(shared, "big"))
            h = hashlib.sha256(
                _string(v_c) + _string(v_s) + _string(i_c) + _string(i_s)
                + _string(k_s) + _string(q_c) + _string(q_s) + k_mp
            ).digest()
            sig = host_key.sign(h)
            await self.send(
                _byte(MSG_KEX_ECDH_REPLY) + _string(k_s) + _string(q_s)
                + _string(_ed25519_sig_blob(sig))
            )
        else:
            v_c, v_s = _VERSION, peer_version
            i_c, i_s = my_kexinit, peer_kexinit
            eph = x25519.X25519PrivateKey.generate()
            q_c = eph.public_key().public_bytes(
                serialization.Encoding.Raw, serialization.PublicFormat.Raw
            )
            await self.send(_byte(MSG_KEX_ECDH_INIT) + _string(q_c))
            if discard_guess:
                # Mirror of the server-side discard: a server that guessed
                # an unnegotiated suite sent one bogus kex packet first.
                await self.inbound.read_packet(self.reader)
            pkt = await self.inbound.read_packet(self.reader)
            if pkt[0] != MSG_KEX_ECDH_REPLY:
                raise MiniSSHError("expected KEX_ECDH_REPLY")
            r = _Reader(pkt[1:])
            k_s = r.string()
            q_s = r.string()
            sig = _ed25519_sig_from_blob(r.string())
            shared = eph.exchange(
                x25519.X25519PublicKey.from_public_bytes(q_s)
            )
            k_mp = _mpint(int.from_bytes(shared, "big"))
            h = hashlib.sha256(
                _string(v_c) + _string(v_s) + _string(i_c) + _string(i_s)
                + _string(k_s) + _string(q_c) + _string(q_s) + k_mp
            ).digest()
            server_pub = _ed25519_from_blob(k_s)
            try:
                server_pub.verify(sig, h)
            except Exception as error:
                raise MiniSSHError(f"host key signature invalid: {error}")
            if expected_host_key is not None:
                if host_key_fingerprint(server_pub) != host_key_fingerprint(
                    expected_host_key
                ):
                    raise MiniSSHHostKeyError(
                        "host key mismatch (strict checking enabled)"
                    )

        self.session_id = h
        await self.send(_byte(MSG_NEWKEYS))
        pkt = await self.inbound.read_packet(self.reader)
        if pkt[0] != MSG_NEWKEYS:
            raise MiniSSHError("expected NEWKEYS")
        # Directional keys: client-to-server uses A/C/E, server-to-client
        # B/D/F (RFC 4253 §7.2).
        def keys(letters: bytes):
            iv = _derive(letters[0:1], k_mp, h, h, 16)
            key = _derive(letters[1:2], k_mp, h, h, 16)
            mac = _derive(letters[2:3], k_mp, h, h, 32)
            return key, iv, mac

        c2s, s2c = keys(b"ACE"), keys(b"BDF")
        if server:
            self.inbound.arm(*c2s, encrypt=False)
            self.outbound.arm(*s2c, encrypt=True)
        else:
            self.outbound.arm(*c2s, encrypt=True)
            self.inbound.arm(*s2c, encrypt=False)

    # -- connection-layer dispatch ----------------------------------------

    async def _handle_channel_msg(self, msg: int, r: _Reader) -> bool:
        """Messages common to both roles; returns True when consumed."""
        if msg == MSG_CHANNEL_WINDOW_ADJUST:
            ch = self.channels.get(r.u32())
            if ch:
                ch.grant(r.u32())
            return True
        if msg == MSG_CHANNEL_DATA:
            ch = self.channels.get(r.u32())
            data = r.string()
            if ch:
                # Window accounting is role-specific: the client consumes
                # at receipt; the SERVER defers to its stdin pump so the
                # peer's window only replenishes once the subprocess has
                # actually taken the bytes (otherwise a stalled command
                # would buffer unboundedly — and awaiting the pipe drain
                # HERE would block the one packet loop, deadlocking
                # against our own outbound flow control).
                await self._channel_data(ch, data, None)
            return True
        if msg == MSG_CHANNEL_EXTENDED_DATA:
            ch = self.channels.get(r.u32())
            code = r.u32()
            data = r.string()
            if ch:
                await self._channel_data(ch, data, code)
            return True
        if msg == MSG_CHANNEL_EOF:
            ch = self.channels.get(r.u32())
            if ch:
                await self._channel_eof(ch)
            return True
        if msg == MSG_CHANNEL_CLOSE:
            ch = self.channels.get(r.u32())
            if ch:
                await ch.send_close()
                ch.closed.set()
                ch._window_free.set()  # wake writers: they see closed + raise
                ch.stdout.feed_eof()
                self.channels.pop(ch.local_id, None)
                await self._channel_closed(ch)
            return True
        if msg in (MSG_IGNORE, MSG_DEBUG):
            return True
        if msg == MSG_GLOBAL_REQUEST:
            name = r.string()
            want_reply = r.boolean()
            if want_reply:
                await self.send(_byte(MSG_REQUEST_FAILURE))
            del name
            return True
        if msg == MSG_DISCONNECT:
            code = r.u32()
            desc = r.string()
            raise MiniSSHError(
                f"peer disconnected (code {code}): {desc.decode(errors='replace')}"
            )
        return False

    async def _channel_data(self, ch, data, ext):  # role-specific
        raise NotImplementedError

    async def _channel_eof(self, ch):
        pass

    async def _channel_closed(self, ch):
        pass

    async def close(self) -> None:
        if self.loop_task is not None:
            self.loop_task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass


# -- client -----------------------------------------------------------------

@dataclass
class CompletedCommand:
    exit_status: int
    stdout: str
    stderr: str


class MiniSSHProcess:
    """Client handle for one exec channel (duck-types what the transport's
    ``TransportProcess`` wrapper needs: ``.stdout``, ``.stdin``,
    ``.exit_status``/``.returncode``, ``.terminate``/``.wait_closed``)."""

    def __init__(self, conn: "MiniSSHConnection", ch: _Channel) -> None:
        self._conn = conn
        self._ch = ch
        self.stdout = ch.stdout
        self.stdin = _ChannelStdin(ch)

    @property
    def exit_status(self) -> int | None:
        return self._ch.exit_status

    returncode = exit_status

    @property
    def stderr_bytes(self) -> bytes:
        return bytes(self._ch.stderr_buf)

    def terminate(self) -> None:
        asyncio.ensure_future(self._ch.send_close())

    def kill(self) -> None:
        self.terminate()

    async def wait(self) -> int | None:
        await self._ch.closed.wait()
        return self._ch.exit_status

    async def wait_closed(self) -> None:
        await self._ch.closed.wait()


class _ChannelStdin:
    """Write side of an exec channel, asyncio-StreamWriter-shaped."""

    def __init__(self, ch: _Channel) -> None:
        self._ch = ch
        self._pending: list[bytes] = []

    def write(self, data: bytes) -> None:
        self._pending.append(bytes(data))

    async def drain(self) -> None:
        pending, self._pending = self._pending, []
        for chunk in pending:
            await self._ch.send_data(chunk)

    def write_eof(self) -> None:
        task = asyncio.ensure_future(self._ch.send_eof())
        # an EOF on a connection already lost has nothing to tell anyone
        task.add_done_callback(lambda t: t.cancelled() or t.exception())

    def close(self) -> None:
        self.write_eof()

    async def wait_closed(self) -> None:
        return


class MiniSSHConnection(_Connection):
    """Client side: ``connect()`` → ``run``/``create_process``/``put``/``get``."""

    async def _authenticate(self, username: str, password: str | None,
                            client_key) -> None:
        await self.send(
            _byte(MSG_SERVICE_REQUEST) + _string(b"ssh-userauth")
        )
        pkt = await self.inbound.read_packet(self.reader)
        if pkt[0] != MSG_SERVICE_ACCEPT:
            raise MiniSSHError("service ssh-userauth refused")

        if client_key is not None:
            pub_blob = _ed25519_blob(client_key.public_key())
            body = (
                _byte(MSG_USERAUTH_REQUEST)
                + _string(username.encode())
                + _string(b"ssh-connection")
                + _string(b"publickey")
                + _byte(1)
                + _string(_HOSTKEY_ALG)
                + _string(pub_blob)
            )
            sig = client_key.sign(_string(self.session_id) + body)
            await self.send(body + _string(_ed25519_sig_blob(sig)))
        else:
            await self.send(
                _byte(MSG_USERAUTH_REQUEST)
                + _string(username.encode())
                + _string(b"ssh-connection")
                + _string(b"password")
                + _byte(0)
                + _string((password or "").encode())
            )
        while True:
            pkt = await self.inbound.read_packet(self.reader)
            if pkt[0] == MSG_USERAUTH_SUCCESS:
                return
            if pkt[0] == MSG_USERAUTH_FAILURE:
                raise MiniSSHAuthError(
                    f"authentication failed for user {username!r}"
                )
            if pkt[0] in (MSG_USERAUTH_BANNER, MSG_IGNORE, MSG_DEBUG):
                continue
            raise MiniSSHError(f"unexpected auth reply {pkt[0]}")

    async def _run_loop(self) -> None:
        try:
            while True:
                payload = await self.inbound.read_packet(self.reader)
                r = _Reader(payload)
                msg = r.byte()
                if await self._handle_channel_msg(msg, r):
                    continue
                if msg == MSG_CHANNEL_OPEN_CONFIRMATION:
                    ch = self.channels.get(r.u32())
                    if ch:
                        ch.remote_id = r.u32()
                        ch.grant(r.u32())
                        ch.max_packet = r.u32()
                        if not ch.opened.done():
                            ch.opened.set_result(True)
                elif msg == MSG_CHANNEL_OPEN_FAILURE:
                    ch = self.channels.get(r.u32())
                    code = r.u32()
                    desc = r.string().decode(errors="replace")
                    if ch and not ch.opened.done():
                        ch.opened.set_exception(
                            MiniSSHError(f"channel open failed ({code}): {desc}")
                        )
                elif msg in (MSG_CHANNEL_SUCCESS, MSG_CHANNEL_FAILURE):
                    ch = self.channels.get(r.u32())
                    if ch and ch.reply is not None and not ch.reply.done():
                        ch.reply.set_result(msg == MSG_CHANNEL_SUCCESS)
                elif msg == MSG_CHANNEL_REQUEST:
                    ch = self.channels.get(r.u32())
                    name = r.string()
                    want_reply = r.boolean()
                    if name == b"exit-status" and ch:
                        ch.exit_status = r.u32()
                    if want_reply and ch and ch.remote_id >= 0:
                        await self.send(
                            _byte(MSG_CHANNEL_FAILURE) + _u32(ch.remote_id)
                        )
                elif msg == MSG_UNIMPLEMENTED:
                    pass
                else:
                    await self.send(
                        _byte(MSG_UNIMPLEMENTED) + _u32(self.inbound.seq - 1)
                    )
        except (asyncio.CancelledError, asyncio.IncompleteReadError):
            pass
        except Exception as error:  # noqa: BLE001
            self.lost_error = error
        finally:
            for ch in list(self.channels.values()):
                ch.closed.set()
                ch._window_free.set()
                ch.stdout.feed_eof()
            self.lost.set()

    async def _channel_data(self, ch, data, ext):
        await ch.consume(len(data))
        if ext == 1:
            ch.stderr_buf.extend(data)
        elif ext is None:
            ch.stdout.feed_data(data)

    async def _channel_eof(self, ch):
        ch.stdout.feed_eof()

    # -- public API --------------------------------------------------------

    async def open_exec(self, command: str) -> MiniSSHProcess:
        ch = self.new_channel()
        await self.send(
            _byte(MSG_CHANNEL_OPEN) + _string(b"session")
            + _u32(ch.local_id) + _u32(_WINDOW) + _u32(_MAX_PACKET)
        )
        await ch.opened
        ch.reply = asyncio.get_event_loop().create_future()
        await self.send(
            _byte(MSG_CHANNEL_REQUEST) + _u32(ch.remote_id)
            + _string(b"exec") + _byte(1) + _string(command.encode())
        )
        ok = await ch.reply
        if not ok:
            raise MiniSSHError(f"exec request refused: {command!r}")
        return MiniSSHProcess(self, ch)

    async def run(self, command: str,
                  stdin: bytes = b"") -> CompletedCommand:
        proc = await self.open_exec(command)
        if stdin:
            proc.stdin.write(stdin)
            await proc.stdin.drain()
        proc.stdin.write_eof()
        out = await proc.stdout.read()
        await proc.wait_closed()
        status = proc.exit_status
        return CompletedCommand(
            exit_status=status if status is not None else -1,
            stdout=out.decode(errors="replace"),
            stderr=proc.stderr_bytes.decode(errors="replace"),
        )

    async def put(self, local_path: str, remote_path: str) -> None:
        """Upload over exec+cat: binary-safe, no SFTP subsystem needed.
        Streams in fixed chunks through the window-respecting data path —
        peak memory is O(chunk), not O(file)."""
        proc = await self.open_exec(f"cat > {shlex.quote(remote_path)}")
        with open(local_path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 18)
                if not chunk:
                    break
                proc.stdin.write(chunk)
                await proc.stdin.drain()
        proc.stdin.write_eof()
        await proc.wait_closed()
        if proc.exit_status != 0:
            raise MiniSSHError(
                "upload failed: "
                + proc.stderr_bytes.decode(errors="replace").strip()
            )

    async def get(self, remote_path: str, local_path: str) -> None:
        proc = await self.open_exec(f"cat {shlex.quote(remote_path)}")
        proc.stdin.write_eof()
        # Stream into a sibling temp file; only a SUCCESSFUL download
        # claims local_path (a failed cat must not leave partial output).
        tmp = f"{local_path}.minissh-part"
        try:
            with open(tmp, "wb") as fh:
                while True:
                    chunk = await proc.stdout.read(1 << 18)
                    if not chunk:
                        break
                    fh.write(chunk)
            await proc.wait_closed()
            if proc.exit_status != 0:
                raise MiniSSHError(
                    "download failed: "
                    + proc.stderr_bytes.decode(errors="replace").strip()
                )
            os.replace(tmp, local_path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def close(self) -> None:  # asyncssh-shaped: sync close + wait_closed
        if self.loop_task is not None:
            self.loop_task.cancel()
        try:
            self.writer.close()
        except Exception:
            pass

    async def wait_closed(self) -> None:
        try:
            await self.writer.wait_closed()
        except Exception:
            pass


async def connect(
    host: str,
    port: int,
    username: str,
    *,
    password: str | None = None,
    client_key=None,
    known_host_key=None,
    connect_timeout: float = 30.0,
) -> MiniSSHConnection:
    """Open, kex, verify (optionally) and authenticate a client channel.

    ``client_key`` is an ``Ed25519PrivateKey`` or a path to an OpenSSH-
    format private key file; ``known_host_key`` pins the server host key
    (strict checking) — ``None`` accepts any host key, mirroring
    ``known_hosts=None`` semantics.
    """
    if isinstance(client_key, (str, os.PathLike)):
        with open(client_key, "rb") as fh:
            client_key = serialization.load_ssh_private_key(fh.read(), None)
    if client_key is not None and not isinstance(
        client_key, ed25519.Ed25519PrivateKey
    ):
        raise ValueError(
            "minissh supports only ed25519 client keys; got "
            f"{type(client_key).__name__} (generate one with "
            "ssh-keygen -t ed25519, or pin backend='asyncssh'/'openssh')"
        )
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), connect_timeout
    )
    conn = MiniSSHConnection(reader, writer)
    try:
        await asyncio.wait_for(
            conn._kex(server=False, expected_host_key=known_host_key),
            connect_timeout,
        )
        await asyncio.wait_for(
            conn._authenticate(username, password, client_key),
            connect_timeout,
        )
    except Exception:
        conn.close()
        raise
    conn.loop_task = asyncio.ensure_future(conn._run_loop())
    return conn


# -- server -----------------------------------------------------------------

class _ServerConnection(_Connection):
    """One accepted client: kex, auth, then exec channels running local
    subprocesses (the test fixture's 'remote' host is localhost, exactly
    like the reference's functional tier pointed at a real host)."""

    def __init__(self, reader, writer, server: "MiniSSHServer") -> None:
        super().__init__(reader, writer)
        self.server = server
        self.username = ""

    async def handshake(self) -> None:
        await self._kex(server=True, host_key=self.server.host_key)
        # Service + auth (RFC 4252).
        pkt = await self.inbound.read_packet(self.reader)
        r = _Reader(pkt)
        if r.byte() != MSG_SERVICE_REQUEST or r.string() != b"ssh-userauth":
            raise MiniSSHError("expected service request ssh-userauth")
        await self.send(_byte(MSG_SERVICE_ACCEPT) + _string(b"ssh-userauth"))
        for _ in range(8):
            pkt = await self.inbound.read_packet(self.reader)
            r = _Reader(pkt)
            if r.byte() != MSG_USERAUTH_REQUEST:
                raise MiniSSHError("expected userauth request")
            user = r.string().decode()
            service = r.string()
            method = r.string()
            if service != b"ssh-connection":
                raise MiniSSHError(f"unsupported service {service!r}")
            if method == b"password" and not r.boolean():
                password = r.string().decode()
                expected = self.server.users.get(user)
                # compare_digest: the password check must not leak match
                # length/prefix through timing (RFC 4252 §8 caution).
                if expected is not None and hmac_mod.compare_digest(
                    expected.encode(), password.encode()
                ):
                    self.username = user
                    await self.send(_byte(MSG_USERAUTH_SUCCESS))
                    return
            elif method == b"publickey" and r.boolean():
                alg = r.string()
                blob = r.string()
                sig_blob = r.string()
                signed = _string(self.session_id) + pkt[: r.off - 4 - len(sig_blob)]
                if alg == _HOSTKEY_ALG and any(
                    blob == k for k in self.server.keys_for(user)
                ):
                    try:
                        _ed25519_from_blob(blob).verify(
                            _ed25519_sig_from_blob(sig_blob), signed
                        )
                        self.username = user
                        await self.send(_byte(MSG_USERAUTH_SUCCESS))
                        return
                    except Exception:  # noqa: BLE001 - bad signature
                        pass
            await self.send(
                _byte(MSG_USERAUTH_FAILURE)
                + _string(b"publickey,password") + _byte(0)
            )
        raise MiniSSHError("too many failed auth attempts")

    async def serve_loop(self) -> None:
        try:
            while True:
                payload = await self.inbound.read_packet(self.reader)
                r = _Reader(payload)
                msg = r.byte()
                if await self._handle_channel_msg(msg, r):
                    continue
                if msg == MSG_CHANNEL_OPEN:
                    kind = r.string()
                    sender = r.u32()
                    window = r.u32()
                    max_packet = r.u32()
                    if kind != b"session":
                        await self.send(
                            _byte(MSG_CHANNEL_OPEN_FAILURE) + _u32(sender)
                            + _u32(3) + _string(b"unknown channel type")
                            + _string(b"")
                        )
                        continue
                    ch = self.new_channel()
                    ch.remote_id = sender
                    ch.grant(window)
                    ch.max_packet = max_packet
                    ch.stdin_q = asyncio.Queue()
                    await self.send(
                        _byte(MSG_CHANNEL_OPEN_CONFIRMATION) + _u32(sender)
                        + _u32(ch.local_id) + _u32(_WINDOW) + _u32(_MAX_PACKET)
                    )
                elif msg == MSG_CHANNEL_REQUEST:
                    ch = self.channels.get(r.u32())
                    name = r.string()
                    want_reply = r.boolean()
                    if ch is None:
                        continue
                    if name == b"exec" and ch.proc is None:
                        command = r.string().decode()
                        await self._start_exec(ch, command, want_reply)
                    elif want_reply:
                        await self.send(
                            _byte(MSG_CHANNEL_FAILURE) + _u32(ch.remote_id)
                        )
                else:
                    await self.send(
                        _byte(MSG_UNIMPLEMENTED) + _u32(self.inbound.seq - 1)
                    )
        except (asyncio.CancelledError, asyncio.IncompleteReadError,
                ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001 - one client must not kill the server
            pass
        finally:
            for ch in list(self.channels.values()):
                if ch.proc is not None and ch.proc.returncode is None:
                    try:
                        ch.proc.kill()
                    except ProcessLookupError:
                        pass
                for task in ch.pump_tasks:
                    task.cancel()
            try:
                self.writer.close()
            except Exception:
                pass
            self.server._connections.discard(self)

    async def _start_exec(self, ch: _Channel, command: str,
                          want_reply: bool) -> None:
        try:
            ch.proc = await asyncio.create_subprocess_shell(
                command,
                stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE,
                cwd=self.server.cwd,
                env=self.server.env,
            )
        except Exception as error:  # noqa: BLE001
            if want_reply:
                await self.send(
                    _byte(MSG_CHANNEL_FAILURE) + _u32(ch.remote_id)
                )
            del error
            return
        if want_reply:
            await self.send(_byte(MSG_CHANNEL_SUCCESS) + _u32(ch.remote_id))

        async def pump_in():
            while True:
                data = await ch.stdin_q.get()
                if data is None:
                    if ch.proc.stdin is not None:
                        try:
                            ch.proc.stdin.close()
                        except Exception:
                            pass
                    break
                try:
                    if ch.proc.stdin is not None:
                        ch.proc.stdin.write(data)
                        await ch.proc.stdin.drain()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                # Only now is the peer's window replenished: backpressure
                # reaches the client instead of buffering here.
                await ch.consume(len(data))

        async def pump_out(stream, ext):
            while True:
                chunk = await stream.read(16384)
                if not chunk:
                    break
                await ch.send_data(chunk, ext)

        async def finish():
            await asyncio.gather(
                pump_out(ch.proc.stdout, None),
                pump_out(ch.proc.stderr, 1),
            )
            status = await ch.proc.wait()
            await ch.send_eof()
            await self.send(
                _byte(MSG_CHANNEL_REQUEST) + _u32(ch.remote_id)
                + _string(b"exit-status") + _byte(0) + _u32(status & 0xFF)
            )
            await ch.send_close()

        ch.pump_tasks.append(asyncio.ensure_future(pump_in()))
        ch.pump_tasks.append(asyncio.ensure_future(finish()))

    async def _channel_data(self, ch, data, ext):
        if ch.stdin_q is not None:
            # Never blocks: in-flight bytes are bounded by the window we
            # granted, and we only re-grant from the pump below.
            ch.stdin_q.put_nowait(data)

    async def _channel_eof(self, ch):
        if ch.stdin_q is not None:
            ch.stdin_q.put_nowait(None)

    async def _channel_closed(self, ch):
        """Client closed the channel: the command must die with it (the
        asyncssh/openssh backends kill on close; `TransportProcess.close
        (kill=True)` relies on that)."""
        if ch.proc is not None and ch.proc.returncode is None:
            try:
                ch.proc.kill()
            except ProcessLookupError:
                pass
        for task in ch.pump_tasks:
            task.cancel()


class MiniSSHServer:
    """An in-process SSH server: a real sshd for tests and the card's smoke run.

    ``users`` maps username → password; ``authorized_keys`` accepts
    either a dict ``username -> [ed25519 public keys]`` (production
    shape: a key authenticates only the user it was authorized for) or a
    bare list of keys accepted for ANY username — the test-server
    convenience, matching fixtures that don't care about usernames; keys
    may be key objects or wire blobs.  Exec requests run as local
    subprocesses under ``cwd``/``env`` — pointing a transport at
    ``127.0.0.1`` makes localhost the worker host, the same shape as the
    reference's functional tier against a real machine.
    """

    def __init__(self, host_key=None, users: dict[str, str] | None = None,
                 authorized_keys=(), cwd: str | None = None,
                 env: dict | None = None) -> None:
        def blob(k):
            if isinstance(k, (bytes, bytearray)):
                return bytes(k)
            return _ed25519_blob(
                k.public_key() if hasattr(k, "public_key") else k
            )

        self.host_key = host_key or generate_host_key()
        self.users = dict(users or {})
        if isinstance(authorized_keys, dict):
            self.authorized_keys: "dict[str, list[bytes]] | list[bytes]" = {
                user: [blob(k) for k in keys]
                for user, keys in authorized_keys.items()
            }
        else:
            self.authorized_keys = [blob(k) for k in authorized_keys]
        self.cwd = cwd
        self.env = env
        self._server: asyncio.AbstractServer | None = None
        self._connections: set[_ServerConnection] = set()
        self.port = 0

    def keys_for(self, user: str) -> "list[bytes]":
        """Authorized key blobs for ``user`` (the global-list form accepts
        any username — test-server behavior, see class docstring)."""
        if isinstance(self.authorized_keys, dict):
            return self.authorized_keys.get(user, [])
        return self.authorized_keys

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._server = await asyncio.start_server(self._accept, host, port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _accept(self, reader, writer) -> None:
        conn = _ServerConnection(reader, writer, self)
        self._connections.add(conn)
        try:
            await asyncio.wait_for(conn.handshake(), 30)
        except Exception:  # noqa: BLE001 - failed handshake: drop the client
            try:
                writer.close()
            except Exception:
                pass
            self._connections.discard(conn)
            return
        conn.loop_task = asyncio.ensure_future(conn.serve_loop())

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        for conn in list(self._connections):
            if conn.loop_task is not None:
                conn.loop_task.cancel()
            try:
                conn.writer.close()
            except Exception:
                pass

    async def wait_closed(self) -> None:
        if self._server is not None:
            await self._server.wait_closed()

    async def __aenter__(self) -> "MiniSSHServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()
        await self.wait_closed()


async def serve(host: str = "127.0.0.1", port: int = 0,
                **kwargs) -> MiniSSHServer:
    server = MiniSSHServer(**kwargs)
    await server.start(host, port)
    return server
