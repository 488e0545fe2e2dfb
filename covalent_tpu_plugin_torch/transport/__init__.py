"""Control-plane transports of the PyTorch port.

* :class:`LocalTransport`: subprocesses and file copies on the dispatcher
  itself (no sshd needed).
* :class:`SSHTransport`: one SSH channel to a worker, on asyncssh, the
  OpenSSH binaries or the pure-Python :mod:`.minissh` stack (imported only
  when that backend opens, since it needs ``cryptography``), with
  :func:`connect_with_retries`.
* :class:`TransportPool`: one live transport per worker, reused across
  electrons.
* :mod:`.codec`: compression and bundled transfers; :mod:`.process` and
  :mod:`.frames`: the pool server's persistent channel and its binary frames.

The chaos wrapper of the reference (``transport/chaos.py``) is not ported yet.
"""

from .base import CommandResult, Transport, TransportError
from .codec import Codec, CodecIntegrityError
from .local import LocalTransport
from .pool import TransportPool
from .ssh import SSHTransport, connect_with_retries

__all__ = [
    "Codec",
    "CodecIntegrityError",
    "CommandResult",
    "LocalTransport",
    "SSHTransport",
    "Transport",
    "TransportError",
    "TransportPool",
    "connect_with_retries",
]
