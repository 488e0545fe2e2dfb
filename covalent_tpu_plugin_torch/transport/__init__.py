"""Control-plane transports of the PyTorch port (local only in this slice;
SSH, pooling, chaos and the codec come with a later slice)."""

from .base import CommandResult, Transport, TransportError
from .local import LocalTransport

__all__ = ["CommandResult", "LocalTransport", "Transport", "TransportError"]
