"""Control-plane transports of the PyTorch port: the local transport, its
persistent process channels and their binary frames (:mod:`.frames`).
SSH, pooling, chaos and the file-staging codec come with later slices."""

from .base import CommandResult, Transport, TransportError
from .local import LocalTransport

__all__ = ["CommandResult", "LocalTransport", "Transport", "TransportError"]
