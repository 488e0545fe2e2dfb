"""Control-plane transports of the PyTorch port: the local transport and
its persistent process channels (JSONL).  SSH, pooling, chaos, the codec
and binary frames come with later slices."""

from .base import CommandResult, Transport, TransportError
from .local import LocalTransport

__all__ = ["CommandResult", "LocalTransport", "Transport", "TransportError"]
