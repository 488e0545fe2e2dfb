"""Resident serving: load the model once on a worker's card, then serve
request-level streams over the held-open channel for the session's life.

Own copy of the one-session part of ``covalent_tpu_plugin/serving``:

* :func:`open_session` — ship a model factory by digest, open ONE session on
  the executor's resident pool server, get a :class:`ServeHandle` back.
* :class:`SessionSupervisor` — the supervised session behind it: reconnect
  after channel death, exactly-once ``idx``-spliced stream replay.

Replica sets, the disaggregated set, recovery, handoff and serving metrics
come with ROADMAP item 2c.
"""

from .handle import ServeError, ServeHandle, ServeRequest, ServeRequestRejected, open_session
from .supervisor import SessionSupervisor

__all__ = ["ServeError", "ServeHandle", "ServeRequest", "ServeRequestRejected",
           "SessionSupervisor", "open_session"]
