"""Resident serving: load the model once on a worker's card, then serve
request-level streams over the held-open channel for the session's life.

Own copy of ``covalent_tpu_plugin/serving``:

* :func:`open_session` — ship a model factory by digest, open ONE session on
  the resident runtime of an executor or a fleet ``Pool`` (the pool server,
  or a ``--serve-child`` of the native agent), get a :class:`ServeHandle`
  back; ``capture_profile`` traces that runtime while it serves.
* :class:`SessionSupervisor` — the supervised session behind it: reconnect
  after channel death, exactly-once ``idx``-spliced stream replay, the warm
  handoff (planned, or on the worker's SIGTERM preemption notice), and the
  journal records from which ``fleet.recovery.recover`` re-adopts a
  session that outlived its dispatcher (``adopt``/``resume_stream``).
* :func:`open_replica_set` — N sessions of one factory behind a
  :class:`ReplicaRouter` (sticky, prefix affinity, least-loaded, in
  per-tenant DRR order), with health, canaries, hedging, drain-on-death
  and ``scale_to``.
* :func:`open_disaggregated_set` — a replica set split into a prefill tier
  and a decode tier, joined by content-addressed KV bundles that ride
  binary frames.

Every session moves the per-session families of :mod:`.metrics` and one
trace per request.  A session may host a bank of LoRA adapters, attached and
detached while it serves (:mod:`.registry` keeps their bundles).
"""

from .disagg import DisaggregatedSet, open_disaggregated_set
from .handle import ServeError, ServeHandle, ServeRequest, ServeRequestRejected, open_session
from .replicas import ReplicaRouter, ReplicaSet, ReplicaView, open_replica_set
from .supervisor import SessionSupervisor

__all__ = ["DisaggregatedSet", "ReplicaRouter", "ReplicaSet", "ReplicaView", "ServeError",
           "ServeHandle", "ServeRequest", "ServeRequestRejected", "SessionSupervisor",
           "open_disaggregated_set", "open_replica_set", "open_session"]
