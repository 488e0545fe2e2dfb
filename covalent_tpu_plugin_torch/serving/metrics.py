"""Serving metrics: request outcomes, stream latency, session load, the
replica sets, the disaggregated set and handoffs.

Own copy of ``covalent_tpu_plugin/serving/metrics.py`` (same names, labels
and buckets), so one dashboard reads either package.  Label cardinality is
low: every ``outcome``/``state``/``path`` label is a closed set, and the
per-session gauges key on the handle's sid (stable across reconnect
generations), not on a generation's remote id.  The speculative accept
rate comes with slice 3b (speculative decoding).
"""

from __future__ import annotations

from ..obs.metrics import REGISTRY

# -- sessions ---------------------------------------------------------------

#: Terminal accounting of every request submitted through a session:
#: ``ok`` (the whole stream delivered), ``deadline`` (the lane was reclaimed
#: at its deadline: a partial stream, ``error`` on the last chunk), ``shed``
#: (refused at admission: the bounded queue was full), ``rejected`` (refused
#: for another reason) and ``error`` (a torn stream, a session dead past its
#: retry budget, a close with the request in flight).
SERVE_REQUESTS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_requests_total",
    "Serving-session requests by terminal outcome",
    ("outcome",),
)

SERVE_TOKENS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_tokens_total",
    "Tokens streamed back to serving-session callers",
)

SERVE_SESSIONS = REGISTRY.gauge(
    "covalent_tpu_serve_sessions",
    "Live serving sessions held open by this dispatcher",
)

SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "covalent_tpu_serve_queue_depth",
    "Worker-side admission queue depth per serving session",
    ("session",),
)

SERVE_TOKENS_PER_S = REGISTRY.gauge(
    "covalent_tpu_serve_tokens_per_s",
    "Worker-reported aggregate decode throughput per serving session",
    ("session",),
)

SERVE_RECONNECTS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_reconnects_total",
    "Serving sessions re-opened after a channel/worker death",
)

#: Submit -> first streamed chunk.
SERVE_TTFT_SECONDS = REGISTRY.histogram(
    "covalent_tpu_serve_ttft_seconds",
    "Serving-request time to first streamed token",
)

SERVE_REQUEST_SECONDS = REGISTRY.histogram(
    "covalent_tpu_serve_request_seconds",
    "Serving-request full-stream latency (submit -> final chunk)",
)

#: The worker's slot occupancy as the dispatcher last saw it (the
#: reference feeds it from heartbeats; the supervisor reaps its series when
#: the last session on a worker closes).
SERVE_WORKER_SLOTS = REGISTRY.gauge(
    "covalent_tpu_serve_worker_slots",
    "Serving slot occupancy reported by worker heartbeats",
    ("worker", "state"),
)

# -- replica sets -----------------------------------------------------------
# ``state`` is one of open, reconnecting, failed, closed; series of a closed
# set are removed when it closes.  Per-replica series key on (set, replica)
# and are removed when the replica retires.

SERVE_REPLICAS = REGISTRY.gauge(
    "covalent_tpu_serve_replicas",
    "Replica-set member sessions by state",
    ("set", "state"),
)

SERVE_REPLICA_REQUESTS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_replica_requests_total",
    "Requests submitted to each replica of a serving replica set",
    ("set", "replica"),
)

SERVE_REPLICA_IN_FLIGHT = REGISTRY.gauge(
    "covalent_tpu_serve_replica_in_flight",
    "In-flight requests assigned to each replica of a serving replica set",
    ("set", "replica"),
)

#: Router placements by outcome: ``sticky`` (a pinned caller's replica),
#: ``prefix_affinity`` (the replica whose prefix tree is warm for the
#: prompt), ``least_loaded``, ``adapter_affinity``, ``queued`` (no open
#: replica had headroom: the DRR queue), ``shed`` (the router's admission
#: bound), ``failover`` (re-routed off a dead replica).
SERVE_ROUTER_DECISIONS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_router_decisions_total",
    "Replica-set router placement decisions by outcome",
    ("outcome",),
)

#: The router's own DRR queue depth (not the fleet scheduler's
#: ``covalent_tpu_queue_depth``: two queues on one series would overwrite
#: each other's tenant depths).
SERVE_ROUTER_QUEUE_DEPTH = REGISTRY.gauge(
    "covalent_tpu_serve_router_queue_depth",
    "Requests waiting in a replica-set router's per-tenant DRR queue",
    ("tenant",),
)

#: The router's whole per-request cost.
SERVE_ROUTER_DECISION_SECONDS = REGISTRY.histogram(
    "covalent_tpu_serve_router_decision_seconds",
    "Replica-set router per-request decision latency",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05, 0.25),
)

# -- the engine's prefix counters (per session, from ``serve.stats``) --------
# Set from every stats record of engines that report them, reaped with the
# other per-session gauges when the session closes.

SERVE_PREFIX_HITS = REGISTRY.gauge(
    "covalent_tpu_serve_prefix_hits",
    "Engine prefix-tree admission hits per serving session",
    ("session",),
)

SERVE_PREFIX_MISSES = REGISTRY.gauge(
    "covalent_tpu_serve_prefix_misses",
    "Engine prefix-tree admission misses per serving session",
    ("session",),
)

SERVE_PREFILL_POSITIONS = REGISTRY.gauge(
    "covalent_tpu_serve_prefill_positions",
    "Prefill positions paid by a serving session's engine "
    "(suffix buckets on prefix hits, full-prompt buckets on misses)",
    ("session",),
)

# -- quantized decoding --------------------------------------------------------
# Fed by the engine's ``mode_tokens_<mode>`` counters through the stats
# backhaul; ``mode`` is a closed set (models/quant.py SERVING_MODES), so the
# supervisor's reap enumerates it.

SERVE_MODE_TOKENS = REGISTRY.gauge(
    "covalent_tpu_serve_mode_tokens",
    "Output tokens per serving session by decode-mode lane group "
    "(fp / int8 / kv_quant / full_quant)",
    ("session", "mode"),
)

# -- multi-adapter serving -----------------------------------------------------
# Fed by the engine's ``adapter_*`` counters.  The ``adapter`` label set is
# open (operators name adapters): the supervisor tracks the (session,
# adapter) pairs it created and reaps exactly those.  Attach latency is the
# dispatcher's wall time: CAS stage, the wire round trip, the engine splice.

SERVE_ADAPTERS = REGISTRY.gauge(
    "covalent_tpu_serve_adapters",
    "LoRA adapters currently attached per serving session",
    ("session",),
)

SERVE_ADAPTER_TOKENS = REGISTRY.gauge(
    "covalent_tpu_serve_adapter_tokens",
    "Output tokens per serving session by adapter lane "
    "(cumulative; 'base' is the un-adapted lane)",
    ("session", "adapter"),
)

SERVE_ADAPTER_REQUESTS_TOTAL = REGISTRY.gauge(
    "covalent_tpu_serve_adapter_requests_total",
    "Requests admitted per serving session by adapter "
    "(cumulative engine counter, gauge-backed so the worker restates "
    "it on every stats tick)",
    ("session", "adapter"),
)

SERVE_ADAPTER_ATTACHES_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_adapter_attaches_total",
    "Adapter attach/detach operations by outcome",
    ("op", "outcome"),
)

SERVE_ADAPTER_ATTACH_SECONDS = REGISTRY.histogram(
    "covalent_tpu_serve_adapter_attach_seconds",
    "Live adapter attach wall time: CAS stage -> engine splice ack",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)

# -- disaggregated prefill/decode -------------------------------------------
# ``outcome`` of a transfer: ok, error, digest_mismatch, fallback (no live
# prefill replica).  ``path`` of a request: disagg (admitted from a shipped
# bundle), fallback (the prefill round trip failed: full prefill on the
# decode replica), direct (short prompt, or the kill switch).

SERVE_KV_TRANSFERS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_kv_transfers_total",
    "KV bundle transfers between the prefill and decode tiers by outcome",
    ("outcome",),
)

SERVE_KV_TRANSFER_BYTES_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_kv_transfer_bytes_total",
    "Serialized KV bundle bytes shipped from the prefill tier",
)

SERVE_KV_TRANSFER_SECONDS = REGISTRY.histogram(
    "covalent_tpu_serve_kv_transfer_seconds",
    "Prefill-tier round trip: serve_prefill submit -> verified bundle",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
)

SERVE_DISAGG_REQUESTS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_disagg_requests_total",
    "Requests through a disaggregated set by road taken",
    ("path",),
)

# -- tail-latency hedging ----------------------------------------------------
# ``outcome``: launched, won (the hedge arm delivered first), lost (the
# primary did), budget (over COVALENT_TPU_HEDGE_BUDGET_PCT), no_target (no
# other replica with headroom).

SERVE_HEDGES_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_hedges_total",
    "Tail-latency hedge decisions by outcome",
    ("outcome",),
)

# -- warm handoff --------------------------------------------------------------
# ``outcome``: ok (the session runs on the replacement generation), failed
# (the replacement did not open; the reconnect road still guards the old
# one).

SERVE_HANDOFFS_TOTAL = REGISTRY.counter(
    "covalent_tpu_serve_handoffs_total",
    "Warm session handoffs (replacement opened BEFORE the old gang died)",
    ("outcome",),
)
