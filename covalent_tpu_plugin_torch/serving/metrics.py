"""Serving metrics of the replica sets, the disaggregated set and handoffs.

Own copy of the replica-set, router, hedging, KV-transfer and handoff families of
``covalent_tpu_plugin/serving/metrics.py`` (same names, labels and
buckets), so one dashboard reads either package.  Label cardinality is
low: every ``outcome``/``state``/``path`` label is a closed set.  The
per-session request, token and latency families, the engine's prefix and
speculative counters, and the profile capture come with ROADMAP item 2c.5.
"""

from __future__ import annotations

from ..obs.metrics import REGISTRY

# -- replica sets -----------------------------------------------------------
# ``state`` is one of open, reconnecting, failed, closed; series of a closed
# set are removed when it closes.

SERVE_REPLICAS = REGISTRY.gauge(
    "covalent_tpu_serve_replicas",
    "Replica-set member sessions by state",
    ("set", "state"),
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
