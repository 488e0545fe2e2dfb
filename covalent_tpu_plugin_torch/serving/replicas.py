"""Horizontally scaled serving: N replica sessions behind one handle.

Own copy of ``covalent_tpu_plugin/serving/replicas.py``.  One resident
session's throughput ceiling is one engine's slot count, and one session
is one host loop; a :class:`ReplicaSet` opens N sessions of the SAME engine
factory (N pool servers, each a process with its own loop, on one card or
several) and fronts them with a session-aware router.  Each replica is one
:class:`~.supervisor.SessionSupervisor` — the reconnect and exactly-once
replay a single :class:`~.handle.ServeHandle` runs — so scale adds no new
failure semantics, only placement:

* **Sticky, then prefix affinity, then least-loaded, in DRR order.**
  Every request passes a per-tenant :class:`~..fleet.queue.FairWorkQueue`:
  under contention deficit round-robin decides *whose* request goes next.
  ``request(..., sticky="user-42")`` pins a multi-turn caller to one
  replica (refreshed on use, expired after ``sticky_ttl_s``; the pin
  survives the replica's reconnects).  A request sharing a prompt prefix
  with an earlier one steers to the replica whose prefix tree is warm for
  it.  Otherwise the least-loaded open replica takes it (rotation breaks
  ties).  With free capacity the queue is pass-through.
* **Health, canaries, hedging.**  Replicas feed the fleet's
  :data:`~..fleet.health.HEALTH` monitor; a degraded replica routes last,
  a quarantined one gets no traffic until a canary ping readmits it.  A
  deterministic request whose first token is later than the set's recent
  TTFT percentile is hedged: the same request goes to a second replica,
  the first to deliver wins and the other arm is cancelled; the idx splice
  keeps the stream the same either way.
* **Drain-on-death.**  A replica that dies past its retry budget hands its
  in-flight requests back (``detach_requests``) and the router re-routes
  them onto survivors: their own high-water marks keep the cross-replica
  replay exactly-once.  A replayed token that differs from the delivered
  one is counted by road (``status()["replay_mismatches"]``).
* **Scale.**  ``scale_to(n)`` opens or drain-closes replicas;
  ``scale_to(0)`` suspends the set, and the next request re-warms it.

Targets are ``GPUExecutor``\\ s; a fleet ``Pool`` target is refused
(ROADMAP item 2c.7), and so are ``attach_adapter``/``detach_adapter``
(slice 3), though the router keeps its adapter-site bookkeeping.  With
journaling on, the set records its target size (``replica_set``) and each
member's entry and exit (``replica``) beside its supervisors' session and
stream records; its tracing spans come with ROADMAP item 2c.5.
"""

from __future__ import annotations

import asyncio
import collections
import os
import time
import uuid
from typing import Any, Callable

import cloudpickle

from ..cache import bytes_digest
from ..fleet import journal as journal_mod
from ..fleet.health import DEGRADED, HEALTH, PROBING, QUARANTINED
from ..fleet.queue import DEFAULT_TENANT, FairWorkQueue, QueueFullError, WorkItem
from ..obs import events as obs_events
from ..utils.log import app_log
from .handle import ADAPTERS, refuse_pool_target
from .metrics import (
    SERVE_HEDGES_TOTAL,
    SERVE_REPLICAS,
    SERVE_ROUTER_DECISION_SECONDS,
    SERVE_ROUTER_DECISIONS_TOTAL,
    SERVE_ROUTER_QUEUE_DEPTH,
)
from .supervisor import ServeError, ServeRequest, ServeRequestRejected, SessionSupervisor

__all__ = ["ReplicaView", "ReplicaRouter", "ReplicaSet", "open_replica_set"]

#: States a replica can be in (the SERVE_REPLICAS gauge's closed label set).
_REPLICA_STATES = ("open", "reconnecting", "failed", "closed")

#: Roads a replayed token can come by (``SessionSupervisor._replay_road``).
_REPLAY_ROADS = ("reconnect", "reroute", "hedge", "handoff", "preempt")


class ReplicaView:
    """One replica's routing-relevant shape: id, health, load, capacity.

    Deliberately tiny and data-only so the router is unit-testable with
    fake fleets and a fake clock — no supervisor, no I/O.
    """

    __slots__ = (
        "rid", "open", "alive", "load", "capacity", "health",
        "degraded", "quarantined",
    )

    def __init__(
        self, rid: str, *, open: bool, load: int, capacity: int,
        alive: bool | None = None, health: float = 1.0,
        degraded: bool = False, quarantined: bool = False,
    ) -> None:
        self.rid = rid
        self.open = bool(open)
        #: open OR recovering: a sticky pin to this replica still holds.
        self.alive = bool(open if alive is None else alive)
        self.load = int(load)
        self.capacity = max(1, int(capacity))
        #: continuous health score in [0, 1] (fleet.health).
        self.health = float(health)
        #: gray-degraded: routable as LAST RESORT only — a healthy
        #: replica with headroom always wins over it.
        self.degraded = bool(degraded)
        #: quarantined: receives NO new traffic; sticky pins drain off it
        #: (re-pin on next use) and only a canary probe readmits it.
        self.quarantined = bool(quarantined)


class ReplicaRouter:
    """Session-aware request router over a set of replica views.

    Synchronous and clock-injectable: :meth:`submit` admits one request
    item (bounded — a full queue sheds, the same capacity verdict the
    worker-side admission queue renders), :meth:`pump` drains the DRR
    queue onto whatever open replicas have headroom and returns the
    ``(item, replica_id, outcome)`` assignments.  The caller (the
    replica set) performs the actual submissions and re-pumps on every
    completion or health transition.

    Sticky semantics: a pinned item only ever places on its pinned
    replica while that replica is *alive* (open or reconnecting) —
    waiting out a reconnect rather than abandoning the replica's warm
    state — and re-pins to a fresh least-loaded choice once the replica
    is gone.  Pins expire ``sticky_ttl_s`` after their last use.
    """

    def __init__(
        self,
        *,
        weights: dict[str, float] | None = None,
        sticky_ttl_s: float = 300.0,
        queue_max: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._clock = clock
        self.sticky_ttl_s = float(sticky_ttl_s)
        self._queue = FairWorkQueue(
            max_depth=queue_max, policy="reject",
            weights=weights, clock=clock,
            # The router's backlog moves its OWN gauge, never the fleet
            # scheduler's (two queues on one series would fight).
            depth_gauge=SERVE_ROUTER_QUEUE_DEPTH,
        )
        #: sticky key -> [replica_id, last_used] (TTL-expired lazily).
        self._sticky: dict[str, list] = {}
        #: prefix key -> replica id that last served a request sharing
        #: that prompt prefix (bounded FIFO): requests carrying the same
        #: key steer to the replica whose engine-side prefix tree is
        #: already warm for it.  A *preference*, never a pin — sticky
        #: sids rank above it, and it only engages when the remembered
        #: replica is open with headroom, so DRR fairness (which decides
        #: WHOSE request pops) is untouched.
        self._prefix_sites: "collections.OrderedDict[str, str]" = (
            collections.OrderedDict()
        )
        self._prefix_sites_max = 1024
        #: adapter name -> replica ids whose engine holds that adapter
        #: resident.  Unlike prefix affinity this is a CONSTRAINT when
        #: known: a replica without the adapter refuses the request
        #: outright, so placement restricts to residents (and defers
        #: when no resident has headroom) rather than merely preferring
        #: them.  An adapter the router has no sites for places
        #: unconstrained — the attach-to-all default, or a caller
        #: naming an unknown adapter (the worker's clean refusal is the
        #: right answer there, not a router stall).
        self._adapter_sites: dict[str, set[str]] = {}
        #: rotation cursor for exact load ties, so equal replicas share.
        self._rr = 0

    # -- introspection ------------------------------------------------------

    @property
    def queued(self) -> int:
        return len(self._queue)

    def backlog(self) -> dict[str, int]:
        return self._queue.backlog()

    def sticky_count(self) -> int:
        self._expire_sticky()
        return len(self._sticky)

    def sticky_target(self, key: str) -> str | None:
        """The live pin for ``key`` (refreshes nothing; expires lazily)."""
        entry = self._sticky.get(key)
        if entry is None:
            return None
        if self._clock() - entry[1] > self.sticky_ttl_s:
            del self._sticky[key]
            return None
        return entry[0]

    def _expire_sticky(self) -> None:
        now = self._clock()
        for key in [
            k for k, (_, used) in self._sticky.items()
            if now - used > self.sticky_ttl_s
        ]:
            del self._sticky[key]

    def pin(self, key: str, replica_id: str) -> None:
        self._sticky[key] = [replica_id, self._clock()]

    def set_queue_max(self, depth: int) -> None:
        """Resize the admission bound (the set does this once replica
        capacity is known; 0 = unbounded)."""
        self._queue.max_depth = max(0, int(depth))

    def forget_replica(self, replica_id: str) -> None:
        """Drop every pin to a retired replica (its pins re-place)."""
        for key in [
            k for k, (rid, _) in self._sticky.items() if rid == replica_id
        ]:
            del self._sticky[key]
        for key in [
            k for k, rid in self._prefix_sites.items()
            if rid == replica_id
        ]:
            del self._prefix_sites[key]
        for name in list(self._adapter_sites):
            self._adapter_sites[name].discard(replica_id)
            if not self._adapter_sites[name]:
                del self._adapter_sites[name]

    def record_prefix_site(self, prefix_key: str, replica_id: str) -> None:
        """Remember which replica last warmed ``prefix_key`` (bounded)."""
        if not prefix_key:
            return
        self._prefix_sites[prefix_key] = replica_id
        self._prefix_sites.move_to_end(prefix_key)
        while len(self._prefix_sites) > self._prefix_sites_max:
            self._prefix_sites.popitem(last=False)

    def prefix_site(self, prefix_key: str) -> str | None:
        return self._prefix_sites.get(prefix_key)

    def record_adapter_site(self, adapter: str, replica_id: str) -> None:
        """Mark ``replica_id``'s engine as holding ``adapter`` resident."""
        if adapter:
            self._adapter_sites.setdefault(adapter, set()).add(replica_id)

    def drop_adapter_site(
        self, adapter: str, replica_id: str | None = None
    ) -> None:
        """Forget residency — one replica's, or (default) everywhere."""
        if replica_id is None:
            self._adapter_sites.pop(adapter, None)
            return
        sites = self._adapter_sites.get(adapter)
        if sites is not None:
            sites.discard(replica_id)
            if not sites:
                del self._adapter_sites[adapter]

    def adapter_sites(self, adapter: str) -> set[str]:
        return set(self._adapter_sites.get(adapter) or ())

    # -- admission + placement ----------------------------------------------

    def submit(self, item: WorkItem) -> None:
        """Admit one request item; raises :class:`QueueFullError` at the
        bound (the caller sheds it as ``serve_admission_shed``)."""
        self._queue.put(item)

    def remove(self, predicate) -> list[WorkItem]:
        return self._queue.remove(predicate)

    def drain(self) -> list[WorkItem]:
        return self._queue.drain()

    def pump(
        self, views: dict[str, ReplicaView]
    ) -> list[tuple[WorkItem, str, str]]:
        """Assign queued items to replicas with headroom, DRR-fairly.

        Pops at most the current depth (one DRR visit per queued item per
        pump): an item whose target has no headroom — or whose sticky
        replica is mid-reconnect — requeues with its original enqueue
        stamp, so fairness age and ``queued`` accounting survive the
        deferral.  Returns ``(item, replica_id, outcome)`` per placement,
        ``outcome`` in ``{"sticky", "prefix_affinity", "least_loaded"}``.
        """
        # Quarantined replicas get NO new traffic: they are excluded from
        # headroom entirely (the canary probe path is their only road
        # back), so every placement rule below — sticky, prefix, least-
        # loaded — routes around them by construction.
        headroom = {
            rid: view.capacity - view.load
            for rid, view in views.items()
            if view.open and not view.quarantined
        }
        assigned: list[tuple[WorkItem, str, str]] = []
        if not headroom:
            return assigned
        deferred: list[WorkItem] = []
        for _ in range(len(self._queue)):
            if not any(free > 0 for free in headroom.values()):
                # Out of lanes: STOP popping.  Draining the rest just to
                # requeue it would reset the DRR lanes' deficit state
                # every pump and hand the head tenant the whole trickle.
                break
            item = self._queue.pop()
            if item is None:
                break
            sticky = str(item.task_metadata.get("sticky") or "")
            prefix_key = str(item.task_metadata.get("prefix_key") or "")
            adapter = str(item.task_metadata.get("adapter") or "")
            # Residency constraint: when the router KNOWS where this
            # request's adapter lives, only those replicas are eligible
            # — anywhere else refuses it outright (unknown_adapter).
            sites = self._adapter_sites.get(adapter) if adapter else None
            constrained = bool(sites)

            def _eligible(rid: str) -> bool:
                return not constrained or rid in sites

            target = None
            outcome = "least_loaded"
            if sticky:
                pinned = self.sticky_target(sticky)
                if pinned is not None:
                    view = views.get(pinned)
                    if (
                        view is not None and view.alive
                        and not view.quarantined
                        # A pin at a replica WITHOUT the adapter falls
                        # through to a fresh (resident) placement and
                        # re-pins there: waiting on the pinned replica
                        # would wait for a refusal.
                        and _eligible(pinned)
                    ):
                        if headroom.get(pinned, 0) > 0:
                            target, outcome = pinned, "sticky"
                        else:
                            # Pinned replica full or reconnecting: wait
                            # for IT (warm per-replica state is the whole
                            # point of the pin) instead of re-placing.
                            deferred.append(item)
                            continue
                    # else: the pin points at a dead OR quarantined
                    # replica — fall through to a fresh placement and
                    # re-pin below (the sticky drain: a browned-out
                    # replica's pinned sessions move off it rather than
                    # waiting out a reconnect that never comes).
            if target is None and prefix_key:
                # Prefix affinity ranks BELOW sticky and above
                # least-loaded, and unlike a pin it never defers: a warm
                # prefix tree is worth steering toward, not waiting on.
                site = self.prefix_site(prefix_key)
                if (
                    site is not None and headroom.get(site, 0) > 0
                    and _eligible(site)
                ):
                    view = views.get(site)
                    if view is not None and view.open:
                        target, outcome = site, "prefix_affinity"
            if target is None:
                pool = (
                    {
                        rid: free for rid, free in headroom.items()
                        if rid in sites
                    }
                    if constrained else headroom
                )
                target = self._least_loaded(views, pool)
                if target is None:
                    # Constrained and no resident lane free: wait for
                    # one (the adapter IS attached somewhere) rather
                    # than burning the request on a certain refusal.
                    deferred.append(item)
                    continue
                if constrained:
                    outcome = "adapter_affinity"
                if sticky:
                    self.pin(sticky, target)
            if outcome == "sticky":
                # Refresh the pin's TTL on use: a multi-turn caller stays
                # put as long as its turns keep landing.
                self.pin(sticky, target)
            if prefix_key:
                self.record_prefix_site(prefix_key, target)
            headroom[target] -= 1
            assigned.append((item, target, outcome))
        for item in deferred:
            # enqueued_at survives a requeue (FairWorkQueue keeps the
            # first stamp), so deferral never resets fairness age.
            self._queue.put(item)
        return assigned

    def _least_loaded(
        self, views: dict[str, ReplicaView], headroom: dict[str, int]
    ) -> str | None:
        """The open replica with the most free lanes (ties rotate).

        Health-aware: gray-degraded replicas are LAST-RESORT — they only
        receive work when no healthy replica has headroom.  Routing a
        request to a 10x-slower replica because it happens to be least
        loaded is exactly the tail-latency trap this avoids.
        """
        candidates = [
            rid for rid, free in headroom.items() if free > 0
        ]
        if not candidates:
            return None
        healthy = [rid for rid in candidates if not views[rid].degraded]
        pool = healthy or candidates
        # Effective load folds in this pump's own assignments (headroom
        # already decremented), so one burst spreads instead of piling
        # onto the momentarily-least-loaded replica.
        best = min(
            views[rid].capacity - headroom[rid] for rid in pool
        )
        tied = [
            rid for rid in pool
            if views[rid].capacity - headroom[rid] == best
        ]
        self._rr += 1
        return tied[self._rr % len(tied)]


class ReplicaSet:
    """N supervised serving sessions of one engine factory, one front.

    Build it through :func:`open_replica_set`.  The request surface is
    :meth:`~.handle.ServeHandle.request`'s plus ``tenant=`` and ``sticky=``;
    streams, results, deadlines, rejections and exactly-once delivery are
    the supervisor's, as for one session.
    """

    def __init__(self, targets: list[Any], factory: Any, *, replicas: int | None = None,
                 name: str = "", sticky_ttl_s: float | None = None,
                 router_queue_max: int | None = None,
                 tenant_weights: dict[str, float] | None = None,
                 **session_options: Any) -> None:
        if not targets:
            raise ValueError("a replica set needs at least one target")
        for target in targets:
            refuse_pool_target(target)
        self.name = name or f"rset-{uuid.uuid4().hex[:8]}"
        self.factory = factory
        self._targets = list(targets)
        self.replicas_wanted = int(replicas if replicas is not None else len(self._targets))
        if self.replicas_wanted < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas_wanted}")
        self._session_options = dict(session_options)
        self._router_queue_max = router_queue_max
        self.router = ReplicaRouter(
            weights=tenant_weights,
            sticky_ttl_s=300.0 if sticky_ttl_s is None else float(sticky_ttl_s),
            queue_max=0,  # resized once the replicas' capacity is known
        )
        #: replica id -> supervisor (a failed one stays until retired)
        self._replicas: dict[str, SessionSupervisor] = {}
        #: replica id -> the executor it was placed on
        self._placements: dict[str, Any] = {}
        self._payload: bytes | None = None
        self._digest = ""
        self._next_rid = 0
        self._next_replica = 0
        self._closed = False
        #: scale-to-zero: True between a drain to zero and the re-warm the
        #: next request (or a scale-up) triggers
        self._suspended = False
        self._resume_to = 1
        #: serializes scale transitions with each other and with a request
        #: that arrives mid-teardown (it waits, then re-warms)
        self._scale_lock = asyncio.Lock()
        self._pump_tasks: set[asyncio.Task] = set()
        #: recent router decision times (seconds)
        self.decision_s: collections.deque = collections.deque(maxlen=4096)
        #: requests placed per replica id (the router's outcome, hedges apart)
        self.placed: collections.Counter = collections.Counter()
        #: requests re-routed off a dead replica
        self.rerouted = 0
        #: replayed-token mismatches of replicas already retired, by road
        self._retired_mismatches = dict.fromkeys(_REPLAY_ROADS, 0)
        # Tail-latency hedging: a deterministic, unpinned request whose
        # first token is later than the set's adaptive TTFT percentile goes
        # to a second replica as well; budgeted to
        # COVALENT_TPU_HEDGE_BUDGET_PCT of the requests issued.
        self._hedge_enabled = os.environ.get("COVALENT_TPU_HEDGE", "on").strip().lower() \
            not in ("off", "0", "false", "disabled")
        self._hedge_percentile = float(os.environ.get("COVALENT_TPU_HEDGE_PERCENTILE", "95")
                                       or 95)
        self._hedge_min_s = float(os.environ.get("COVALENT_TPU_HEDGE_MIN_S", "0.05") or 0.05)
        self._hedge_budget_pct = float(os.environ.get("COVALENT_TPU_HEDGE_BUDGET_PCT", "5")
                                       or 5)
        #: recent times to first token (both arms of a hedge feed it)
        self._ttft_ring: collections.deque = collections.deque(maxlen=512)
        self._hedge_issued = 0
        self._hedge_wins = 0
        self._requests_issued = 0

    # -- views --------------------------------------------------------------

    @property
    def state(self) -> str:
        if self._closed:
            return "closed"
        states = {sup.state for sup in self._replicas.values()}
        if "open" in states:
            return "open"
        if "reconnecting" in states:
            return "reconnecting"
        if self._suspended:
            return "suspended"
        return "failed"

    @property
    def suspended(self) -> bool:
        """Scaled to zero: no live replica; the next request re-warms it."""
        return self._suspended and not any(s.alive for s in self._replicas.values())

    @property
    def live_replicas(self) -> int:
        return len([s for s in self._replicas.values() if s.alive])

    @property
    def supervisors(self) -> dict[str, SessionSupervisor]:
        return dict(self._replicas)

    @property
    def in_flight(self) -> int:
        return sum(sup.in_flight for sup in self._replicas.values())

    @property
    def served(self) -> int:
        return sum(sup.served for sup in self._replicas.values())

    @property
    def reconnects(self) -> int:
        return sum(sup.reconnects for sup in self._replicas.values())

    @property
    def replay_mismatches(self) -> dict[str, int]:
        """Replayed tokens below a stream's high-water mark that differed
        from those delivered, by road (the caller kept what it was given)."""
        counts = dict(self._retired_mismatches)
        for sup in self._replicas.values():
            for road, n in sup.replay_mismatches_by_road.items():
                counts[road] += n
        return counts

    def _views(self) -> dict[str, ReplicaView]:
        views: dict[str, ReplicaView] = {}
        for rid, sup in self._replicas.items():
            # A replica's routable capacity is the worker's own bound
            # (engine slots + admission queue): the router sheds before the
            # worker would.
            capacity = max(1, sup.slots) + max(0, sup.queue_max)
            st = HEALTH.state(sup.sid)
            views[rid] = ReplicaView(
                rid, open=sup.routable, alive=sup.alive, load=sup.in_flight,
                capacity=capacity, health=HEALTH.score(sup.sid),
                # a probing replica's canary is in flight, not passed
                degraded=st in (DEGRADED, PROBING), quarantined=st == QUARANTINED,
            )
            if st == QUARANTINED and sup.alive and HEALTH.allow_probe(sup.sid):
                self._spawn_canary(sup)
        return views

    def _spawn_canary(self, sup: SessionSupervisor) -> None:
        """Probe a quarantined replica with a ping; report the verdict."""

        async def probe() -> None:
            HEALTH.record_probe(sup.sid, await sup.canary())

        try:
            task = asyncio.ensure_future(probe())
        except RuntimeError:
            # no running loop: free the probe slot without a verdict
            HEALTH.release_probe(sup.sid)
            return
        self._keep(task)

    def _keep(self, task: asyncio.Task) -> None:
        """Hold a background task until it ends (the loop keeps weak refs)."""
        self._pump_tasks.add(task)
        task.add_done_callback(
            lambda t: (self._pump_tasks.discard(t), t.cancelled() or t.exception()))

    def status(self) -> dict[str, Any]:
        """The set's view: each replica's, the router's, hedging and the
        replay-mismatch count by road."""
        decisions = sorted(self.decision_s)
        p50 = decisions[len(decisions) // 2] if decisions else 0.0
        return {
            "name": self.name, "state": self.state,
            **({"suspended": True} if self.suspended else {}),
            "replicas": {rid: sup.status() for rid, sup in self._replicas.items()},
            "in_flight": self.in_flight, "served": self.served,
            "reconnects": self.reconnects, "queued": self.router.queued,
            "sticky": self.router.sticky_count(), "placed": dict(self.placed),
            "rerouted": self.rerouted, "replay_mismatches": self.replay_mismatches,
            "router_decision_p50_ms": round(p50 * 1e3, 4),
            "hedge": {"enabled": self._hedge_enabled, "issued": self._hedge_issued,
                      "wins": self._hedge_wins,
                      "threshold_s": round(self._hedge_threshold_s(), 4)},
        }

    def _publish_replica_states(self) -> None:
        counts = dict.fromkeys(_REPLICA_STATES, 0)
        for sup in self._replicas.values():
            counts[sup.state] = counts.get(sup.state, 0) + 1
        for state in _REPLICA_STATES:
            SERVE_REPLICAS.labels(set=self.name, state=state).set(counts[state])

    # -- open / placement ---------------------------------------------------

    async def _open(self) -> "ReplicaSet":
        self._payload = await asyncio.to_thread(cloudpickle.dumps, self.factory)
        self._digest = bytes_digest(self._payload)
        # concurrently: each replica's pool server starts and its model
        # builds at the same time as the others'
        opened = await asyncio.gather(
            *(self._open_replica() for _ in range(self.replicas_wanted)),
            return_exceptions=True)
        failures = [r for r in opened if isinstance(r, BaseException)]
        if len(failures) == len(opened):
            raise ServeError(f"replica set {self.name}: every replica open failed") \
                from failures[0]
        for failure in failures:
            app_log.warning("replica set %s: a replica failed to open (%r); continuing "
                            "degraded", self.name, failure)
        if self._router_queue_max is None:
            # the whole set's worker-side capacity again as router backlog
            total = sum(view.capacity for view in self._views().values())
            self.router.set_queue_max(max(1, total))
        else:
            self.router.set_queue_max(self._router_queue_max)
        self._publish_replica_states()
        journal_mod.record("replica_set", name=self.name, replicas=self.replicas_wanted)
        obs_events.emit("serve.replica_set_opened", set=self.name,
                        replicas=len(self._replicas), wanted=self.replicas_wanted)
        return self

    def _next_target(self) -> Any:
        """Where the next replica goes: the target holding the fewest of
        this set's replicas (the first of them on a tie).  The reference
        ranks fleet pools by digest affinity, warmth and free slots after
        that; those come with Pool targets."""
        assigned = collections.Counter(id(executor) for executor in self._placements.values())
        return min(self._targets, key=lambda executor: assigned[id(executor)])

    async def _open_replica(self) -> SessionSupervisor:
        index = self._next_replica
        self._next_replica += 1
        replica_id = f"r{index}"
        executor = self._next_target()
        self._placements[replica_id] = executor
        supervisor = SessionSupervisor(
            executor, sid=f"{self.name}:{replica_id}", replica_of=(self.name, replica_id),
            on_change=self._on_replica_change, on_failed=self._on_replica_failed,
            **self._session_options,
        )
        self._replicas[replica_id] = supervisor
        try:
            assert self._payload is not None
            await supervisor.open(self._payload, self._digest)
        except BaseException:
            self._replicas.pop(replica_id, None)
            self._placements.pop(replica_id, None)
            raise
        journal_mod.record("replica", set=self.name, sid=supervisor.sid, replica=index)
        self._publish_replica_states()
        return supervisor

    # -- requests -----------------------------------------------------------

    async def request(self, prompt, params: dict | None = None,
                      deadline_s: float | None = None, tenant: str = "",
                      sticky: str = "") -> ServeRequest:
        """Submit one request through the router; returns its stream.

        ``sticky`` names the caller's multi-turn session: its requests pin
        to one replica until ``sticky_ttl_s`` of silence or the replica's
        death.  A request the router cannot place at once waits in the
        per-tenant DRR queue and goes as lanes free.  A full router queue
        sheds with :class:`ServeRequestRejected` (``serve_admission_shed``).
        A set scaled to zero re-warms here first.
        """
        if self._closed:
            raise ServeError(f"replica set {self.name} is closed")
        if not any(s.alive for s in self._replicas.values()):
            if self._suspended:
                await self._ensure_live()
            else:
                raise ServeError(f"replica set {self.name} has no live replicas")
        self._next_rid += 1
        rid = f"{self.name}-r{self._next_rid}"
        request = ServeRequest(rid, [int(t) for t in prompt], params,
                               self._default_deadline_s() if deadline_s is None else deadline_s,
                               tenant)
        request.sticky = sticky
        await self._prepare_request(request)
        item = self._item(request, sticky)
        t0 = time.perf_counter()
        try:
            self.router.submit(item)
        except QueueFullError as err:
            SERVE_ROUTER_DECISIONS_TOTAL.labels(outcome="shed").inc()
            rejection = ServeRequestRejected(rid, "serve_admission_shed", str(err))
            request._fail(rejection)
            raise rejection from None
        if self.suspended:
            # a scale_to(0) drained the set while _prepare_request awaited:
            # re-warm now rather than leave the item where nothing pumps
            try:
                await self._ensure_live()
            except BaseException:
                self.router.remove(lambda it: it.task_metadata.get("request") is request)
                if not request.done:
                    request._fail(ServeError(f"replica set {self.name}: re-warm failed"))
                raise
        assignments = self.router.pump(self._views())
        elapsed = time.perf_counter() - t0
        self.decision_s.append(elapsed)
        SERVE_ROUTER_DECISION_SECONDS.observe(elapsed)
        if not any(i is item for i, _, _ in assignments):
            SERVE_ROUTER_DECISIONS_TOTAL.labels(outcome="queued").inc()
        await self._dispatch_assignments(assignments)
        self._requests_issued += 1
        if self._hedge_eligible(request):
            self._keep(asyncio.ensure_future(self._hedge_watch(request)))
        return request

    @staticmethod
    def _item(request: ServeRequest, sticky: str) -> WorkItem:
        return WorkItem(
            fn=None, args=(), kwargs={},
            task_metadata={"request": request, "sticky": sticky,
                           "prefix_key": request.prefix_key,
                           "adapter": str((request.params or {}).get("adapter") or "")},
            tenant=request.tenant or DEFAULT_TENANT,
        )

    async def attach_adapter(self, name: str, payload: Any = None, **_: Any) -> dict:
        raise NotImplementedError(f"attach_adapter is not ported yet: it comes with {ADAPTERS}")

    async def detach_adapter(self, name: str, timeout_s: float = 30.0) -> dict:
        raise NotImplementedError(f"detach_adapter is not ported yet: it comes with {ADAPTERS}")

    async def _prepare_request(self, request: ServeRequest) -> None:
        """Before the router sees a request: a disaggregated set runs the
        prefill tier here.  The base set does nothing."""

    def _default_deadline_s(self) -> float:
        for sup in self._replicas.values():
            return sup.default_deadline_s
        return 0.0

    async def _dispatch_assignments(self, assignments: list) -> None:
        for item, replica_id, outcome in assignments:
            SERVE_ROUTER_DECISIONS_TOTAL.labels(outcome=outcome).inc()
            request = item.task_metadata["request"]
            supervisor = self._replicas.get(replica_id)
            if supervisor is None or not supervisor.alive:
                self._reroute(request, item.task_metadata.get("sticky", ""))
                continue
            try:
                await supervisor.submit(request, fail_on_error=False, wait_ready=False)
            except Exception as err:  # noqa: BLE001 - re-route, not fail
                if request.done:
                    continue
                app_log.debug("replica %s submit failed (%s); re-routing %s", replica_id, err,
                              request.rid)
                self._reroute(request, item.task_metadata.get("sticky", ""))
                continue
            self.placed[replica_id] += 1

    def _reroute(self, request: ServeRequest, sticky: str = "") -> None:
        """Queue a request again after its replica died under it; the
        sticky key it was submitted with rides along."""
        sticky = sticky or request.sticky
        if request.done:
            return
        if self._closed or not any(s.alive for s in self._replicas.values()):
            request._fail(ServeError(
                f"replica set {self.name}: no live replica to re-route {request.rid} onto"))
            return
        SERVE_ROUTER_DECISIONS_TOTAL.labels(outcome="failover").inc()
        self.rerouted += 1
        # a hedge of it is over with its arms: the replica taking it over
        # must own its stream, not lose it as a hedge's second arm
        request.hedged = False
        try:
            self.router.submit(self._item(request, sticky))
        except QueueFullError as err:
            request._fail(ServeRequestRejected(request.rid, "serve_admission_shed", str(err)))
            return
        self._schedule_pump()

    # -- tail-latency hedging -----------------------------------------------

    def _hedge_eligible(self, request: ServeRequest) -> bool:
        """Only deterministic, unpinned requests hedge: a sampled stream
        would differ between arms, and a pinned one belongs to its replica."""
        if not self._hedge_enabled or request.sticky:
            return False
        if (request.params or {}).get("temperature"):
            return False
        return len([s for s in self._replicas.values() if s.alive]) > 1

    def _hedge_threshold_s(self) -> float:
        """The set's recent TTFT percentile, floored at
        COVALENT_TPU_HEDGE_MIN_S; 1 s until 8 samples (warm-up is not a
        gray failure)."""
        ring = sorted(self._ttft_ring)
        if len(ring) < 8:
            return max(self._hedge_min_s, 1.0)
        k = min(len(ring) - 1, int(len(ring) * self._hedge_percentile / 100.0))
        return max(self._hedge_min_s, ring[k])

    async def _hedge_watch(self, request: ServeRequest) -> None:
        """Hedge one request if its first token is later than the threshold."""
        threshold = self._hedge_threshold_s()
        t0 = time.monotonic()
        try:
            await asyncio.wait_for(request.first_token.wait(), threshold)
        except asyncio.TimeoutError:
            if not request.done and not self._closed:
                await self._launch_hedge(request)
        finally:
            await request.first_token.wait()
            self._ttft_ring.append(request.ttft_s if request.ttft_s is not None
                                   else time.monotonic() - t0)

    async def _launch_hedge(self, request: ServeRequest) -> None:
        """Submit the same request to the healthiest other replica with
        headroom; the first arm to deliver wins, the other is abandoned."""
        if self._hedge_issued + 1 > max(1.0, self._requests_issued
                                        * self._hedge_budget_pct / 100.0):
            SERVE_HEDGES_TOTAL.labels(outcome="budget").inc()
            return
        primary = next((sup for sup in self._replicas.values()
                        if request.rid in sup._requests), None)
        views = self._views()
        candidates = [sup for rid, sup in self._replicas.items()
                      if rid in views and sup.routable and sup is not primary
                      and not views[rid].quarantined
                      and views[rid].capacity - views[rid].load > 0]
        if not candidates:
            SERVE_HEDGES_TOTAL.labels(outcome="no_target").inc()
            return
        candidates.sort(key=lambda sup: (HEALTH.rank(sup.sid), -HEALTH.score(sup.sid),
                                         sup.in_flight))
        target = candidates[0]
        request.hedged = True
        self._hedge_issued += 1
        SERVE_HEDGES_TOTAL.labels(outcome="launched").inc()
        obs_events.emit("serve.hedge", set=self.name, rid=request.rid,
                        primary=primary.sid if primary is not None else "", target=target.sid)
        try:
            await target.submit(request, fail_on_error=False, wait_ready=False)
        except BaseException:
            # the primary is still streaming: not the request's problem
            self._hedge_issued -= 1
            SERVE_HEDGES_TOTAL.labels(outcome="no_target").inc()
            return
        await request.first_token.wait()
        if request.served_by == target.sid:
            self._hedge_wins += 1
            SERVE_HEDGES_TOTAL.labels(outcome="won").inc()
            if primary is not None:
                primary.abandon(request.rid)
                # The primary had not delivered by now: charge it that much
                # latency (a lower bound) and a straggler fault, so a
                # replica that loses hedge after hedge degrades.
                if request.t_dispatched is not None:
                    HEALTH.record_latency(primary.sid, time.monotonic() - request.t_dispatched,
                                          group=self.name)
                HEALTH.record_fault(primary.sid, label="hedge_lost", group=self.name)
        else:
            SERVE_HEDGES_TOTAL.labels(outcome="lost").inc()
            target.abandon(request.rid)

    # -- supervisor hooks (event-loop context) ------------------------------

    def _on_replica_change(self, _supervisor: SessionSupervisor) -> None:
        self._publish_replica_states()
        if not self._closed and self.router.queued:
            self._schedule_pump()

    def _on_replica_failed(self, supervisor: SessionSupervisor,
                           failure: BaseException) -> bool:
        """Drain-on-death: the dead replica's in-flight requests go to the
        survivors, exactly-once (their high-water marks ride along).
        Returns True: the supervisor must not fail them."""
        replica_id = supervisor.replica_of[1] if supervisor.replica_of else supervisor.sid
        detached = supervisor.detach_requests()
        self.router.forget_replica(replica_id)
        obs_events.emit("serve.replica_failed", set=self.name, replica=replica_id,
                        error=repr(failure), rerouted=len(detached))
        for request in detached:
            if not request.arms:  # else a hedge's other arm still streams it
                self._reroute(request)
        if not any(s.alive for s in self._replicas.values()):
            # the last replica died: nothing will pump the queue again
            self._fail_queued(f"replica set {self.name} has no live replicas: {failure}")
        self._publish_replica_states()
        return True

    def _fail_queued(self, message: str) -> None:
        for item in self.router.drain():
            request = item.task_metadata.get("request")
            if request is not None and not request.done:
                request._fail(ServeError(message))

    def _schedule_pump(self) -> None:
        self._keep(asyncio.ensure_future(self._pump()))

    async def _pump(self) -> None:
        if self._closed:
            return
        t0 = time.perf_counter()
        assignments = self.router.pump(self._views())
        if assignments:
            elapsed = (time.perf_counter() - t0) / len(assignments)
            self.decision_s.append(elapsed)
            SERVE_ROUTER_DECISION_SECONDS.observe(elapsed)
            await self._dispatch_assignments(assignments)

    # -- scaling ------------------------------------------------------------

    async def scale_to(self, replicas: int) -> int:
        """Grow or shrink the live replica count; returns the new count.

        Scale-up opens sessions on the ranked targets, concurrently;
        scale-down retires the least-loaded replicas, each drain-closed
        (the worker finishes what it admitted and queued).  ``scale_to(0)``
        suspends the set: the next request (or a scale-up) re-warms it from
        the staged factory, and a request racing the teardown waits for it
        and re-warms; none is dropped.
        """
        if self._closed:
            raise ServeError(f"replica set {self.name} is closed")
        replicas = int(replicas)
        if replicas < 0:
            raise ValueError(f"replicas must be >= 0, got {replicas}")
        async with self._scale_lock:
            count = await self._scale_locked(replicas)
        journal_mod.record("replica_set", name=self.name, replicas=self.replicas_wanted)
        return count

    async def _scale_locked(self, replicas: int) -> int:
        live = {rid: sup for rid, sup in self._replicas.items() if sup.alive}
        if replicas == 0:
            # up before the drain: a request arriving now queues behind the
            # lock and re-warms after
            self._resume_to = max(1, min(self.replicas_wanted, len(live)))
            self._suspended = True
            for rid in list(live):
                await self._retire_replica(rid)
            self.replicas_wanted = 0
            if self.router.queued:
                # demand slipped in during the drain: re-warm for it
                revived = await self._scale_locked(max(1, self._resume_to))
                if revived == 0:
                    self._suspended = True
                    self._fail_queued(f"replica set {self.name}: re-warm failed with "
                                      "queued requests")
                return revived
            self._publish_replica_states()
            obs_events.emit("serve.replica_set_suspended", set=self.name,
                            resume_to=self._resume_to)
            return 0
        resumed = self._suspended
        self._suspended = False
        if replicas > len(live):
            results = await asyncio.gather(
                *(self._open_replica() for _ in range(replicas - len(live))),
                return_exceptions=True)
            for failure in results:
                if isinstance(failure, BaseException):
                    app_log.warning("replica set %s scale-up open failed: %r", self.name,
                                    failure)
            self._schedule_pump()
        elif replicas < len(live):
            for rid in sorted(live, key=lambda r: live[r].in_flight)[:len(live) - replicas]:
                await self._retire_replica(rid)
        self.replicas_wanted = replicas
        self._publish_replica_states()
        now_live = self.live_replicas
        if resumed and now_live == 0:
            self._suspended = True  # the next demand retries the re-warm
        obs_events.emit("serve.replica_set_scaled", set=self.name, replicas=now_live)
        return now_live

    async def _ensure_live(self) -> None:
        """Re-warm a suspended set on first demand (behind the scale lock,
        so a request that raced a drain waits for it)."""
        async with self._scale_lock:
            if self._closed:
                raise ServeError(f"replica set {self.name} is closed")
            if any(s.alive for s in self._replicas.values()):
                return
            if not self._suspended:
                raise ServeError(f"replica set {self.name} has no live replicas")
            if await self._scale_locked(max(1, self._resume_to)) == 0:
                raise ServeError(f"replica set {self.name}: scale-to-zero re-warm failed to "
                                 "open a replica")

    async def _retire_replica(self, replica_id: str) -> None:
        supervisor = self._replicas.pop(replica_id, None)
        self._placements.pop(replica_id, None)
        if supervisor is None:
            return
        self.router.forget_replica(replica_id)
        journal_mod.record("replica", set=self.name, sid=supervisor.sid, state="closed")
        try:
            await supervisor.close()
        except Exception as err:  # noqa: BLE001 - teardown is best-effort
            app_log.warning("replica %s:%s close failed: %s", self.name, replica_id, err)
        for road, n in supervisor.replay_mismatches_by_road.items():
            self._retired_mismatches[road] += n

    # -- close --------------------------------------------------------------

    async def close(self, timeout: float = 30.0) -> dict:
        """Drain and close every replica; returns ``{"served": n}`` (the
        workers' own counts).  Idempotent."""
        if self._closed:
            return {"served": self.served}
        self._closed = True
        for task in list(self._pump_tasks):
            task.cancel()
        self._fail_queued(f"replica set {self.name} closed")
        closes = await asyncio.gather(*(sup.close(timeout) for sup in self._replicas.values()),
                                      return_exceptions=True)
        served = sum(int(c.get("served") or 0) for c in closes if isinstance(c, dict))
        for state in _REPLICA_STATES:
            SERVE_REPLICAS.remove(set=self.name, state=state)
        obs_events.emit("serve.replica_set_closed", set=self.name, served=served)
        return {"served": served}


async def open_replica_set(targets: Any, factory: Any, *, replicas: int | None = None,
                           name: str = "", sticky_ttl_s: float | None = None,
                           router_queue_max: int | None = None,
                           tenant_weights: dict[str, float] | None = None,
                           **session_options: Any) -> ReplicaSet:
    """Open ``replicas`` sessions of one factory behind a routing front.

    ``targets`` is a list of ``GPUExecutor``\\ s (one also works); each
    replica is one session on one target's resident pool server, so two
    replicas need two executors (two pool servers, which may share a card).
    ``replicas`` defaults to ``len(targets)``; placement spreads first.
    ``session_options`` are ``open_session``'s knobs (``queue_max``,
    ``default_deadline_s``, ``stats_interval_s``, ``open_timeout_s``,
    ``retries``).
    """
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    replica_set = ReplicaSet(list(targets), factory, replicas=replicas, name=name,
                             sticky_ttl_s=sticky_ttl_s, router_queue_max=router_queue_max,
                             tenant_weights=tenant_weights, **session_options)
    return await replica_set._open()
