"""Admission-controlled work queue with per-tenant weighted fairness.

Own copy of ``covalent_tpu_plugin/fleet/queue.py``, whole.  The port's
replica-set router (``serving/replicas.py``) drives it; the fleet
scheduler that drives it in the reference comes with slice 5b (ROADMAP
Queue 1 item 6).  Two properties make the queue safe in front of sustained
multi-tenant traffic:

* **Admission control.**  Depth is bounded (``max_depth``); past the
  bound, the ``reject`` policy refuses new work and the ``shed_oldest``
  policy fails the oldest queued item instead — either way the refused
  item sees :class:`QueueFullError`, which ``resilience.classify_error``
  reads as PERMANENT (label ``admission_shed``): a full queue is a
  capacity decision, and retrying it would amplify the overload that
  caused it.
* **Weighted fairness.**  Dequeue order is deficit round-robin keyed on
  the item's tenant: each tenant earns ``quantum × weight`` service
  credit per round, so a tenant flooding the queue gets proportionally
  more throughput, never the light tenant's starvation (DRR's O(1)
  fairness — Shreedhar & Varghese, SIGCOMM '95).

The queue is event-loop-agnostic and synchronous; ``clock`` is injectable
so fairness and aging are testable on a fake clock.
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..obs.metrics import REGISTRY

QUEUE_DEPTH = REGISTRY.gauge(
    "covalent_tpu_queue_depth",
    "Electrons waiting in the fleet work queue",
    ("tenant",),
)

#: Tenant applied when neither the electron metadata nor the facade set one.
DEFAULT_TENANT = "default"


class QueueFullError(RuntimeError):
    """Admission refused: the fleet queue is at its depth bound.

    Deliberately NOT a ``TransportError``: shedding is a *capacity*
    verdict, and the resilience layer must classify it permanent (no gang
    retries, no local fallback re-run loops).  The ``fault_label`` /
    ``fault_transient`` attributes are the duck-typed classification hook
    ``resilience.classify_error`` honors without importing this module.
    """

    fault_label = "admission_shed"
    fault_transient = False


@dataclass
class WorkItem:
    """One queued electron: payload + tenant + the future its caller awaits."""

    fn: Callable
    args: tuple
    kwargs: dict
    task_metadata: dict
    tenant: str = DEFAULT_TENANT
    future: Any = None  # asyncio.Future set by the scheduler
    enqueued_at: float = 0.0
    seq: int = field(default_factory=itertools.count().__next__)

    @property
    def operation_id(self) -> str:
        dispatch_id = self.task_metadata.get("dispatch_id", "dispatch")
        node_id = self.task_metadata.get("node_id", 0)
        return f"{dispatch_id}_{node_id}"


class _TenantLane:
    __slots__ = ("items", "deficit")

    def __init__(self) -> None:
        self.items: collections.deque[WorkItem] = collections.deque()
        self.deficit = 0.0


class FairWorkQueue:
    """Bounded multi-tenant queue with deficit-round-robin dequeue.

    ``weights`` maps tenant -> relative service share (default 1.0; must
    be > 0).  ``max_depth`` bounds TOTAL queued items across tenants
    (0 = unbounded); ``policy`` decides what happens at the bound:
    ``"reject"`` raises :class:`QueueFullError` at :meth:`put`,
    ``"shed_oldest"`` fails the oldest queued item's future with one and
    admits the newcomer (freshness wins under overload).
    """

    def __init__(
        self,
        max_depth: int = 0,
        policy: str = "reject",
        weights: dict[str, float] | None = None,
        quantum: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
        depth_gauge: Any = None,
    ) -> None:
        if policy not in ("reject", "shed_oldest"):
            raise ValueError(
                f'policy must be "reject" or "shed_oldest", got {policy!r}'
            )
        #: which gauge this queue's per-tenant depth moves.  The fleet
        #: scheduler queue (the default) owns covalent_tpu_queue_depth;
        #: other DRR reusers (the serving replica router) MUST pass their
        #: own series — two queues writing one gauge would overwrite and
        #: even delete each other's tenant depths.
        self._depth_gauge = depth_gauge if depth_gauge is not None else (
            QUEUE_DEPTH
        )
        self.max_depth = max(0, int(max_depth))
        self.policy = policy
        if quantum <= 0:
            # A non-positive quantum earns no lane any credit: pop() would
            # rotate the active ring forever and hang the scheduler pump.
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self.quantum = float(quantum)
        self._clock = clock
        self._weights: dict[str, float] = {}
        for tenant, weight in (weights or {}).items():
            self.set_weight(tenant, weight)
        self._lanes: dict[str, _TenantLane] = {}
        #: round-robin order over tenants with backlog (rotated by pop).
        self._active: collections.deque[str] = collections.deque()
        self._depth = 0

    # -- configuration ------------------------------------------------------

    def set_weight(self, tenant: str, weight: float) -> None:
        weight = float(weight)
        if weight <= 0:
            raise ValueError(f"tenant {tenant!r} weight must be > 0, got {weight}")
        self._weights[tenant] = weight

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return self._depth

    @property
    def depth(self) -> int:
        return self._depth

    def backlog(self) -> dict[str, int]:
        """tenant -> queued item count (non-empty lanes only).

        Read from the ops HTTP thread while the pump mutates: ``list()``
        snapshots the dict in one C-level step (atomic under the GIL), so
        a concurrent insert can never raise mid-iteration here.
        """
        return {
            tenant: len(lane.items)
            for tenant, lane in list(self._lanes.items())
            if lane.items
        }

    def oldest_age(self) -> float:
        """Seconds the oldest queued item has waited (0 when empty).

        Same cross-thread read contract as :meth:`backlog`; a lane
        drained between the snapshot and the head read just skips.
        """
        oldest = None
        for lane in list(self._lanes.values()):
            try:
                head = lane.items[0].enqueued_at
            except IndexError:
                continue
            oldest = head if oldest is None else min(oldest, head)
        return 0.0 if oldest is None else max(0.0, self._clock() - oldest)

    def _drop_lane(self, tenant: str) -> None:
        """Retire a drained tenant lane AND its gauge series: tenant
        strings are user-derived and unbounded, so empty lanes must not
        accumulate for the process lifetime."""
        self._lanes.pop(tenant, None)
        self._depth_gauge.remove(tenant=tenant)
        try:
            self._active.remove(tenant)
        except ValueError:
            pass

    # -- admission ----------------------------------------------------------

    def put(self, item: WorkItem) -> list[WorkItem]:
        """Admit one item; returns the items shed to make room (if any).

        Under the ``reject`` policy a full queue raises
        :class:`QueueFullError` instead; the shed list lets the caller
        fail the victims' futures and count the decisions.
        """
        shed: list[WorkItem] = []
        if self.max_depth and self._depth >= self.max_depth:
            if self.policy == "reject":
                raise QueueFullError(
                    f"fleet queue at depth bound ({self._depth}/"
                    f"{self.max_depth}); electron {item.operation_id} "
                    f"(tenant {item.tenant!r}) rejected"
                )
            victim = self._shed_oldest()
            if victim is None:
                raise QueueFullError(
                    f"fleet queue at depth bound ({self._depth}/"
                    f"{self.max_depth}) with nothing sheddable"
                )
            shed.append(victim)
        if not item.enqueued_at:
            # First admission stamps the wait clock; a defensive requeue
            # (scheduler pop that could not place) keeps the original
            # stamp so queue_wait_s / oldest_age never under-report.
            item.enqueued_at = self._clock()
        lane = self._lanes.get(item.tenant)
        if lane is None:
            lane = self._lanes[item.tenant] = _TenantLane()
        if not lane.items:
            self._active.append(item.tenant)
        lane.items.append(item)
        self._depth += 1
        self._depth_gauge.labels(tenant=item.tenant).set(len(lane.items))
        return shed

    def _shed_oldest(self) -> WorkItem | None:
        """Remove and return the globally oldest queued item."""
        oldest_tenant: str | None = None
        oldest_seq = None
        for tenant, lane in self._lanes.items():
            if not lane.items:
                continue
            head = lane.items[0].seq
            if oldest_seq is None or head < oldest_seq:
                oldest_seq = head
                oldest_tenant = tenant
        if oldest_tenant is None:
            return None
        lane = self._lanes[oldest_tenant]
        victim = lane.items.popleft()
        self._depth -= 1
        self._depth_gauge.labels(tenant=oldest_tenant).set(len(lane.items))
        if not lane.items:
            self._drop_lane(oldest_tenant)
        return victim

    # -- dequeue (deficit round-robin) --------------------------------------

    def pop(self) -> WorkItem | None:
        """The next item under weighted fairness, or None when empty.

        Classic unit-cost DRR: the tenant at the head of the active ring
        spends a credit if it has one, otherwise earns
        ``quantum × weight`` and yields the head to the next tenant.  A
        heavy tenant therefore drains at most ``weight``-proportional
        rate — it cannot starve a light one, whose lane is visited every
        round regardless of the heavy lane's depth.
        """
        while self._active:
            tenant = self._active[0]
            lane = self._lanes.get(tenant)
            if lane is None or not lane.items:
                # Lane drained by a shed: drop it from the ring.
                self._active.popleft()
                continue
            if lane.deficit < 1.0:
                lane.deficit += self.quantum * self.weight(tenant)
                self._active.rotate(-1)
                continue
            lane.deficit -= 1.0
            item = lane.items.popleft()
            self._depth -= 1
            self._depth_gauge.labels(tenant=tenant).set(len(lane.items))
            if not lane.items:
                # An emptied lane retires whole (deficit included — DRR
                # never banks credit across idle periods) so tenant churn
                # cannot grow the lane map or the gauge without bound.
                self._active.popleft()
                self._drop_lane(tenant)
            return item
        return None

    def remove(self, predicate: Callable[[WorkItem], bool]) -> list[WorkItem]:
        """Remove (and return) every queued item matching ``predicate`` —
        the cancellation path for electrons that never got placed."""
        removed: list[WorkItem] = []
        for tenant, lane in list(self._lanes.items()):
            kept = collections.deque()
            for item in lane.items:
                if predicate(item):
                    removed.append(item)
                else:
                    kept.append(item)
            if len(kept) != len(lane.items):
                lane.items = kept
                self._depth_gauge.labels(tenant=tenant).set(len(kept))
                if not kept:
                    self._drop_lane(tenant)
        self._depth -= len(removed)
        return removed

    def drain(self) -> list[WorkItem]:
        """Remove and return everything queued (scheduler shutdown)."""
        return self.remove(lambda _item: True)
