"""Continuous health scoring: the fleet's gray-failure sense organ.

Own copy of ``covalent_tpu_plugin/fleet/health.py``, whole.  In the port
the replica sets feed it (each replica's TTFT, faults, successes and queue
depth) and read it back to route and to hedge.

Crash-stop failures are easy — a dead channel raises, the breaker opens,
the scheduler routes around it.  Production accelerator fleets fail *gray*: a
degraded chip, a lossy NIC, a throttled disk.  The worker still answers,
still heartbeats, still completes ops — just 10x slower — and a binary
breaker never fires while one browned-out replica drags the whole set's
p99.  This module gives every worker/replica a *continuous* health score
in ``[0, 1]`` fed passively from signals the repo already emits:

* **differential latency** — EWMA op latency vs the peer-group median
  (a straggler is slow *relative to its gang*, not in absolute terms);
* **heartbeat jitter** — inter-arrival coefficient of variation (a
  wedging worker beats erratically before it stops beating);
* **fault attribution** — transient faults from
  ``resilience.classify_error`` decay the score, successes heal it;
* **queue drain** — serving queue depth that grows while peers drain.

Scores drive a four-state machine generalizing the binary breaker
(which stays as the crash-stop fast path)::

    HEALTHY ──score<degraded──▶ PROBATION ──sustained──▶ DEGRADED
       ▲                            │                        │
       │ score recovers             │ score<quarantine       │ score<quarantine
       │                            ▼                        ▼
    PROBATION ◀──canary ok── PROBING ◀──cooldown──── QUARANTINED
                                  │
                                  └──canary fail──▶ QUARANTINED (longer)

``DEGRADED`` targets are deprioritized (placed/routed last);
``QUARANTINED`` ones receive no traffic at all and are readmitted only
through a single-flight cheap canary probe (:meth:`HealthMonitor.allow_probe`
/ :meth:`HealthMonitor.record_probe`).  Crash recovery deliberately does
NOT persist scores: re-adopted sessions and re-dialed workers restart
:meth:`neutral` so a rebooted fleet never inherits a stale quarantine.

Knobs (env, all optional)::

    COVALENT_TPU_HEALTH=off            disable scoring entirely
    COVALENT_TPU_HEALTH_DEGRADED=0.6   score below which -> degraded
    COVALENT_TPU_HEALTH_QUARANTINE=0.3 score below which -> quarantined
    COVALENT_TPU_HEALTH_RECOVER=0.75   score above which -> healthy
    COVALENT_TPU_HEALTH_MIN_SAMPLES=5  latency samples before judging
    COVALENT_TPU_HEALTH_COOLDOWN_S=5   quarantine dwell before probing
    COVALENT_TPU_HEALTH_ALPHA=0.3      EWMA smoothing factor
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable

from ..obs import events as obs_events
from ..obs.metrics import REGISTRY
from ..utils.log import app_log

__all__ = [
    "HEALTH",
    "HealthMonitor",
    "HEALTHY",
    "PROBATION",
    "DEGRADED",
    "QUARANTINED",
    "PROBING",
]

# -- states (ordered by severity; the gauge encodes the index) --------------

HEALTHY = "healthy"
PROBATION = "probation"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
PROBING = "probing"

_STATES = (HEALTHY, PROBATION, DEGRADED, QUARANTINED, PROBING)

HEALTH_SCORE = REGISTRY.gauge(
    "covalent_tpu_health_score",
    "Continuous health score per fleet target (1.0 = perfectly healthy)",
    ("target",),
)
HEALTH_STATE = REGISTRY.gauge(
    "covalent_tpu_health_state",
    "Health state per target (0=healthy 1=probation 2=degraded "
    "3=quarantined 4=probing)",
    ("target",),
)
HEALTH_TRANSITIONS_TOTAL = REGISTRY.counter(
    "covalent_tpu_health_transitions_total",
    "Health state-machine transitions, by destination state",
    ("to",),
)
STRAGGLERS_TOTAL = REGISTRY.counter(
    "covalent_tpu_stragglers_total",
    "Gang members flagged as differential stragglers",
    ("worker",),
)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


class _Record:
    """Mutable per-target signal accumulators (guarded by monitor lock)."""

    __slots__ = (
        "group", "lat_ewma", "lat_samples", "hb_last", "hb_mean", "hb_var",
        "hb_samples", "fault_score", "queue_ewma", "queue_trend", "state",
        "state_since", "quarantined_at", "quarantine_round", "probe_open",
        "last_transition_reason",
    )

    def __init__(self, group: str = "") -> None:
        self.group = group
        self.lat_ewma = 0.0
        self.lat_samples = 0
        self.hb_last = 0.0
        self.hb_mean = 0.0       # EWMA of inter-arrival gaps
        self.hb_var = 0.0        # EWMA of squared deviation
        self.hb_samples = 0
        self.fault_score = 1.0   # 1.0 = no recent faults, decays toward 0
        self.queue_ewma = 0.0
        self.queue_trend = 0.0   # positive = depth growing
        self.state = HEALTHY
        self.state_since = 0.0
        self.quarantined_at = 0.0
        self.quarantine_round = 0
        self.probe_open = False
        self.last_transition_reason = ""


class HealthMonitor:
    """Process-wide continuous health scoring over opaque target keys.

    Targets are strings — a replica session id, a worker address, a pool
    name — the monitor does not care.  ``group`` ties peers together for
    differential (vs-median) scoring; targets without a group are scored
    on absolute signals only.  Thread-safe; ``clock`` is injectable for
    deterministic unit tests.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._records: dict[str, _Record] = {}
        self.alpha = _env_float("COVALENT_TPU_HEALTH_ALPHA", 0.3)
        self.degraded_below = _env_float("COVALENT_TPU_HEALTH_DEGRADED", 0.6)
        self.quarantine_below = _env_float(
            "COVALENT_TPU_HEALTH_QUARANTINE", 0.3
        )
        self.recover_above = _env_float("COVALENT_TPU_HEALTH_RECOVER", 0.75)
        self.min_samples = int(
            _env_float("COVALENT_TPU_HEALTH_MIN_SAMPLES", 5)
        )
        self.cooldown_s = _env_float("COVALENT_TPU_HEALTH_COOLDOWN_S", 5.0)

    @property
    def enabled(self) -> bool:
        return os.environ.get("COVALENT_TPU_HEALTH", "").lower() not in (
            "off", "0", "false", "disabled",
        )

    # -- signal feeds ------------------------------------------------------

    def _rec(self, key: str, group: str = "") -> _Record:
        rec = self._records.get(key)
        if rec is None:
            rec = _Record(group)
            rec.state_since = self._clock()
            self._records[key] = rec
        if group and not rec.group:
            rec.group = group
        return rec

    def record_latency(self, key: str, seconds: float, group: str = "") -> None:
        """One completed-op latency sample (TTFT, rpc round trip, ...)."""
        if seconds < 0:
            return
        with self._lock:
            rec = self._rec(key, group)
            if rec.lat_samples == 0:
                rec.lat_ewma = seconds
            else:
                rec.lat_ewma += self.alpha * (seconds - rec.lat_ewma)
            rec.lat_samples += 1
        self._judge(key)

    def record_heartbeat(self, key: str, group: str = "") -> None:
        """A fresh heartbeat arrived; tracks inter-arrival jitter."""
        now = self._clock()
        with self._lock:
            rec = self._rec(key, group)
            if rec.hb_last > 0:
                gap = now - rec.hb_last
                if rec.hb_samples == 0:
                    rec.hb_mean = gap
                else:
                    dev = gap - rec.hb_mean
                    rec.hb_mean += self.alpha * dev
                    rec.hb_var += self.alpha * (dev * dev - rec.hb_var)
                rec.hb_samples += 1
            rec.hb_last = now

    def record_fault(self, key: str, label: str = "", group: str = "") -> None:
        """A fault attributed to this target (classify_error transients)."""
        with self._lock:
            rec = self._rec(key, group)
            rec.fault_score = max(0.0, rec.fault_score - 0.34)
        self._judge(key, reason=f"fault:{label}" if label else "fault")

    def record_success(self, key: str, group: str = "") -> None:
        """A clean completion; heals fault decay."""
        with self._lock:
            rec = self._rec(key, group)
            rec.fault_score = min(1.0, rec.fault_score + 0.1)
        self._judge(key)

    def record_queue_depth(self, key: str, depth: float, group: str = "") -> None:
        """Serving queue depth sample; a growing queue while peers drain
        is the drain-rate brownout signal."""
        with self._lock:
            rec = self._rec(key, group)
            prev = rec.queue_ewma
            rec.queue_ewma += self.alpha * (depth - rec.queue_ewma)
            rec.queue_trend += self.alpha * (
                (rec.queue_ewma - prev) - rec.queue_trend
            )
        self._judge(key)

    # -- scoring -----------------------------------------------------------

    def _group_median_latency(self, group: str, exclude: str) -> float:
        """Median peer EWMA latency (lock held by caller)."""
        peers = sorted(
            rec.lat_ewma
            for key, rec in self._records.items()
            if rec.group == group and key != exclude and rec.lat_samples > 0
        )
        if not peers:
            return 0.0
        mid = len(peers) // 2
        if len(peers) % 2:
            return peers[mid]
        return 0.5 * (peers[mid - 1] + peers[mid])

    def _score_locked(self, key: str) -> float:
        rec = self._records.get(key)
        if rec is None:
            return 1.0
        # Differential latency: ratio of this target's EWMA to its peer
        # median.  1x -> 1.0, 2x -> ~0.5, 4x -> ~0.25.  Absolute latency
        # is meaningless across heterogeneous pools; *relative* is the
        # straggler signal.
        lat_score = 1.0
        if rec.lat_samples >= self.min_samples:
            median = (
                self._group_median_latency(rec.group, key)
                if rec.group else 0.0
            )
            if median > 0 and rec.lat_ewma > median:
                lat_score = min(1.0, median / rec.lat_ewma)
        # Heartbeat jitter: coefficient of variation of inter-arrival
        # gaps.  A steady beat (cv ~ 0) scores 1.0; cv >= 1 (gaps as
        # erratic as their mean) scores 0.
        jitter_score = 1.0
        if rec.hb_samples >= self.min_samples and rec.hb_mean > 0:
            cv = (max(0.0, rec.hb_var) ** 0.5) / rec.hb_mean
            jitter_score = max(0.0, 1.0 - min(1.0, cv))
        # Queue drain: depth growing against the trend line reads as a
        # brownout even before latency moves.
        queue_score = 1.0
        if rec.queue_trend > 0.5:
            queue_score = max(0.0, 1.0 - min(1.0, rec.queue_trend / 4.0))
        return (
            0.45 * lat_score
            + 0.15 * jitter_score
            + 0.30 * rec.fault_score
            + 0.10 * queue_score
        )

    def score(self, key: str) -> float:
        with self._lock:
            return round(self._score_locked(key), 4)

    def state(self, key: str) -> str:
        with self._lock:
            rec = self._records.get(key)
            return rec.state if rec is not None else HEALTHY

    def rank(self, key: str) -> int:
        """Placement rank term: 0 healthy, 1 probation, 2 degraded/probing,
        3 quarantined — lower sorts earlier.  PROBING stays down at the
        degraded tier: a canary in flight is not a verdict, and full
        traffic must not land on a still-suspect target during the probe
        window (readmission to PROBATION is what restores priority)."""
        st = self.state(key)
        if st == HEALTHY:
            return 0
        if st == PROBATION:
            return 1
        if st in (DEGRADED, PROBING):
            return 2
        return 3

    def quarantined(self, key: str) -> bool:
        return self.state(key) == QUARANTINED

    def degraded(self, key: str) -> bool:
        return self.state(key) in (DEGRADED, PROBING, QUARANTINED)

    # -- state machine -----------------------------------------------------

    def _transition(self, key: str, rec: _Record, to: str, reason: str) -> None:
        """Lock held by caller; publishes outside is fine (metrics are
        themselves locked)."""
        if rec.state == to:
            return
        frm = rec.state
        rec.state = to
        rec.state_since = self._clock()
        rec.last_transition_reason = reason
        if to == QUARANTINED:
            rec.quarantined_at = self._clock()
            rec.quarantine_round += 1
            rec.probe_open = False
        HEALTH_TRANSITIONS_TOTAL.labels(to=to).inc()
        HEALTH_STATE.labels(target=key).set(_STATES.index(to))
        obs_events.emit(
            "health.transition", target=key, to=to,
            frm=frm, reason=reason, score=round(self._score_locked(key), 4),
        )
        app_log.info(
            "health: %s %s -> %s (%s)", key, frm, to, reason
        )

    def _judge(self, key: str, reason: str = "") -> None:
        """Re-evaluate the state machine after a signal lands."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            score = self._score_locked(key)
            HEALTH_SCORE.labels(target=key).set(round(score, 4))
            st = rec.state
            if st in (QUARANTINED, PROBING):
                # Readmission only through the canary probe path.
                return
            why = reason or f"score={score:.3f}"
            if score < self.quarantine_below:
                self._transition(key, rec, QUARANTINED, why)
            elif score < self.degraded_below:
                if st == HEALTHY:
                    self._transition(key, rec, PROBATION, why)
                elif st == PROBATION:
                    # Sustained low score graduates probation to degraded.
                    if self._clock() - rec.state_since >= self.cooldown_s / 2:
                        self._transition(key, rec, DEGRADED, why)
            elif score >= self.recover_above and st in (PROBATION, DEGRADED):
                self._transition(key, rec, HEALTHY, why)

    # -- canary readmission ------------------------------------------------

    def allow_probe(self, key: str) -> bool:
        """True exactly once per cooldown window for a quarantined target:
        the caller should run a cheap canary op and report via
        :meth:`record_probe`.  Single-flight: a second caller in the same
        window gets False."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None or rec.state != QUARANTINED or rec.probe_open:
                return False
            # Exponential back-off on repeated quarantine rounds.
            dwell = self.cooldown_s * min(8, 2 ** max(0, rec.quarantine_round - 1))
            if self._clock() - rec.quarantined_at < dwell:
                return False
            rec.probe_open = True
            self._transition(key, rec, PROBING, "cooldown elapsed")
            return True

    def record_probe(self, key: str, ok: bool) -> None:
        """Canary verdict: ok readmits to probation (NOT straight to
        healthy — it must re-earn its score), failure re-quarantines with
        a longer cooldown."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.probe_open = False
            if ok:
                # Reset the signals that put it there; it starts clean but
                # watched.
                rec.fault_score = 1.0
                rec.lat_ewma = 0.0
                rec.lat_samples = 0
                rec.queue_ewma = 0.0
                rec.queue_trend = 0.0
                self._transition(key, rec, PROBATION, "canary ok")
            else:
                self._transition(key, rec, QUARANTINED, "canary failed")

    def release_probe(self, key: str) -> None:
        """Release a probe slot WITHOUT a verdict — the canary never ran
        (e.g. no event loop on a sync status path).  The target returns
        to QUARANTINED with its prior dwell clock and quarantine round
        intact: an un-run probe must neither readmit the target nor
        lengthen its back-off the way a genuinely failed canary would."""
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.probe_open = False
            if rec.state != PROBING:
                return
            # _transition to QUARANTINED stamps a fresh quarantined_at and
            # bumps the round; restore both — no probe ran, nothing was
            # learned.
            at, rnd = rec.quarantined_at, rec.quarantine_round
            self._transition(key, rec, QUARANTINED, "probe released unrun")
            rec.quarantined_at = at
            rec.quarantine_round = rnd

    # -- lifecycle ---------------------------------------------------------

    def neutral(self, key: str, group: str = "") -> None:
        """Reset a target to a neutral (healthy, zero-signal) record —
        crash recovery calls this for re-adopted sessions and re-dialed
        workers so a restarted control plane never inherits a stale
        quarantine (the journal deliberately does not persist scores)."""
        with self._lock:
            old = self._records.get(key)
            rec = _Record(group or (old.group if old else ""))
            rec.state_since = self._clock()
            self._records[key] = rec
        HEALTH_SCORE.labels(target=key).set(1.0)
        HEALTH_STATE.labels(target=key).set(0)

    def drop(self, key: str) -> None:
        """Forget a target and reap its metric series (replica closed,
        worker released) — stale series must not haunt /metrics."""
        with self._lock:
            self._records.pop(key, None)
        try:
            HEALTH_SCORE.remove(target=key)
            HEALTH_STATE.remove(target=key)
        except Exception:  # noqa: BLE001 - series may never have published
            pass

    def flag_straggler(self, worker: str, differential: float, **detail: Any) -> None:
        """A gang member ran slower than its peers by more than the
        budget: event + metric + a fault mark on its health record."""
        STRAGGLERS_TOTAL.labels(worker=worker).inc()
        obs_events.emit(
            "fleet.straggler", worker=worker,
            differential=round(differential, 3), **detail,
        )
        self.record_fault(worker, label="straggler")

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """target -> {score, state, ...} for /status and tests."""
        with self._lock:
            return {
                key: {
                    "score": round(self._score_locked(key), 4),
                    "state": rec.state,
                    "group": rec.group,
                    "lat_ewma_s": round(rec.lat_ewma, 6),
                    "lat_samples": rec.lat_samples,
                    "hb_jitter_cv": round(
                        (max(0.0, rec.hb_var) ** 0.5) / rec.hb_mean, 4
                    ) if rec.hb_mean > 0 else 0.0,
                    "fault_score": round(rec.fault_score, 4),
                    "queue_ewma": round(rec.queue_ewma, 3),
                    "reason": rec.last_transition_reason,
                }
                for key, rec in self._records.items()
            }

    def reset(self) -> None:
        """Drop every record (tests)."""
        with self._lock:
            keys = list(self._records)
            self._records.clear()
        for key in keys:
            try:
                HEALTH_SCORE.remove(target=key)
                HEALTH_STATE.remove(target=key)
            except Exception:  # noqa: BLE001
                pass


#: Process-wide monitor every fleet/serving signal feeds.
HEALTH = HealthMonitor()
