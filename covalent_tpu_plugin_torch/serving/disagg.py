"""Disaggregated prefill/decode serving: a KV transfer plane over replicas.

Own copy of ``covalent_tpu_plugin/serving/disagg.py``.  Prefill is
compute-bound (one batched pass over the prompt), decode memory- and, on
this port, host-bound (one small step per token); a replica doing both
lets a long prompt's admission hold up every stream sharing its loop.  A
:class:`DisaggregatedSet` splits the phases across the replica set it is:

* **Prefill tier.**  The first ``prefill_replicas`` members never receive
  routed requests.  A long prompt runs ``engine.prefill_only`` there: the
  admission prefill's exact computation, packaged as a KV bundle (the
  prefilled cache lane, the first token and the sampling fingerprint; the
  port's own format, ``models.serve.KV_BUNDLE_VERSION``).
* **KV transfer, content-addressed.**  The worker announces the bundle's
  sha256, the dispatcher hashes the bytes it received before trusting
  them, and the decode worker checks again before unpickling.  The bundle
  rides a raw frame body when the decode replica's channel negotiated
  frames, and a CAS path otherwise (``SessionSupervisor._send_request``).
  Every verified bundle is also mirrored into the dispatcher's CAS
  directory, pruned to the executor's ``cas_max_bytes`` when it has one.
* **Decode tier.**  The router (sticky, then prefix affinity, then
  least-loaded, in per-tenant DRR order) places the request on a decode
  replica, whose engine scatters the lane into a slot (``admit_from_kv``)
  and goes straight to decoding.
* **Degrade, never error.**  A dead or slow prefill tier, a digest
  mismatch, a torn transfer or an engine refusing the bundle all fall back
  to a full prefill on the decode replica; the stream is the same, only
  later.  Prompts shorter than ``min_prompt_tokens`` skip the KV road.

``COVALENT_TPU_SERVE_DISAGG=0`` routes everything direct;
``COVALENT_TPU_SERVE_DISAGG_MIN_PROMPT`` (64), ``_KV_TIMEOUT_S`` (30) and
``_PREFILL`` (1) set the threshold, the prefill round trip's budget and the
prefill tier's width.  The first replica opened is the prefill tier's, on
the first target; placement by a pool's declared role comes with fleet
``Pool`` targets (ROADMAP item 2c.7).
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import os
import time
import uuid
from typing import Any

from ..cache import prune_cas_dir
from ..obs import events as obs_events
from ..utils.log import app_log
from .metrics import (
    SERVE_DISAGG_REQUESTS_TOTAL,
    SERVE_KV_TRANSFER_BYTES_TOTAL,
    SERVE_KV_TRANSFER_SECONDS,
    SERVE_KV_TRANSFERS_TOTAL,
)
from .replicas import ReplicaSet
from .supervisor import ServeError, ServeRequest, SessionSupervisor, _env_number

__all__ = ["DisaggregatedSet", "open_disaggregated_set"]


def _disagg_enabled() -> bool:
    return os.environ.get("COVALENT_TPU_SERVE_DISAGG", "").strip().lower() not in (
        "0", "off", "false", "no")


def _prefix_key(prompt: list) -> str:
    """Router affinity key: the digest of the prompt's reusable prefix (all
    but the last token, the prefix a repeated prompt hits in the tree)."""
    if len(prompt) < 2:
        return ""
    return hashlib.sha256(",".join(str(int(t)) for t in prompt[:-1]).encode()).hexdigest()


class DisaggregatedSet(ReplicaSet):
    """A :class:`~.replicas.ReplicaSet` split into a prefill and a decode
    tier, joined by content-addressed KV bundles.

    Build it through :func:`open_disaggregated_set`.  The request surface
    is the replica set's; the classification, the prefill round trip, the
    digest check and the degrade run in :meth:`_prepare_request`, before
    the router sees the request.
    """

    def __init__(self, targets: list[Any], factory: Any, *,
                 decode_replicas: int | None = None, prefill_replicas: int | None = None,
                 min_prompt_tokens: int | None = None, kv_timeout_s: float | None = None,
                 **set_options: Any) -> None:
        self.prefill_replicas = int(
            prefill_replicas if prefill_replicas is not None
            else _env_number("COVALENT_TPU_SERVE_DISAGG_PREFILL", 1, int))
        if self.prefill_replicas < 1:
            raise ValueError(f"prefill_replicas must be >= 1, got {self.prefill_replicas}")
        decode = int(decode_replicas if decode_replicas is not None
                     else max(1, len(targets) - self.prefill_replicas))
        if decode < 1:
            raise ValueError(f"decode_replicas must be >= 1, got {decode}")
        self.decode_replicas = decode
        self.min_prompt_tokens = int(
            min_prompt_tokens if min_prompt_tokens is not None
            else _env_number("COVALENT_TPU_SERVE_DISAGG_MIN_PROMPT", 64, int))
        self.kv_timeout_s = float(
            kv_timeout_s if kv_timeout_s is not None
            else _env_number("COVALENT_TPU_SERVE_DISAGG_KV_TIMEOUT_S", 30.0))
        self.enabled = _disagg_enabled()
        #: replica id -> "prefill" | "decode"
        self._role_of: dict[str, str] = {}
        #: prefill-role opens in flight: the role goes by the tier's
        #: deficit, so a failed open does not lose the prefill tier for good
        self._prefill_opening = 0
        #: prefill work in flight per prefill replica id
        self._prefill_load: collections.Counter = collections.Counter()
        #: transfer accounting (the metrics' raw feed)
        self.kv_bytes_total = 0
        self.kv_transfers = 0
        self.kv_bundle_bytes: collections.deque = collections.deque(maxlen=4096)
        self.kv_transfer_s: collections.deque = collections.deque(maxlen=4096)
        self.requests_by_path: collections.Counter = collections.Counter()
        super().__init__(targets, factory, replicas=decode + self.prefill_replicas,
                         **set_options)

    # -- roles ---------------------------------------------------------------

    async def _open_replica(self) -> SessionSupervisor:
        """Open a replica in the tier short of its width: the prefill tier
        first, so the first target (after spreading) hosts it."""
        have = self._prefill_opening + sum(
            1 for rid, sup in self._replicas.items()
            if self._role_of.get(rid) == "prefill" and sup.alive)
        role = "prefill" if have < self.prefill_replicas else "decode"
        if role == "prefill":
            self._prefill_opening += 1
        try:
            supervisor = await super()._open_replica()
        finally:
            if role == "prefill":
                self._prefill_opening -= 1
        if supervisor.replica_of is not None:
            self._role_of[supervisor.replica_of[1]] = role
        return supervisor

    def _views(self):
        """The router sees the decode tier only."""
        return {rid: view for rid, view in super()._views().items()
                if self._role_of.get(rid, "decode") == "decode"}

    def _decode_alive(self) -> bool:
        return any(sup.alive for rid, sup in self._replicas.items()
                   if self._role_of.get(rid, "decode") == "decode")

    # -- classification + prefill tier -------------------------------------

    async def request(self, prompt, params: dict | None = None,
                      deadline_s: float | None = None, tenant: str = "",
                      sticky: str = "") -> ServeRequest:
        if not self._closed and not self._decode_alive():
            raise ServeError(f"disaggregated set {self.name} has no live decode replicas")
        return await super().request(prompt, params, deadline_s=deadline_s, tenant=tenant,
                                     sticky=sticky)

    async def _prepare_request(self, request: ServeRequest) -> None:
        """Classify, prefill on the prefill tier, attach the KV bundle.
        Every failure ends the same way: ``request.kv`` stays None and the
        decode replica runs the full prefill."""
        request.prefix_key = _prefix_key(request.prompt)
        if not self.enabled or len(request.prompt) < self.min_prompt_tokens:
            self.requests_by_path["direct"] += 1
            SERVE_DISAGG_REQUESTS_TOTAL.labels(path="direct").inc()
            return
        kv = await self._prefill_kv_for(request)
        path = "disagg" if kv is not None else "fallback"
        self.requests_by_path[path] += 1
        SERVE_DISAGG_REQUESTS_TOTAL.labels(path=path).inc()
        request.kv = kv

    def _prefill_supervisor(self) -> tuple[str, SessionSupervisor] | None:
        candidates = [(rid, sup) for rid, sup in self._replicas.items()
                      if self._role_of.get(rid) == "prefill" and sup.routable]
        if not candidates:
            return None
        return min(candidates, key=lambda entry: self._prefill_load[entry[0]])

    async def _prefill_kv_for(self, request: ServeRequest) -> tuple[bytes, str] | None:
        """One prefill-tier round trip: ``(bundle, digest)``, or None after
        any failure (counted, logged, degraded)."""
        picked = self._prefill_supervisor()
        if picked is None:
            SERVE_KV_TRANSFERS_TOTAL.labels(outcome="fallback").inc()
            return None
        replica_id, supervisor = picked
        self._prefill_load[replica_id] += 1
        t0 = time.perf_counter()
        try:
            # The bound covers the whole round trip: a prefill replica
            # caught mid-reconnect waits in _await_ready, and the request
            # must degrade on the KV budget instead.
            event = await asyncio.wait_for(
                supervisor.prefill_kv(request.prompt, request.params,
                                      rid=f"{request.rid}-kv{uuid.uuid4().hex[:6]}",
                                      timeout_s=self.kv_timeout_s),
                self.kv_timeout_s + 5.0)
        except Exception as err:  # noqa: BLE001 - degrade, never error
            SERVE_KV_TRANSFERS_TOTAL.labels(outcome="error").inc()
            obs_events.emit("serve.kv_prefill_failed", set=self.name, replica=replica_id,
                            rid=request.rid, error=repr(err))
            app_log.debug("disagg %s: prefill for %s failed on %s (%s); degrading to a full "
                          "prefill", self.name, request.rid, replica_id, err)
            return None
        finally:
            self._prefill_load[replica_id] -= 1
        data = event.get("data_bytes")
        if not isinstance(data, (bytes, bytearray)) or not data:
            SERVE_KV_TRANSFERS_TOTAL.labels(outcome="error").inc()
            return None
        data = bytes(data)
        digest = hashlib.sha256(data).hexdigest()
        announced = str(event.get("digest") or "")
        if announced and digest != announced:
            # torn on the way: the decode replica prefills from the prompt
            SERVE_KV_TRANSFERS_TOTAL.labels(outcome="digest_mismatch").inc()
            obs_events.emit("serve.kv_digest_mismatch", set=self.name, replica=replica_id,
                            rid=request.rid, announced=announced[:12], received=digest[:12])
            return None
        elapsed = time.perf_counter() - t0
        SERVE_KV_TRANSFERS_TOTAL.labels(outcome="ok").inc()
        SERVE_KV_TRANSFER_BYTES_TOTAL.inc(len(data))
        SERVE_KV_TRANSFER_SECONDS.observe(elapsed)
        self.kv_transfers += 1
        self.kv_bytes_total += len(data)
        self.kv_bundle_bytes.append(len(data))
        self.kv_transfer_s.append(elapsed)
        # off the request's path: the frames road never reads the mirror back
        mirror = asyncio.ensure_future(asyncio.to_thread(
            self._mirror_to_cas, supervisor, data, digest))
        mirror.add_done_callback(lambda t: None if t.cancelled() else t.exception())
        return data, digest

    @staticmethod
    def _mirror_to_cas(supervisor: SessionSupervisor, data: bytes, digest: str) -> None:
        """A content-addressed copy of every verified bundle in the
        dispatcher's CAS directory (what the CAS road ships from), pruned
        to the executor's ``cas_max_bytes`` when it sets one."""
        try:
            root = os.path.join(supervisor.executor.cache_dir, "cas")
            os.makedirs(root, exist_ok=True)
            path = os.path.join(root, f"{digest}.kv")
            if not os.path.exists(path):
                tmp = f"{path}.tmp.{os.getpid()}.{os.urandom(4).hex()}"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            budget = int(getattr(supervisor.executor, "cas_max_bytes", 0) or 0)
            if budget > 0:
                prune_cas_dir(root, budget)
        except OSError as err:
            app_log.debug("KV CAS mirror write failed: %s", err)

    # -- health / scaling (decode-tier aware) -------------------------------

    def _on_replica_failed(self, supervisor: SessionSupervisor,
                           failure: BaseException) -> bool:
        handled = super()._on_replica_failed(supervisor, failure)
        if not self._decode_alive():
            # the base set drains only when every replica is gone; a live
            # prefill tier cannot place the queued requests either
            self._fail_queued(f"disaggregated set {self.name} has no live decode replicas: "
                              f"{failure}")
        return handled

    async def scale_to(self, replicas: int) -> int:
        """Scale the DECODE tier to ``replicas`` (the prefill tier keeps its
        width); returns the live decode count."""
        if self._closed:
            raise ServeError(f"replica set {self.name} is closed")
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        live = {rid: sup for rid, sup in self._replicas.items()
                if sup.alive and self._role_of.get(rid, "decode") == "decode"}
        if replicas > len(live):
            results = await asyncio.gather(
                *(self._open_replica() for _ in range(replicas - len(live))),
                return_exceptions=True)
            for failure in results:
                if isinstance(failure, BaseException):
                    app_log.warning("disagg set %s scale-up open failed: %r", self.name,
                                    failure)
            self._schedule_pump()
        elif replicas < len(live):
            for rid in sorted(live, key=lambda r: live[r].in_flight)[:len(live) - replicas]:
                await self._retire_replica(rid)
        self.replicas_wanted = self.prefill_replicas + replicas
        self._publish_replica_states()
        decode_live = len([rid for rid, sup in self._replicas.items()
                           if sup.alive and self._role_of.get(rid, "decode") == "decode"])
        obs_events.emit("serve.replica_set_scaled", set=self.name, replicas=decode_live)
        return decode_live

    # -- views --------------------------------------------------------------

    def status(self) -> dict[str, Any]:
        view = super().status()
        transfers = sorted(self.kv_transfer_s)
        view.update(
            roles=dict(self._role_of), min_prompt_tokens=self.min_prompt_tokens,
            disagg_enabled=self.enabled, requests_by_path=dict(self.requests_by_path),
            kv_transfers=self.kv_transfers, kv_bytes_total=self.kv_bytes_total,
            kv_transfer_p50_ms=round(
                (transfers[len(transfers) // 2] if transfers else 0.0) * 1e3, 4),
        )
        return view


async def open_disaggregated_set(targets: Any, factory: Any, *,
                                 decode_replicas: int | None = None,
                                 prefill_replicas: int | None = None,
                                 min_prompt_tokens: int | None = None,
                                 kv_timeout_s: float | None = None, name: str = "",
                                 sticky_ttl_s: float | None = None,
                                 router_queue_max: int | None = None,
                                 tenant_weights: dict[str, float] | None = None,
                                 **session_options: Any) -> DisaggregatedSet:
    """Open a prefill tier and a decode tier of one engine factory behind
    the replica-set router, joined by content-addressed KV bundles.

    ``targets`` is ``open_replica_set``'s list of ``GPUExecutor``\\ s;
    ``decode_replicas`` defaults to ``len(targets) - prefill_replicas``;
    prompts shorter than ``min_prompt_tokens`` skip the prefill tier.  The
    engine must offer ``prefill_only`` and ``admit_from_kv``
    (``models.serve.ContinuousEngine`` does).
    """
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    disagg = DisaggregatedSet(
        list(targets), factory, decode_replicas=decode_replicas,
        prefill_replicas=prefill_replicas, min_prompt_tokens=min_prompt_tokens,
        kv_timeout_s=kv_timeout_s, name=name, sticky_ttl_s=sticky_ttl_s,
        router_queue_max=router_queue_max, tenant_weights=tenant_weights,
        **session_options,
    )
    await disagg._open()
    return disagg
