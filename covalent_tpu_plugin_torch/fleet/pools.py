"""Named executor pools: a worker gang, its capacity, its slot accounting.

Own copy of ``covalent_tpu_plugin/fleet/pools.py``.  A :class:`Pool` wraps
ONE executor (its pooled channels and resident runtime are the warm gang)
and a capacity: how much long-lived load may sit on that gang at once.  A
serving session opened on a pool (:meth:`Pool.open_session`, or
``serving.open_session(pool, ...)``) pins one slot for its life, and a
handoff may move it to another pool, which is how a session leaves a node
that is about to go away.

Pools come from :class:`PoolSpec`\\ s, built in code, from config
(``fleet.pools``) or from the environment (``COVALENT_TPU_POOLS``): the
compact form, ``;``-separated ``name=addr1+addr2@capN`` entries, or a JSON
list (or one object) of spec fields.  All land in one :class:`PoolRegistry`,
which can also provide a local fallback pool.  The reference's
discovery-backed pools (the compact ``tpu:NAME`` target and
``PoolRegistry.register_tpu``) look TPU VMs up through ``gcloud``
(``discovery.py``), which has no GPU counterpart and is not queued: they
are refused.  The fleet scheduler, leases and autoscaling that drive pools
in the reference come with slice 5b (ROADMAP Queue 1 item 6), so the
placement probes they read (health rank, breaker views, prewarm,
teardown) and the resize hook (``Pool.capacity``'s setter) are not ported
either.
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Callable

from ..obs.metrics import REGISTRY
from ..utils.config import get_config
from ..utils.log import app_log
from . import journal

POOL_SLOTS = REGISTRY.gauge(
    "covalent_tpu_pool_slots",
    "Fleet pool slot occupancy by state",
    ("pool", "state"),
)

POOLS_ENV = "COVALENT_TPU_POOLS"

#: capacity of a spec (or compact entry) that names none
DEFAULT_CAPACITY = 1
#: capacity of the auto-provided local fallback pool
FALLBACK_CAPACITY = 2

#: why TPU-VM discovery is refused
DISCOVERY = ("TPU-VM discovery (discovery.py: a gcloud lookup with no GPU counterpart) "
             "is not ported and not queued; name the pool's workers instead")


@dataclass
class PoolSpec:
    """Declarative description of one executor pool (the reference's fields,
    so a spec string parses to the same spec in both packages).

    ``workers`` and ``transport`` describe the gang; ``capacity`` is the
    number of long-lived loads the gang takes at once; ``fallback`` marks
    the pool of last resort; ``role`` (``"prefill"``/``"decode"``) steers a
    disaggregated set's tiers; ``preemptible`` marks spot capacity.
    ``executor`` carries extra ``GPUExecutor`` keyword arguments verbatim.
    ``tpu_name``, ``zone``, ``project`` and ``endpoints`` are the
    reference's discovery fields: a spec that names a TPU is refused when
    its executor is built.
    """

    name: str
    workers: tuple[str, ...] = ()
    tpu_name: str = ""
    zone: str = ""
    project: str = ""
    transport: str = ""
    capacity: int = DEFAULT_CAPACITY
    fallback: bool = False
    role: str = ""
    preemptible: bool = False
    executor: dict[str, Any] = field(default_factory=dict)
    endpoints: tuple[tuple[str, str], ...] = ()

    def __post_init__(self) -> None:
        self.workers = tuple(self.workers)
        self.endpoints = tuple((str(external), str(internal))
                               for external, internal in self.endpoints)
        self.capacity = max(1, int(self.capacity))
        if not self.name:
            raise ValueError("pool spec needs a name")

    @classmethod
    def from_dict(cls, data: dict[str, Any]) -> "PoolSpec":
        known = set(cls.__dataclass_fields__)
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown pool spec field(s) {sorted(unknown)} "
                             f"(known: {sorted(known)})")
        return cls(**data)


def _default_executor_factory(spec: PoolSpec) -> Any:
    """The pool's ``GPUExecutor``, built from its spec: its ``workers``, its
    transport (``"local"`` when the spec names none: the fallback shape)
    and the spec's ``executor`` arguments."""
    from ..gpu import GPUExecutor  # deferred: gpu.py imports the serving tier

    if spec.tpu_name:
        raise NotImplementedError(f"pool {spec.name!r} names TPU {spec.tpu_name!r}: {DISCOVERY}")
    kwargs: dict[str, Any] = dict(spec.executor)
    if spec.workers:
        kwargs.setdefault("workers", list(spec.workers))
    kwargs.setdefault("transport", spec.transport or "local")
    return GPUExecutor(**kwargs)


class Pool:
    """One registered pool: its spec, its executor (built on first use) and
    its slot accounting.

    ``executor_factory`` is injectable (tests build stub executors); an
    ``executor`` given here is used as is.
    """

    def __init__(self, spec: PoolSpec, executor_factory: Callable[[PoolSpec], Any] | None = None,
                 executor: Any = None) -> None:
        self.spec = spec
        self._factory = executor_factory or _default_executor_factory
        self._executor = executor
        self.in_use = 0
        #: loads ever placed here
        self.placed_total = 0
        self._publish_slots()

    # -- identity -------------------------------------------------------------

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def capacity(self) -> int:
        return self.spec.capacity

    @property
    def fallback(self) -> bool:
        return self.spec.fallback

    @property
    def role(self) -> str:
        return self.spec.role

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Pool {self.name}: {self.in_use}/{self.capacity} in use>"

    # -- executor -------------------------------------------------------------

    @property
    def started(self) -> bool:
        return self._executor is not None

    @property
    def executor(self) -> Any:
        if self._executor is None:
            self._executor = self._factory(self.spec)
        return self._executor

    @property
    def warm(self) -> bool:
        """Whether the pool's gang holds a live resident runtime."""
        if self._executor is None:
            return False
        agents = getattr(self._executor, "_agents", {}) or {}
        return any(client is not None and client.alive for client in agents.values())

    # -- slot accounting ------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return max(0, self.capacity - self.in_use)

    def place(self) -> None:
        self.in_use += 1
        self.placed_total += 1
        self._publish_slots()

    def release(self) -> None:
        self.in_use = max(0, self.in_use - 1)
        self._publish_slots()

    def _publish_slots(self) -> None:
        POOL_SLOTS.labels(pool=self.name, state="in_use").set(self.in_use)
        POOL_SLOTS.labels(pool=self.name, state="free").set(self.free_slots)

    # -- lifecycle --------------------------------------------------------------

    async def close(self) -> None:
        if self._executor is not None:
            await self._executor.close()

    def status(self) -> dict[str, Any]:
        """This pool's view: capacity, slots, warmth, its workers and, once
        its executor exists, its RPC digests and serving sessions."""
        view: dict[str, Any] = {
            "capacity": self.capacity, "in_use": self.in_use, "free": self.free_slots,
            "warm": self.warm, "fallback": self.fallback,
            **({"role": self.role} if self.role else {}),
            **({"preemptible": True} if self.spec.preemptible else {}),
            "placed_total": self.placed_total,
            "workers": list(self.spec.workers) or ["local"],
        }
        if self._executor is not None:
            view["registered_digests"] = self._executor.rpc_digest_count()
            view["in_flight_modes"] = self._executor.in_flight_modes()
            view["serve_sessions"] = self._executor.serve_sessions()
        return view

    async def open_session(self, factory: Any, **options: Any):
        """Open a resident serving session pinned to one of this pool's
        slots (released when the handle closes); forwards to
        :func:`~..serving.open_session`."""
        from ..serving import open_session

        return await open_session(self, factory, **options)

    async def capture_profile(self, duration_s: float = 2.0,
                              sid: str = "") -> "dict[str, Any] | None":
        """Trace a resident runtime of this pool's gang (see
        ``GPUExecutor.capture_profile``); None on a pool whose executor was
        never built: a probe must not cold-start one."""
        if self._executor is None:
            return None
        return await self._executor.capture_profile(duration_s=duration_s, sid=sid)


def parse_pool_specs(text: str) -> list[PoolSpec]:
    """Parse ``COVALENT_TPU_POOLS`` / ``fleet.pools`` into specs.

    * JSON: a list of spec objects (or one object) with
      :class:`PoolSpec`'s field names: ``[{"name": "a", "workers": ["w1",
      "w2"], "capacity": 4}, {"name": "cpu", "fallback": true}]``.
    * Compact: ``;``-separated ``name=target@capN`` entries, ``target``
      being ``+``-joined worker addresses or ``local`` (a local fallback
      pool): ``a=10.0.0.1+10.0.0.2@4;cpu=local@2``.  An address may carry
      a login (``edge=ubuntu@10.0.0.9``): a trailing ``@suffix`` is a
      capacity only when it is numeric or ``cap``-prefixed.  Trailing
      ``!tags`` mark the serving role (``!prefill``, ``!decode``) and spot
      capacity (``!spot`` or ``!preemptible``), and stack
      (``cheap=10.0.0.3@4!decode!spot``).  A ``tpu:NAME`` target is
      refused (TPU-VM discovery is not ported).
    """
    text = (text or "").strip()
    if not text:
        return []
    if text[0] in "[{":
        data = json.loads(text)
        if isinstance(data, dict):
            data = [data]
        return [PoolSpec.from_dict(dict(entry)) for entry in data]
    specs: list[PoolSpec] = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, target = entry.partition("=")
        if not sep or not name.strip() or not target.strip():
            raise ValueError(f"bad pool entry {entry!r} (want name=target[@capN])")
        target = target.strip()
        role = ""
        preemptible = False
        while True:
            head_tag, sep_tag, tag_text = target.rpartition("!")
            tag = tag_text.strip()
            if not (sep_tag and tag.isalpha() and head_tag.strip()):
                break
            if tag.lower() in ("spot", "preemptible"):
                preemptible = True
            elif role:
                break  # one serving role only
            else:
                role = tag
            target = head_tag.strip()
        capacity = DEFAULT_CAPACITY
        head, sep, cap_text = target.rpartition("@")
        if sep:
            cap_text = cap_text.strip()
            digits = cap_text[len("cap"):] if cap_text.startswith("cap") else cap_text
            if digits.isdigit() and head.strip():
                target, capacity = head.strip(), int(digits)
            elif not head.strip() or not cap_text or cap_text.startswith("cap"):
                raise ValueError(f"bad capacity in pool entry {entry!r}")
            # else the '@' is a user@host address's
        spec_kwargs: dict[str, Any] = {"name": name.strip(), "capacity": capacity}
        if role:
            spec_kwargs["role"] = role
        if preemptible:
            spec_kwargs["preemptible"] = True
        if target == "local":
            spec_kwargs.update(transport="local", fallback=True)
        elif target.startswith("tpu:"):
            raise NotImplementedError(f"pool entry {entry!r}: {DISCOVERY}")
        else:
            spec_kwargs["workers"] = tuple(w.strip() for w in target.split("+") if w.strip())
        specs.append(PoolSpec(**spec_kwargs))
    return specs


class PoolRegistry:
    """Named pools and the fallback."""

    def __init__(self, executor_factory: Callable[[PoolSpec], Any] | None = None) -> None:
        self._factory = executor_factory
        self._pools: dict[str, Pool] = {}

    def __len__(self) -> int:
        return len(self._pools)

    def __contains__(self, name: str) -> bool:
        return name in self._pools

    def get(self, name: str) -> Pool | None:
        return self._pools.get(name)

    def pools(self) -> list[Pool]:
        return list(self._pools.values())

    def register(self, spec: "PoolSpec | dict[str, Any]", executor: Any = None) -> Pool:
        """Register (or replace) one pool; returns it.  A replaced pool's
        started executor is closed (in the background when an event loop
        runs; otherwise with a warning, as it cannot be)."""
        if isinstance(spec, dict):
            spec = PoolSpec.from_dict(spec)
        displaced = self._pools.get(spec.name)
        pool = Pool(spec, executor_factory=self._factory, executor=executor)
        self._pools[spec.name] = pool
        journal.record("pool", name=spec.name, spec=asdict(spec))
        if displaced is not None and displaced.started:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                app_log.warning("pool %s replaced outside an event loop; the previous "
                                "executor's connections could not be closed", spec.name)
            else:
                task = loop.create_task(displaced.close())
                task.add_done_callback(lambda t: None if t.cancelled() else t.exception())
        return pool

    def register_tpu(self, tpu_name: str, **_: Any) -> Pool:
        raise NotImplementedError(f"register_tpu({tpu_name!r}): {DISCOVERY}")

    def ensure_fallback(self, capacity: int = FALLBACK_CAPACITY,
                        **executor_kwargs: Any) -> Pool:
        """The fallback pool, registering a local one when there is none."""
        existing = self.fallback_pool()
        if existing is not None:
            return existing
        return self.register(PoolSpec(name="local-fallback", transport="local",
                                      capacity=capacity, fallback=True,
                                      executor=dict(executor_kwargs)))

    def fallback_pool(self) -> Pool | None:
        for pool in self._pools.values():
            if pool.fallback:
                return pool
        return None

    def total_capacity(self) -> int:
        return sum(pool.capacity for pool in self._pools.values())

    async def close(self) -> None:
        for pool in self._pools.values():
            try:
                await pool.close()
            except Exception as err:  # noqa: BLE001 - best-effort teardown
                app_log.warning("pool %s close failed: %s", pool.name, err)

    @classmethod
    def from_environment(cls, env_value: str | None = None,
                         executor_factory: Callable[[PoolSpec], Any] | None = None
                         ) -> "PoolRegistry":
        """A registry from ``COVALENT_TPU_POOLS``, or the ``fleet.pools``
        config key when the variable is unset."""
        if env_value is None:
            env_value = os.environ.get(POOLS_ENV)
        if env_value is None:
            env_value = str(get_config("fleet.pools", "") or "")
        registry = cls(executor_factory=executor_factory)
        for spec in parse_pool_specs(env_value):
            registry.register(spec)
        return registry
