"""The port's retry policy against the JAX package's, on the CPU.

The same errors go through both ``classify_error``s, the same attempts,
faults and deadlines through both ``RetryPolicy.should_retry``s on an
injected clock, and the same seeds through both full-jitter ``delay``s:
the answers must be equal.  Then what the port's executor builds from its
constructor keys.
"""

import asyncio

import pytest

from covalent_tpu_plugin import resilience as jax_res
from covalent_tpu_plugin.transport.base import TransportError as JaxTransportError
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch import resilience as res
from covalent_tpu_plugin_torch.transport.base import TransportError


class Clock:
    def __init__(self) -> None:
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


class _Shed(Exception):
    fault_label = "serve_admission_shed"
    fault_transient = False


class _Tagged(Exception):
    fault_label = "rpc_channel"
    fault_transient = True


def _chain(outer, inner):
    outer.__cause__ = inner
    return outer


#: name -> a maker of the error, given the port's or the reference's classes
ERRORS = {
    "transport": lambda m: m["TransportError"]("channel died"),
    "stalled": lambda m: m["WorkerStalledError"]("no heartbeat for 9s"),
    "preempted": lambda m: m["WorkerPreemptedError"]("died after the notice"),
    "circuit_open": lambda m: m["CircuitOpenError"]("circuit open"),
    "circuit_in_chain": lambda m: _chain(m["TransportError"]("failed to connect to 1/1"),
                                         m["CircuitOpenError"]("open")),
    "connection_refused": lambda m: ConnectionRefusedError("refused"),
    "timeout": lambda m: TimeoutError("slow"),
    "oserror": lambda m: OSError("broken pipe"),
    "file_not_found": lambda m: FileNotFoundError("missing"),
    "permission": lambda m: PermissionError("denied"),
    "is_a_directory": lambda m: IsADirectoryError("dir"),
    "value": lambda m: ValueError("user code"),
    "runtime": lambda m: RuntimeError("digest mismatch"),
    "key": lambda m: KeyError("x"),
    "cancelled": lambda m: asyncio.CancelledError(),
    "self_tagged_permanent": lambda m: _Shed("shed"),
    "self_tagged_transient": lambda m: _Tagged("worker gone"),
}

PORT = {"TransportError": TransportError, "WorkerStalledError": res.WorkerStalledError,
        "WorkerPreemptedError": res.WorkerPreemptedError,
        "CircuitOpenError": res.CircuitOpenError}
REFERENCE = {"TransportError": JaxTransportError,
             "WorkerStalledError": jax_res.WorkerStalledError,
             "WorkerPreemptedError": jax_res.WorkerPreemptedError,
             "CircuitOpenError": jax_res.CircuitOpenError}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_classify_error_matches_the_reference(name):
    got = res.classify_error(ERRORS[name](PORT))
    want = jax_res.classify_error(ERRORS[name](REFERENCE))
    assert (got[0].value, got[1]) == (want[0].value, want[1])


def test_stall_and_preemption_are_transient_under_their_own_labels():
    assert res.classify_error(res.WorkerStalledError("x")) == (
        res.FaultClass.TRANSIENT, "worker_stalled")
    assert res.classify_error(res.WorkerPreemptedError("x")) == (
        res.FaultClass.TRANSIENT, "worker_preempted")
    assert issubclass(res.WorkerStalledError, TransportError)


@pytest.mark.parametrize("max_retries", [0, 1, 3])
@pytest.mark.parametrize("budget", [0.0, 10.0])
def test_should_retry_truth_table_matches_the_reference(max_retries, budget):
    """Every attempt x fault x (live, expired) deadline: equal answers."""
    clock, jax_clock = Clock(), Clock()
    port = res.RetryPolicy(max_retries=max_retries, wall_budget=budget)
    ref = jax_res.RetryPolicy(max_retries=max_retries, wall_budget=budget)
    deadline = res.Deadline(budget, clock=clock)
    jax_deadline = jax_res.Deadline(budget, clock=jax_clock)
    for advance in (0.0, 11.0):
        clock.now += advance
        jax_clock.now += advance
        assert deadline.expired == jax_deadline.expired
        assert deadline.remaining() == jax_deadline.remaining()
        for attempt in range(5):
            for fault in ("transient", "permanent"):
                got = port.should_retry(attempt, res.FaultClass(fault), deadline)
                want = ref.should_retry(attempt, jax_res.FaultClass(fault), jax_deadline)
                assert got == want, (attempt, fault, advance)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_full_jitter_delays_match_the_reference_for_a_seed(seed):
    port = res.RetryPolicy(max_retries=8, base_delay=0.5, max_delay=4.0, seed=seed)
    ref = jax_res.RetryPolicy(max_retries=8, base_delay=0.5, max_delay=4.0, seed=seed)
    got = [port.delay(i) for i in range(10)]
    assert got == [ref.delay(i) for i in range(10)]
    for attempt, delay in enumerate(got):
        assert 0.0 <= delay <= min(4.0, 0.5 * 2 ** attempt)


def test_deadline_counts_down_on_an_injected_clock():
    clock = Clock()
    unbounded = res.Deadline(0.0, clock=clock)
    assert not unbounded.bounded and unbounded.remaining() is None and not unbounded.expired
    deadline = res.Deadline(5.0, clock=clock)
    clock.now += 2.0
    assert deadline.remaining() == pytest.approx(3.0) and not deadline.expired
    clock.now += 4.0
    assert deadline.expired and deadline.remaining() == 0.0


def test_executor_builds_its_policy_from_arguments_environment_and_defaults(monkeypatch):
    ex = GPUExecutor()
    assert ex.max_task_retries == 0 and ex._retry_policy.max_retries == 0  # off by default
    assert ex.heartbeat_interval == 0.0 and ex._stall_after() == 0.0
    assert ex.checkpoint_interval_s == 0.0 and ex.checkpoint_keep_n == 3
    assert ex._chaos is None
    monkeypatch.setenv("COVALENT_TPU_TASK_RETRIES", "3")
    monkeypatch.setenv("COVALENT_TPU_HEARTBEAT_S", "2")
    monkeypatch.setenv("COVALENT_TPU_STALL_S", "7")
    monkeypatch.setenv("COVALENT_TPU_CHECKPOINT_INTERVAL_S", "30")
    monkeypatch.setenv("COVALENT_TPU_CHECKPOINT_KEEP", "2")
    monkeypatch.setenv("COVALENT_TPU_CHAOS", "seed=3,drop_after=5")
    ex = GPUExecutor(retry_wall_budget=60, circuit_threshold=5, circuit_cooldown=1.5)
    assert ex.max_task_retries == 3 and ex._retry_policy.wall_budget == 60
    assert (ex.heartbeat_interval, ex._stall_after()) == (2.0, 7.0)
    assert (ex.checkpoint_interval_s, ex.checkpoint_keep_n) == (30.0, 2)
    assert ex._chaos.seed == 3 and ex._chaos.drop_after == 5
    assert (ex._breakers.failure_threshold, ex._breakers.cooldown) == (5, 1.5)
    # an argument outranks the environment
    ex = GPUExecutor(max_task_retries=1, heartbeat_interval=0.5, stall_threshold=0.0)
    assert ex.max_task_retries == 1 and ex._stall_after() == 1.5  # three intervals


@pytest.mark.parametrize("key,value", [("prewarm_enabled", False), ("cache_results", True),
                                       ("cas_ttl_hours", 2.5), ("cas_max_bytes", 4096)])
def test_the_lifecycle_and_cache_keys_take_the_reference_defaults(key, value, tmp_path):
    """``prewarm``, ``cache_results``, ``cas_ttl_hours`` and ``cas_max_bytes``
    default as the JAX package's executor does, and an argument is taken."""
    from covalent_tpu_plugin import TPUExecutor

    common = dict(transport="local", cache_dir=str(tmp_path / "cache"))
    assert getattr(GPUExecutor(**common), key) == getattr(TPUExecutor(**common), key)
    arg = "prewarm" if key == "prewarm_enabled" else key
    assert getattr(GPUExecutor(**common, **{arg: value}), key) == value


@pytest.mark.parametrize("method,args,kwargs", [
    ("prewarm", (), {"chaos": "drop_after=1"}), ("prewarm", (), {"prewarm": False}),
    ("teardown_gang", (), {}), ("health_canary", ("localhost",), {})])
def test_the_lifecycle_on_a_cold_executor_answers_as_the_reference(method, args, kwargs,
                                                                    tmp_path):
    """Nothing dialed: a prewarm under a chaos plan or turned off, a
    teardown of nothing warm and a canary of a worker with no runtime all
    answer False, as the JAX package's executor does, and dial nothing."""
    from covalent_tpu_plugin import TPUExecutor

    common = dict(transport="local", cache_dir=str(tmp_path / "cache"), **kwargs)

    async def ask(ex):
        try:
            return await getattr(ex, method)(*args)
        finally:
            await ex.close()

    ours = GPUExecutor(**common)
    assert asyncio.run(ask(ours)) is asyncio.run(ask(TPUExecutor(**common))) is False
    assert not ours._transports and not ours.is_warm
