"""RPC dispatch of the port: execute by digest in the warm pool server.

Counterpart of ``tests/test_rpc.py``, on the CPU, over the real local
transport: the function ships once per connection through the CAS and is
registered once per digest; each electron is one ``invoke`` with its args
inline (or staged by digest) and one pushed result.  Plus the lifecycle
around it: re-registration after a restart, eviction on discard, digest
mismatch permanent, a dead resident worker transient, the fallback to the
launch road, the static preselection, the per-invocation resets, and the
client's books on every exit path.  The slice as a whole: the MNIST MLP
trained by an RPC electron equals the JAX package's training.
"""

import asyncio
import base64
import os
import sys

import cloudpickle
import numpy as np
import pytest

from covalent_tpu_plugin_torch import GPUExecutor, gpu as gpu_mod
from covalent_tpu_plugin_torch.agent import AgentError, start_pool_server
from covalent_tpu_plugin_torch.cache import bytes_digest
from covalent_tpu_plugin_torch.obs.metrics import REGISTRY
from covalent_tpu_plugin_torch.resilience import FaultClass, classify_error
from covalent_tpu_plugin_torch.transport import LocalTransport

from .test_torch_pool import REPO, WAIT_S, event_log, make_executor, until  # noqa: F401


def make_rpc_executor(tmp_path, **kwargs):
    kwargs.setdefault("dispatch_mode", "rpc")
    return make_executor(tmp_path, **kwargs)


def counter_value(name: str, **labels) -> float:
    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    return sum(counter.value for series, counter in metric._series()
               if all(series.get(k) == v for k, v in labels.items()))


def _make_square():
    # Closure-local: cloudpickle ships it by value, as it ships the
    # functions of a user's script.
    def square(x):
        return x * x

    return square


square = _make_square()


def meta(dispatch_id, node_id=0):
    return {"dispatch_id": dispatch_id, "node_id": node_id}


# ---------------------------------------------------------------------------
# The happy path
# ---------------------------------------------------------------------------


def test_rpc_executes_by_digest_and_matches_launch(tmp_path, run_async, event_log):
    """The same electron on both roads: equal results, equal pickles, the
    same stage spans, and the fast road really taken."""

    async def flow():
        rpc = make_rpc_executor(tmp_path / "rpc")
        launch = make_rpc_executor(tmp_path / "launch", dispatch_mode="launch")
        try:
            rpc_result = await rpc.run(square, [7], {}, meta("r"))
            rpc_view = (rpc.last_dispatch_mode, dict(rpc.last_timings),
                        rpc._agents["localhost"]._process._proc.pid)
            launch_result = await launch.run(square, [7], {}, meta("l"))
            launch_view = (launch.last_dispatch_mode, dict(launch.last_timings))
        finally:
            await rpc.close()
            await launch.close()
        return rpc_result, rpc_view, launch_result, launch_view

    rpc_result, (rpc_mode, rpc_t, _), launch_result, (launch_mode, launch_t) = run_async(flow())
    assert rpc_result == launch_result == 49
    assert cloudpickle.dumps(rpc_result) == cloudpickle.dumps(launch_result)
    assert (rpc_mode, launch_mode) == ("rpc", "launch")
    assert not event_log.of("task.rpc_fallback")
    stages = {"stage", "upload", "connect", "submit", "poll", "execute", "fetch"}
    assert stages <= set(rpc_t) and stages <= set(launch_t)
    for t in (rpc_t, launch_t):
        assert t["overhead"] == pytest.approx(
            sum(v for k, v in t.items() if k not in ("total", "overhead", "wall_overhead",
                                                     "execute")))
        assert t["wall_overhead"] == pytest.approx(t["total"] - t["execute"])


def test_rpc_runs_in_the_resident_server(tmp_path, run_async):
    """Every RPC electron runs in the one pool server process, a fork of
    nobody; ``execute`` is the harness's own clock around the call."""

    def whoami(seconds):
        import os
        import time

        time.sleep(seconds)
        return os.getpid()

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            pids = [await ex.run(whoami, [0.3], {}, meta("p", i)) for i in range(2)]
            return pids, ex._agents["localhost"]._process._proc.pid, dict(ex.last_timings)
        finally:
            await ex.close()

    pids, server_pid, timings = run_async(flow())
    assert pids == [server_pid, server_pid]
    assert 0.3 <= timings["execute"] < timings["total"]


def test_rpc_registers_once_per_connection(tmp_path, run_async):
    """Electrons with other args share one registration: the warm road is
    invoke-by-digest, not ship and register again."""

    async def flow():
        ex = make_rpc_executor(tmp_path)
        misses0 = counter_value("covalent_tpu_rpc_registrations_total", result="miss")
        hits0 = counter_value("covalent_tpu_rpc_registrations_total", result="hit")
        try:
            results = [await ex.run(square, [i], {}, meta("warm", i)) for i in range(3)]
            counts, digests = ex._fn_registry.counts(), ex.rpc_digest_count()
            holds = ex.holds_fn_digest(bytes_digest(cloudpickle.dumps(square)))
        finally:
            await ex.close()
        return (results, counts, digests, holds,
                counter_value("covalent_tpu_rpc_registrations_total", result="miss") - misses0,
                counter_value("covalent_tpu_rpc_registrations_total", result="hit") - hits0)

    results, counts, digests, holds, misses, hits = run_async(flow())
    assert results == [0, 1, 4]
    assert digests == 1 and list(counts.values()) == [1] and holds
    assert (misses, hits) == (1, 2)


def test_rpc_exception_transported(tmp_path, run_async):
    def boom():
        raise KeyError("rpc-boom")

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            with pytest.raises(KeyError, match="rpc-boom"):
                await ex.run(boom, [], {}, meta("b"))
            return ex.last_dispatch_mode
        finally:
            await ex.close()

    assert run_async(flow()) == "rpc"


def test_rpc_oversized_args_take_cas_path_with_equal_results(tmp_path, run_async, event_log):
    """Args past the inline limit are staged through the CAS (verified by
    digest on the worker) and the electron returns the same value."""
    big = "x" * 50_000

    async def flow():
        inline = make_rpc_executor(tmp_path / "inline")
        staged = make_rpc_executor(tmp_path / "staged", rpc_inline_args_max=64)
        cas0 = counter_value("covalent_tpu_cas_uploads_total", result="miss")
        try:
            inline_result = await inline.run(len, [big], {}, meta("i"))
            cas_inline = counter_value("covalent_tpu_cas_uploads_total", result="miss") - cas0
            staged_result = await staged.run(len, [big], {}, meta("s"))
            cas_staged = (counter_value("covalent_tpu_cas_uploads_total", result="miss")
                          - cas0 - cas_inline)
            modes = (inline.last_dispatch_mode, staged.last_dispatch_mode)
        finally:
            await inline.close()
            await staged.close()
        return inline_result, staged_result, cas_inline, cas_staged, modes

    inline_result, staged_result, cas_inline, cas_staged, modes = run_async(flow())
    assert inline_result == staged_result == 50_000
    assert modes == ("rpc", "rpc")
    # the inline arm ships the function; the staged arm ships the args too
    assert cas_staged == cas_inline + 1
    assert len(event_log.of("task.rpc_args_staged")) == 1
    assert not list((tmp_path / "staged" / "cache").glob("args_rpc_*"))


def test_rpc_oversized_result_is_staged_and_fetched(tmp_path, run_async, event_log):
    """A result pickle past the inline limit comes back by path and
    digest; both copies are removed after the fetch."""

    async def flow():
        ex = make_rpc_executor(tmp_path, rpc_inline_args_max=1024)
        try:
            return await ex.run(bytes, [20_000], {}, meta("big"))
        finally:
            await ex.close()

    assert run_async(flow()) == bytes(20_000)
    assert [e["bytes"] > 20_000 for e in event_log.of("task.rpc_result_staged")] == [True]
    assert not list((tmp_path / "remote").glob("result_rpc_*"))
    assert not list((tmp_path / "cache").glob("result_rpc_*"))


# ---------------------------------------------------------------------------
# Registry lifecycle
# ---------------------------------------------------------------------------


def test_rpc_reregisters_after_agent_restart(tmp_path, run_async):
    """A restarted runtime lost its in-process registry: the registered
    set is bound to the client, so the next electron registers again."""

    async def flow():
        ex = make_rpc_executor(tmp_path)
        misses0 = counter_value("covalent_tpu_rpc_registrations_total", result="miss")
        try:
            assert await ex.run(square, [3], {}, meta("a")) == 9
            first = ex._agents["localhost"]
            first._process._proc.kill()
            assert await ex.run(square, [4], {}, meta("a2")) == 16
            second = ex._agents["localhost"]
            misses = counter_value("covalent_tpu_rpc_registrations_total",
                                   result="miss") - misses0
            return first is not second, misses, dict(ex._fn_registry.counts())
        finally:
            await ex.close()

    restarted, misses, counts = run_async(flow())
    assert restarted and misses == 2 and list(counts.values()) == [1]


def test_rpc_registry_evicted_when_connection_discarded(tmp_path, run_async):
    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            await ex.run(square, [2], {}, meta("d"))
            before = ex.rpc_digest_count()
            await ex._discard_workers()
            return before, ex.rpc_digest_count(), dict(ex._cas._present)
        finally:
            await ex.close()

    assert run_async(flow()) == (1, 0, {})


def test_rpc_digest_mismatch_is_permanent(tmp_path, run_async):
    """Bytes that do not match the digest they are registered under are a
    torn payload: refused, and classified PERMANENT."""

    async def flow():
        conn = LocalTransport()
        client = await start_pool_server(conn, str(tmp_path), sys.executable,
                                         preload="cloudpickle")
        try:
            artifact = tmp_path / "payload.pkl"
            artifact.write_bytes(cloudpickle.dumps(square))
            with pytest.raises(AgentError) as excinfo:
                await client.register_fn(bytes_digest(b"other bytes"), str(artifact))
            return excinfo.value
        finally:
            await client.close()

    assert classify_error(run_async(flow())) == (FaultClass.PERMANENT, "rpc_digest_mismatch")


def test_pool_server_invoke_roundtrip(tmp_path, run_async):
    """register_fn + invoke against the real pool server, protocol level."""

    async def flow():
        conn = LocalTransport()
        client = await start_pool_server(conn, str(tmp_path), sys.executable,
                                         preload="cloudpickle")
        try:
            payload = cloudpickle.dumps(square)
            digest = bytes_digest(payload)
            artifact = tmp_path / f"{digest}.pkl"
            artifact.write_bytes(payload)
            await client.register_fn(digest, str(artifact))
            args_b64 = base64.b64encode(cloudpickle.dumps(((6,), {}))).decode("ascii")
            pid = await client.invoke("op-1", digest, spec={"operation_id": "op-1"},
                                      args_b64=args_b64)
            event = await client.wait_result("op-1", timeout=WAIT_S)
            return pid, client._process._proc.pid, event["ok"], \
                GPUExecutor._decode_rpc_result(event), client.registered_digests == {digest}
        finally:
            await client.close()

    pid, server_pid, ok, (result, exception, times), registered = run_async(flow())
    assert pid == server_pid and ok is True and registered
    assert (result, exception) == (36, None) and times["end"] >= times["start"]


def test_rpc_heartbeats_stream_when_the_spec_asks(tmp_path, run_async):
    """With ``heartbeat_s`` in the invoke's spec, the invocation sends
    ``worker.heartbeat`` records over the side-band until it ends."""

    def nap():
        import time

        time.sleep(0.5)
        return "rested"

    async def flow():
        conn = LocalTransport()
        client = await start_pool_server(conn, str(tmp_path), sys.executable,
                                         preload="cloudpickle")
        records = []
        client.on_telemetry = lambda task_id, data: records.append((task_id, data))
        try:
            payload = cloudpickle.dumps(nap)
            digest = bytes_digest(payload)
            (tmp_path / "nap.pkl").write_bytes(payload)
            await client.register_fn(digest, str(tmp_path / "nap.pkl"))
            await client.invoke("hb", digest, spec={"heartbeat_s": 0.1},
                                args_bytes=cloudpickle.dumps(((), {})))
            event = await client.wait_result("hb", timeout=WAIT_S)
            await until(lambda: any(d["type"] == "worker.task_finished" for _, d in records))
            return GPUExecutor._decode_rpc_result(event)[0], records
        finally:
            await client.close()

    result, records = run_async(flow())
    beats = [d for task_id, d in records if d["type"] == "worker.heartbeat"]
    assert result == "rested" and {task_id for task_id, _ in records} == {"hb"}
    assert len(beats) >= 3 and [b["hb_seq"] for b in beats] == list(range(1, len(beats) + 1))
    assert all(b["interval_s"] == 0.1 and b["rpc"] is True for b in beats)


def test_file_digest_is_the_content_digest(tmp_path):
    from covalent_tpu_plugin_torch.cache import file_digest

    data = os.urandom(3 << 20)  # more than one streamed chunk
    (tmp_path / "blob").write_bytes(data)
    assert file_digest(str(tmp_path / "blob")) == bytes_digest(data)


# ---------------------------------------------------------------------------
# Resilience
# ---------------------------------------------------------------------------


def test_rpc_dead_resident_worker_is_transient(tmp_path, run_async):
    """Kill the resident worker mid-invoke: the electron fails with the
    transient ``rpc_channel`` classification (task retries come with
    slice 5b), the runtime is torn down, and the next electron gets a
    fresh one."""

    def slow(i):
        import time

        time.sleep(30)
        return i

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            task = asyncio.ensure_future(ex.run(slow, [5], {}, meta("kill")))
            await until(lambda: ex._op_agents)
            client = next(iter(ex._op_agents.values()))
            modes = ex.in_flight_modes()
            client._process._proc.kill()
            with pytest.raises(AgentError) as excinfo:
                await asyncio.wait_for(task, WAIT_S)
            after = await ex.run(square, [3], {}, meta("after"))
            return excinfo.value, modes, ex._agents["localhost"] is not client, after
        finally:
            await ex.close()

    error, modes, fresh, after = run_async(flow())
    assert classify_error(error) == (FaultClass.TRANSIENT, "rpc_channel")
    assert list(modes.values()) == ["rpc"]
    assert fresh and after == 9


def test_rpc_timeout_tears_the_runtime_down(tmp_path, run_async):
    def slow():
        import time

        time.sleep(30)

    async def flow():
        ex = make_rpc_executor(tmp_path, task_timeout=0.5)
        try:
            await ex.run(square, [1], {}, meta("warm"))
            client = ex._agents["localhost"]
            with pytest.raises(RuntimeError, match="timed out"):
                await ex.run(slow, [], {}, meta("slow"))
            return client.alive, ex._agents.get("localhost")
        finally:
            await ex.close()

    alive, agent = run_async(flow())
    assert not alive and agent is None


def test_rpc_unavailable_runtime_falls_back_to_launch(tmp_path, run_async, monkeypatch,
                                                      event_log):
    """No resident runtime: the same electron takes the launch road, and
    ``task.rpc_fallback`` says so."""

    async def no_pool(*args, **kwargs):
        raise AgentError("scripted: no pool runtime")

    monkeypatch.setattr(gpu_mod, "start_pool_server", no_pool)

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            return await ex.run(square, [9], {}, meta("fb")), ex.last_dispatch_mode
        finally:
            await ex.close()

    assert run_async(flow()) == (81, "launch")
    assert len(event_log.of("task.rpc_fallback")) == 1


def test_rpc_preselect_static_fallbacks(tmp_path):
    """What the RPC road cannot serve launches, decided before it starts."""
    ex = make_rpc_executor(tmp_path / "base", dispatch_mode="auto")
    assert ex._rpc_preselect({}) is True
    assert ex._rpc_preselect({"dispatch_mode": "launch"}) is False
    assert ex._rpc_preselect({"dispatch_mode": "warp"}) is True  # invalid: the executor's
    assert ex._rpc_preselect({"pip_deps": ["torch"]}) is False
    launch = make_rpc_executor(tmp_path / "launch", dispatch_mode="launch")
    assert launch._rpc_preselect({}) is False
    assert launch._rpc_preselect({"dispatch_mode": "rpc"}) is True  # the electron's pin
    assert make_rpc_executor(tmp_path / "na", use_agent=False)._rpc_preselect({}) is False
    # profile_start/profile_stop come with ROADMAP item 2c.5: a profiled electron launches
    assert make_rpc_executor(tmp_path / "pd", profile_dir="traces")._rpc_preselect({}) is False


def test_rpc_resets_the_global_generators_per_invocation(tmp_path, run_async):
    """An earlier electron's ``torch.manual_seed`` does not carry over into
    the next one in the shared process: each invocation starts from a
    fresh, entropy-seeded generator, as a fresh interpreter does."""

    def seeded():
        import torch

        torch.manual_seed(1234)
        return torch.initial_seed()

    def unseeded():
        import torch

        return torch.initial_seed(), torch.rand(1).item()

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            first = await ex.run(seeded, [], {}, meta("s"))
            after = [await ex.run(unseeded, [], {}, meta("u", i)) for i in range(2)]
            return first, after
        finally:
            await ex.close()

    first, after = run_async(flow())
    assert first == 1234
    assert all(seed != 1234 for seed, _ in after)
    assert after[0] != after[1]


def test_rpc_applies_the_task_env(tmp_path, run_async):
    """``task_env`` means the same on both roads: os.environ, and
    PYTHONPATH mirrored into sys.path."""

    def env_view():
        import os
        import sys

        return os.environ.get("RPC_TEST_MARK"), "/rpc/test/entry" in sys.path

    async def flow():
        ex = make_rpc_executor(tmp_path, task_env={
            "RPC_TEST_MARK": "on", "PYTHONPATH": f"/rpc/test/entry{os.pathsep}{REPO}"})
        try:
            return await ex.run(env_view, [], {}, meta("env"))
        finally:
            await ex.close()

    assert run_async(flow()) == ("on", True)


# ---------------------------------------------------------------------------
# The client's books: per-task state drops on every exit path
# ---------------------------------------------------------------------------


def client_books(client) -> dict:
    return {"started": dict(client._started), "exits": dict(client._exits),
            "errors": dict(client._errors), "results": dict(client._results),
            "telemetry_seq": dict(client._telemetry_seq)}


def test_agent_client_state_dropped_on_every_exit_path(tmp_path, run_async):
    """After a success, a remote exception and a cancel mid-flight, the
    resident client keeps nothing per task; the cancel also tears the
    runtime down (an in-process invocation cannot be killed otherwise)."""

    def boom():
        raise ValueError("audit-boom")

    def sleeper():
        import time

        time.sleep(30)

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            await ex.run(square, [2], {}, meta("ok"))
            with pytest.raises(ValueError):
                await ex.run(boom, [], {}, meta("ex"))
            task = asyncio.ensure_future(ex.run(sleeper, [], {}, meta("cancel")))
            # mid-flight means running on the worker: an op in _op_agents may
            # still be uploading, so the cancel would land before the invoke
            # is on the wire; the invocation's first side-band record
            # (worker.task_started) is the proof
            await until(lambda: any(op in agent._telemetry_seq
                                    for op, agent in ex._op_agents.items()))
            client = ex._agents["localhost"]
            await ex.cancel("cancel_0")
            with pytest.raises(asyncio.CancelledError):
                await asyncio.wait_for(task, WAIT_S)
            torn_down = ex._agents.get("localhost") is not client
            launch_ex = make_rpc_executor(tmp_path / "launch", dispatch_mode="launch")
            try:
                await launch_ex.run(square, [3], {}, meta("lw"))
                launch_books = client_books(launch_ex._agents["localhost"])
            finally:
                await launch_ex.close()
            return client_books(client), launch_books, torn_down, ex._op_agents, ex._op_modes
        finally:
            await ex.close()

    books, launch_books, torn_down, op_agents, op_modes = run_async(flow())
    assert torn_down and not op_agents and not op_modes
    for name, mapping in {**books, **{f"launch {k}": v for k, v in launch_books.items()}}.items():
        assert not mapping, f"leaked {name}: {mapping}"


def test_agent_client_forget_clears_rpc_state_after_channel_death(tmp_path, run_async):
    async def flow():
        conn = LocalTransport()
        client = await start_pool_server(conn, str(tmp_path), sys.executable,
                                         preload="cloudpickle")
        try:
            payload = cloudpickle.dumps(square)
            digest = bytes_digest(payload)
            (tmp_path / f"{digest}.pkl").write_bytes(payload)
            await client.register_fn(digest, str(tmp_path / f"{digest}.pkl"))
            await client.invoke("dead-op", digest, args_bytes=cloudpickle.dumps(((2,), {})))
            await client._wait(lambda c: "dead-op" in c._results, WAIT_S)
            client._process._proc.kill()
            with pytest.raises(AgentError):
                await client.wait_dead()
            client.forget("dead-op")
            return client_books(client)
        finally:
            await client.close()

    for name, mapping in run_async(flow()).items():
        assert not mapping, f"leaked {name} after channel death: {mapping}"


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def test_mnist_electron_over_rpc_matches_the_reference(tmp_path, run_async):
    """The MNIST MLP trained for 5 Adam steps by an RPC electron in the
    pool server (on the CPU) from the reference's initial weights; the JAX
    package trains the Flax MLP with optax on the same batches.  The losses
    agree at rtol 1e-4, the tolerance of the launch road's test."""
    import jax
    import optax

    from covalent_tpu_plugin.models.mlp import MLP as RefMLP
    from covalent_tpu_plugin.models.mlp import synthetic_mnist as ref_mnist
    from covalent_tpu_plugin.models.train import classifier_loss

    model = RefMLP()
    batches = [ref_mnist(32, seed=i) for i in range(5)]
    params = model.init(jax.random.PRNGKey(0), batches[0]["image"])["params"]
    start = jax.tree.map(np.asarray, params)
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    ref_losses = []
    for batch in batches:
        loss, grads = jax.value_and_grad(lambda p: classifier_loss(p, model.apply, batch))(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        ref_losses.append(float(loss))

    def port_train(params, steps):
        from covalent_tpu_plugin_torch.models import (
            MLP, adam, make_classifier_train_step, mlp_params_from_jax, synthetic_mnist)

        net = MLP(device="cpu")
        net.load_state_dict(mlp_params_from_jax(params))
        step = make_classifier_train_step(net, adam(net))
        return [float(step(synthetic_mnist(32, seed=i))["loss"]) for i in range(steps)]

    async def flow():
        ex = make_rpc_executor(tmp_path)
        try:
            losses = await ex.run(port_train, [start, 5], {}, meta("mnist"))
            return losses, ex.last_dispatch_mode
        finally:
            await ex.close()

    losses, mode = run_async(flow())
    assert mode == "rpc"
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
