"""The port's resident serving session through ``GPUExecutor``, on the CPU.

``open_session(GPUExecutor(use_agent="pool"), factory)`` as
``tests/test_serving.py`` drives the reference: concurrent streams, the
stream iterator, an admission shed classified PERMANENT, a deadline that
reclaims its lane, a pool server killed mid-stream and every stream still
delivered exactly once, ``close()`` and its stats, a factory that prints on
stdout, autograd off on the session thread, and every knob of a later item
refused.  The engines are stubs pickled by value, except in the last test:
a small LM (2 layers, d_model 64, float32) whose port weights are converted
from the reference's, served through the port's resident session and held
token for token against the reference's ``ContinuousEngine`` and the
port's ``continuous_generate`` on the same requests.
"""

import asyncio
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from covalent_tpu_plugin.models import serve as jax_serve
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.models import convert, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.resilience import FaultClass, classify_error
from covalent_tpu_plugin_torch.serving import (
    ServeError,
    ServeHandle,
    ServeRequestRejected,
    open_session,
)

from .test_torch_session_protocol import gated_factory

REPO = Path(__file__).resolve().parent.parent
RESULT_S = 60.0


def _executor(tmp_path, **kwargs):
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / "cache"),
        remote_cache=str(tmp_path / "remote"), python_path=sys.executable,
        use_agent="pool",
        # light start-up: the server and its zygote import torch only when a
        # factory needs it
        pool_preload="cloudpickle",
        # the LM factory's class is pickled by reference: the worker imports the port
        task_env={"PYTHONPATH": str(REPO)}, **kwargs,
    )


def make_factory(step_delay=0.0, slots=2, chunk=2, default_cap=6, noisy=False, hold=None):
    """A stub engine pickled by value: prompt ``[..., base]`` streams
    ``base+1, base+2, ...``.  ``noisy`` prints on stdout, without newlines,
    from the factory and from every step.  With ``hold`` (a path) a lane
    emits nothing after its first chunk until that file exists."""

    def factory():
        import os as os_mod
        import time as time_mod

        if noisy:
            print("factory says hello", end="", flush=True)
            os_mod.write(1, b"raw bytes on fd 1")

        class Engine:
            def __init__(self):
                self.slots = slots
                self.lanes = {}
                self.started = set()

            def admit(self, rid, prompt, params):
                cap = int((params or {}).get("max_new_tokens", default_cap))
                self.lanes[rid] = [int(prompt[-1]) + i + 1 for i in range(cap)]

            def step(self):
                if noisy:
                    print("step", end="", flush=True)
                if step_delay:
                    time_mod.sleep(step_delay)
                events = []
                for rid in list(self.lanes):
                    if hold and rid in self.started and not os_mod.path.exists(hold):
                        continue
                    self.started.add(rid)
                    taken, self.lanes[rid] = self.lanes[rid][:chunk], self.lanes[rid][chunk:]
                    done = not self.lanes[rid]
                    if done:
                        del self.lanes[rid]
                    events.append({"rid": rid, "tokens": taken, "done": done})
                return events

            def cancel(self, rid):
                self.lanes.pop(rid, None)

        return Engine()

    return factory


def grad_probe_factory():
    """A one-slot engine whose one-step streams say whether autograd was on
    in the factory, in ``admit`` or in ``step`` (first token), and whether
    a product in ``step`` recorded a graph (second token)."""

    def factory():
        import threading

        import torch as torch_mod

        seen = [torch_mod.is_grad_enabled()]
        main = threading.main_thread()

        class Engine:
            slots = 1

            def __init__(self):
                self.lanes = []

            def admit(self, rid, prompt, params):
                seen.append(torch_mod.is_grad_enabled())
                self.lanes.append(rid)

            def step(self):
                seen.append(torch_mod.is_grad_enabled())
                graph = (torch_mod.ones(2, requires_grad=True) * 2).requires_grad
                off_main = threading.current_thread() is not main
                events = [{"rid": rid, "tokens": [int(any(seen)), int(graph), int(off_main)],
                           "done": True} for rid in self.lanes]
                self.lanes = []
                return events

        return Engine()

    return factory


async def _settle(requests):
    return await asyncio.gather(*(r.result(timeout=RESULT_S) for r in requests),
                                return_exceptions=True)


# ---------------------------------------------------------------------------
# Streams, backpressure, deadlines, reconnect, close
# ---------------------------------------------------------------------------


def test_session_streams_concurrent_requests(tmp_path, run_async):
    """Five concurrent callers through one session: every stream lands,
    TTFT <= latency, the live session shows in ``serve_sessions()``, and
    ``close()`` reports the served count and leaves the final stats."""

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, make_factory(), stats_interval_s=0.1)
            requests = await asyncio.gather(
                *(handle.request([10 * i], params={"max_new_tokens": 4}) for i in range(5)))
            results = await _settle(requests)
            view = dict(ex.serve_sessions())
            closed = await handle.close()
            return handle, requests, results, view, closed, dict(ex.serve_sessions())
        finally:
            await ex.close()

    handle, requests, results, view, closed, after = run_async(flow())
    assert results == [[10 * i + j + 1 for j in range(4)] for i in range(5)]
    assert all(r.ttft_s is not None and r.ttft_s <= r.latency_s for r in requests)
    assert view[handle.sid]["state"] == "open" and view[handle.sid]["slots"] == 2
    assert closed["served"] == 5 and handle.served == 5
    assert handle.stats["served"] == 5 and handle.stats["tokens_total"] == 20
    assert handle.state == "closed" and after == {}
    assert 0 < handle.payload_bytes < 64 << 10


def test_stream_iterator_yields_chunks(tmp_path, run_async):
    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, make_factory(chunk=2))
            request = await handle.request([100], params={"max_new_tokens": 6})
            chunks = [chunk async for chunk in request.stream()]
            await handle.close()
            return chunks
        finally:
            await ex.close()

    chunks = run_async(flow())
    assert chunks == [[101, 102], [103, 104], [105, 106]]


def test_admission_shed_is_permanent(tmp_path, run_async):
    """With the one lane held and the one queue place taken, the next
    request is shed at once; the rejection classifies PERMANENT under
    ``serve_admission_shed``, and the admitted work still completes."""

    async def flow():
        ex = _executor(tmp_path)
        gate = tmp_path / "gate"
        try:
            handle = await open_session(ex, gated_factory(), queue_max=1)
            held = await handle.request([10], params={"max_new_tokens": 3, "hold": str(gate)})
            while not held.tokens:
                await asyncio.sleep(0.01)
            queued = await handle.request([20], params={"max_new_tokens": 2})
            shed = await handle.request([30], params={"max_new_tokens": 2})
            outcome = (await _settle([shed]))[0]
            gate.touch()
            results = await _settle([held, queued])
            await handle.close()
            return outcome, results
        finally:
            await ex.close()

    shed, results = run_async(flow())
    assert isinstance(shed, ServeRequestRejected) and shed.code == "serve_admission_shed"
    assert classify_error(shed) == (FaultClass.PERMANENT, "serve_admission_shed")
    assert results == [[11, 12, 13], [21, 22]]


def test_deadline_reclaims_the_lane(tmp_path, run_async):
    """A request past its deadline mid-generation completes with its
    partial stream and ``deadline_exceeded``; the freed lane admits the
    next request."""

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(
                ex, make_factory(step_delay=0.05, slots=1, chunk=1, default_cap=400))
            request = await handle.request([0], deadline_s=0.5)
            tokens = await request.result(timeout=RESULT_S)
            follow = await handle.request([50], params={"max_new_tokens": 2}, deadline_s=30.0)
            follow_tokens = await follow.result(timeout=RESULT_S)
            await handle.close()
            return tokens, request.error, follow_tokens
        finally:
            await ex.close()

    tokens, error, follow_tokens = run_async(flow())
    assert error == "deadline_exceeded"
    assert 0 < len(tokens) < 400 and tokens == [i + 1 for i in range(len(tokens))]
    assert follow_tokens == [51, 52]


def test_abandon_frees_the_lane(tmp_path, run_async):
    """``abandon`` drops a request and cancels it on the worker, so the one
    lane it held serves the next request."""

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, gated_factory())
            stuck = await handle.request([10], params={"max_new_tokens": 3,
                                                       "hold": str(tmp_path / "never")})
            while not stuck.tokens:
                await asyncio.sleep(0.01)
            handle.supervisor.abandon(stuck.rid)
            follow = await handle.request([40], params={"max_new_tokens": 3})
            result = await follow.result(timeout=RESULT_S)
            await handle.close()
            return stuck.done, handle.in_flight, result
        finally:
            await ex.close()

    stuck_done, in_flight, result = run_async(flow())
    assert not stuck_done and in_flight == 0 and result == [41, 42, 43]


def test_kill_mid_stream_reconnects_exactly_once(tmp_path, run_async):
    """SIGKILL the pool server mid-stream: the supervisor re-opens the
    session on a fresh server, replays the in-flight requests, and the idx
    splice hands every caller each token exactly once, equal to its
    uninterrupted stream.  The handle stays usable."""

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, make_factory(step_delay=0.1, default_cap=12),
                                        retries=2)
            requests = [await handle.request([100 * i]) for i in range(3)]
            for _ in range(400):
                if all(len(r.tokens) >= 4 for r in requests):
                    break
                await asyncio.sleep(0.05)
            first_pid = ex._agents["localhost"]._process._proc.pid
            ex._agents["localhost"]._process._proc.kill()
            results = await _settle(requests)
            chunks_ok = all(len(r.tokens) == len(set(r.tokens)) for r in requests)
            late = await handle.request([7], params={"max_new_tokens": 3})
            late_result = await late.result(timeout=RESULT_S)
            second_pid = ex._agents["localhost"]._process._proc.pid
            state, reconnects, generation = handle.state, handle.reconnects, handle.generation
            await handle.close()
            return results, chunks_ok, late_result, state, reconnects, generation, \
                first_pid != second_pid
        finally:
            await ex.close()

    results, chunks_ok, late, state, reconnects, generation, new_server = run_async(flow())
    assert results == [[100 * i + j + 1 for j in range(12)] for i in range(3)]
    assert chunks_ok and late == [8, 9, 10]
    assert (state, reconnects, generation, new_server) == ("open", 1, 2, True)


def flip_factory(flip_file):
    """``make_factory``'s stub, except that a lane admitted once
    ``flip_file`` exists streams its second token plus 1000: a replay that
    differs from the first run below the high-water mark."""

    def factory():
        import os as os_mod
        import time as time_mod

        class Engine:
            slots = 3

            def __init__(self):
                self.lanes = {}

            def admit(self, rid, prompt, params):
                lane = [int(prompt[-1]) + i + 1 for i in range(12)]
                if os_mod.path.exists(flip_file):
                    lane[1] += 1000
                self.lanes[rid] = lane

            def step(self):
                time_mod.sleep(0.1)
                events = []
                for rid in list(self.lanes):
                    taken, self.lanes[rid] = self.lanes[rid][:2], self.lanes[rid][2:]
                    done = not self.lanes[rid]
                    if done:
                        del self.lanes[rid]
                    events.append({"rid": rid, "tokens": taken, "done": done})
                return events

            def cancel(self, rid):
                self.lanes.pop(rid, None)

        return Engine()

    return factory


def test_a_replay_that_differs_is_counted_not_delivered(tmp_path, run_async):
    """The replay after a reconnect flips a token the caller already has:
    the caller's stream stays the first run's (the splice drops what is
    below its high-water mark, as the reference's does), and the session
    counts each differing token in ``replay_mismatches``."""
    flip = tmp_path / "flip"

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, flip_factory(str(flip)), retries=2)
            requests = [await handle.request([100 * i]) for i in range(3)]
            async def first_tokens():
                while not all(len(r.tokens) >= 4 for r in requests):
                    await asyncio.sleep(0.05)

            await asyncio.wait_for(first_tokens(), RESULT_S)
            flip.touch()  # the lanes admitted from here on differ at index 1
            ex._agents["localhost"]._process._proc.kill()
            results = await _settle(requests)
            status = handle.supervisor.status()
            await handle.close()
            return results, handle.reconnects, handle.replay_mismatches, status
        finally:
            await ex.close()

    results, reconnects, mismatches, status = run_async(flow())
    assert results == [[100 * i + j + 1 for j in range(12)] for i in range(3)]
    assert reconnects == 1
    assert mismatches == 3 and status["replay_mismatches"] == 3


def test_open_refusals_are_permanent_and_raise(tmp_path, run_async):
    """A factory that refuses its model with the permanence tag fails the
    open once, PERMANENT, without a retry storm."""

    def refusing_factory():
        class ModelUnsupported(ValueError):
            fault_label = "serve_model_unsupported"
            fault_transient = False

        raise ModelUnsupported("rolling_cache models are not servable")

    async def flow():
        ex = _executor(tmp_path)
        try:
            with pytest.raises(Exception, match="factory_failed") as info:
                await open_session(ex, refusing_factory)
            return info.value
        finally:
            await ex.close()

    error = run_async(flow())
    assert classify_error(error) == (FaultClass.PERMANENT, "serve_model_unsupported")


# ---------------------------------------------------------------------------
# The card's troubles, checked on the CPU
# ---------------------------------------------------------------------------


def test_a_factory_printing_on_stdout_cannot_corrupt_the_protocol(tmp_path, run_async):
    """fd 1 of the pool server is stderr: a factory's and an engine's
    prints (no newline, and raw bytes on fd 1) land in the server's log,
    and the streams are untouched."""

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, make_factory(noisy=True))
            requests = [await handle.request([10 * i], params={"max_new_tokens": 5})
                        for i in range(3)]
            results = await _settle(requests)
            await handle.close()
            return results
        finally:
            await ex.close()

    results = run_async(flow())
    assert results == [[10 * i + j + 1 for j in range(5)] for i in range(3)]
    log = (tmp_path / "remote" / "pool_server.log").read_text()
    assert "factory says hello" in log and "raw bytes on fd 1" in log and "step" in log


def test_the_session_thread_runs_with_autograd_off(tmp_path, run_async):
    """Grad mode is per thread: the factory, ``admit`` and ``step`` all run
    on the session's own thread with autograd off."""

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(ex, grad_probe_factory())
            requests = [await handle.request([1]) for _ in range(2)]
            results = await _settle(requests)
            await handle.close()
            return results
        finally:
            await ex.close()

    assert run_async(flow()) == [[0, 0, 1], [0, 0, 1]]


# ---------------------------------------------------------------------------
# Knobs of later items
# ---------------------------------------------------------------------------


def test_executor_takes_the_native_agent_pin():
    """``use_agent="native"`` pins the native agent
    (``tests/test_torch_native_agent.py`` drives it); a value off the
    ladder is refused."""
    assert GPUExecutor(use_agent="native").use_agent == "native"
    with pytest.raises(ValueError, match="use_agent must be"):
        GPUExecutor(use_agent="natve")


@pytest.mark.parametrize("method,args,item", [
    ("attach_adapter", ("t",), "is closed"),
    ("detach_adapter", ("t",), "is closed"),
])
def test_handle_refuses_features_of_later_items(tmp_path, method, args, item):
    """The adapter verbs are ported (``tests/test_torch_adapter_session.py``
    drives them); on a closed session they fail as closed, as the
    reference's do."""
    handle = ServeHandle(_executor(tmp_path), make_factory())
    handle._sup._closed = True
    with pytest.raises(ServeError, match=item):
        asyncio.run(getattr(handle, method)(*args))


def test_a_closed_handle_captures_no_profile(tmp_path):
    """``capture_profile`` on a closed session fails as closed
    (``tests/test_torch_profile.py`` captures a live one)."""
    handle = ServeHandle(_executor(tmp_path), make_factory())
    handle._sup._closed = True
    with pytest.raises(ServeError, match="is closed"):
        asyncio.run(handle.capture_profile())


def test_a_pool_without_a_resident_runtime_refuses_the_session_before_pinning(
        tmp_path, run_async):
    """A fleet Pool's executor hosts the session, whose open pins a slot;
    an executor without a resident runtime refuses the session before it
    pins anything."""
    from covalent_tpu_plugin_torch.fleet.pools import Pool, PoolSpec

    ex = GPUExecutor(cache_dir=str(tmp_path / "cache"), remote_cache=str(tmp_path / "remote"),
                     use_agent=False)
    pool = Pool(PoolSpec(name="refusing"), executor=ex)
    with pytest.raises(Exception, match="use_agent='pool'"):
        run_async(open_session(pool, make_factory()))
    assert pool.in_use == 0


def test_a_session_needs_the_pool_runtime(tmp_path, run_async):
    ex = GPUExecutor(cache_dir=str(tmp_path / "cache"), remote_cache=str(tmp_path / "remote"),
                     use_agent=False)
    with pytest.raises(Exception, match="use_agent='pool'"):
        run_async(open_session(ex, make_factory()))
    assert not (tmp_path / "remote").exists()  # nothing was started


# ---------------------------------------------------------------------------
# A real LM through the session, against the reference's engine
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             max_seq=48)
CAPS = [3, 12, 5, 8, 1, 9]
ENGINE = dict(max_batch=2, sync_steps=3, max_new_tokens=16)
MARGIN = 1e-4


def test_lm_session_streams_equal_the_reference_engine(tmp_path, run_async):
    """Six mixed-budget greedy requests through the port's resident session
    (the worker builds the model on the CPU from the shipped weights) are
    token-exact to the reference's ``ContinuousEngine`` fed the same
    requests in-process, and to the port's ``continuous_generate``.  The
    reference's top-2 margin at every generated step exceeds 1e-4 first."""
    jcfg = jax_tf.TransformerConfig(**SMALL, dtype=jnp.float32, attention="reference")
    tcfg = torch_tf.TransformerConfig(**SMALL, dtype=torch.float32, attention="reference")
    jmodel = jax_tf.TransformerLM(jcfg)
    params = flax.core.meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0  # clear margins
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, SMALL["vocab_size"], 3 + i % 4).astype(np.int32)
               for i in range(len(CAPS))]

    # the reference engine, in-process: admit as lanes free, step until done
    engine = jax_serve.ContinuousEngine(jmodel, params, **ENGINE)
    queue, want = list(range(len(CAPS))), {}
    while queue or engine.busy:
        while queue and engine.busy < engine.slots:
            i = queue.pop(0)
            engine.admit(str(i), prompts[i], {"max_new_tokens": CAPS[i]})
        for event in engine.step():
            want.setdefault(int(event["rid"]), []).extend(event["tokens"])
    want = [want[i] for i in range(len(CAPS))]
    seqs = np.zeros((len(CAPS), SMALL["max_seq"]), np.int32)
    for row, p, w in zip(seqs, prompts, want):
        row[: p.size + len(w)] = np.concatenate([p, w])
    logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(seqs)))
    for row, p, w in zip(logits, prompts, want):
        top2 = np.sort(row[p.size - 1: p.size + len(w) - 1], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN

    async def flow():
        ex = _executor(tmp_path)
        try:
            handle = await open_session(
                ex, serve.lm_engine_factory(model, device="cpu", **ENGINE))
            requests = await asyncio.gather(*(
                handle.request(p, params={"max_new_tokens": c}) for p, c in zip(prompts, CAPS)))
            results = await _settle(requests)
            closed = await handle.close()
            return results, closed, handle.payload_bytes
        finally:
            await ex.close()

    got, closed, payload_bytes = run_async(flow())
    assert got == want
    assert [len(g) for g in got] == CAPS and closed["served"] == len(CAPS)
    cg = serve.continuous_generate(model, prompts, CAPS, max_batch=2, sync_steps=3)
    assert [o[p.size:].tolist() for o, p in zip(cg, prompts)] == want
    # the weights ship as host tensors: f32, 2 layers
    n_bytes = sum(p.numel() * 4 for p in model.parameters())
    assert n_bytes < payload_bytes < n_bytes + (64 << 10)


def test_lm_factory_ships_host_data_only():
    """A seeded factory pickles to a few hundred bytes; a model's factory
    to its weights as CPU tensors, never a live module."""
    import cloudpickle

    cfg = torch_tf.TransformerConfig(**SMALL, dtype=torch.float32, attention="reference")
    seeded = serve.lm_engine_factory(config=cfg, seed=0, device="cpu", max_batch=2)
    assert len(cloudpickle.dumps(seeded)) < 4096
    engine = cloudpickle.loads(cloudpickle.dumps(seeded))()
    assert engine.slots == 2 and engine._model.embedding.dtype == torch.bfloat16
    model = torch_tf.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    shipped = cloudpickle.loads(cloudpickle.dumps(serve.lm_engine_factory(model, device="cpu")))
    assert shipped._model is None and set(shipped.weights) == set(model.state_dict())
    rebuilt = shipped()._model
    for (name, a), b in zip(model.state_dict().items(), rebuilt.state_dict().values()):
        assert torch.equal(a, b), name
    with pytest.raises(ValueError, match="a config and a seed"):
        serve.lm_engine_factory(config=cfg)
