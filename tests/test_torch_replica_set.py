"""Replica sets and the disaggregated set on the port's pool servers, on the CPU.

A small LM (2 layers, d_model 64, float32) whose port weights are converted
from the reference's is served through ``open_replica_set`` and
``open_disaggregated_set`` on ``GPUExecutor(use_agent="pool")`` targets,
one pool server each, as ``tests/test_serving_replicas.py`` and
``tests/test_serving_disagg.py`` drive the reference.  Every stream must be
token-equal to the reference's ``ContinuousEngine`` fed the same requests
in-process, which equals its ``continuous_generate`` (greedy, every top-2
margin above 1e-4):

* through a 2-replica set, with placements on both replicas;
* across a SIGKILLed replica that reconnects, exactly once;
* across a replica killed past its retry budget, whose streams drain onto
  the survivor exactly once (re-routed, their high-water marks kept);
* through a disaggregated set (one prefill, one decode replica), every
  request on the KV road, the bundles riding frame bodies;
* on every degrade road: a digest mismatch after the prefill, a bundle
  whose digest the decode worker refuses, a bundle its engine refuses, a
  decode channel without frames (the bundle by CAS path), and a dead
  prefill tier.

The engine steps sleep 100 ms so that a kill lands mid-stream; no sleep
decides a verdict.
"""

import asyncio
import pickle
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
from covalent_tpu_plugin_torch.agent import AgentError
from covalent_tpu_plugin_torch.models import convert, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.serving import open_disaggregated_set, open_replica_set

REPO = Path(__file__).resolve().parent.parent
RESULT_S = 120.0
SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             max_seq=48)
ENGINE = dict(max_batch=2, sync_steps=3, max_new_tokens=16)
CAPS = [12, 5, 9, 12, 7, 10]
MARGIN = 1e-4


def _executor(tmp_path, name: str, env: dict | None = None, **kwargs) -> GPUExecutor:
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / name / "cache"),
        remote_cache=str(tmp_path / name / "remote"), python_path=sys.executable,
        use_agent="pool", pool_preload="cloudpickle",
        task_env={"PYTHONPATH": str(REPO), **(env or {})}, **kwargs,
    )


def slowed(inner, delay: float):
    """The engine of ``inner`` with ``delay`` seconds before each step, so a
    kill lands mid-stream.  Closure-local: it ships by value."""

    def factory():
        import time as time_mod

        engine = inner()
        step = engine.step

        def slow_step():
            time_mod.sleep(delay)
            return step()

        engine.step = slow_step
        return engine

    return factory


@pytest.fixture(scope="module")
def lm():
    """(port model, prompts, the reference engine's streams)."""
    jcfg = jax_tf.TransformerConfig(**SMALL, dtype=jnp.float32, attention="reference")
    tcfg = torch_tf.TransformerConfig(**SMALL, dtype=torch.float32, attention="reference")
    jmodel = jax_tf.TransformerLM(jcfg)
    params = flax.core.meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"])
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0  # clear margins
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, SMALL["vocab_size"], 5 + i % 5).astype(np.int32)
               for i in range(len(CAPS))]
    engine = jax_serve.ContinuousEngine(jmodel, params, **ENGINE)
    queue, want = list(range(len(CAPS))), {}
    while queue or engine.busy:
        while queue and engine.busy < engine.slots:
            i = queue.pop(0)
            engine.admit(str(i), prompts[i], {"max_new_tokens": CAPS[i]})
        for event in engine.step():
            want.setdefault(int(event["rid"]), []).extend(event["tokens"])
    want = [want[i] for i in range(len(CAPS))]
    generated = jax_serve.continuous_generate(jmodel, params, prompts, CAPS, max_batch=2,
                                              sync_steps=3)
    assert [np.asarray(o)[p.size:].tolist() for o, p in zip(generated, prompts)] == want
    seqs = np.zeros((len(CAPS), SMALL["max_seq"]), np.int32)
    for row, p, w in zip(seqs, prompts, want):
        row[: p.size + len(w)] = np.concatenate([p, w])
    logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(seqs)))
    for row, p, w in zip(logits, prompts, want):
        top2 = np.sort(row[p.size - 1: p.size + len(w) - 1], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    return model, prompts, want


def _factory(model, delay: float = 0.1):
    return slowed(serve.lm_engine_factory(model, device="cpu", **ENGINE), delay)


async def _burst(front, prompts) -> list:
    return await asyncio.gather(*(front.request(p, params={"max_new_tokens": c})
                                  for p, c in zip(prompts, CAPS)))


async def _mid_stream(requests, supervisors):
    """The supervisor holding the first request seen with some, not all, of
    its tokens."""
    while True:
        for r, c in zip(requests, CAPS):
            holder = next((sup for sup in supervisors if r.rid in sup._requests), None)
            if 0 < len(r.tokens) < c and holder is not None:
                return holder
        await asyncio.sleep(0.01)


def _refuse_reopen(supervisor) -> None:
    """Every re-open of ``supervisor`` fails: its worker is gone for good."""

    async def refuse():
        raise AgentError("re-open refused: the worker is gone")

    supervisor._open_generation = refuse
    supervisor.retries = 0


def test_replica_set_streams_equal_the_reference_across_kills(tmp_path, run_async, lm):
    model, prompts, want = lm

    async def flow():
        ex_a, ex_b = _executor(tmp_path, "a"), _executor(tmp_path, "b")
        out = {}
        try:
            # a set of two: placement, then a killed replica that reconnects
            rset = await open_replica_set([ex_a, ex_b], _factory(model), retries=2)
            out["plain"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                  for r in await _burst(rset, prompts)))
            out["placed"] = dict(rset.placed)
            requests = await _burst(rset, prompts)
            victim = await _mid_stream(requests, rset.supervisors.values())
            out["cut_short"] = sum(len(r.tokens) < c for r, c in zip(requests, CAPS))
            victim._client._process._proc.kill()
            out["reconnect"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                      for r in requests))
            out["reconnect_status"] = rset.status()
            await rset.close()

            # drain-on-death: the victim cannot come back
            rset = await open_replica_set([ex_a, ex_b], _factory(model), retries=2)
            requests = await _burst(rset, prompts)
            victim = await _mid_stream(requests, rset.supervisors.values())
            survivor = "r1" if victim.replica_of[1] == "r0" else "r0"
            on_victim = [r for r in requests if set(r.arms) == {victim.sid}]
            _refuse_reopen(victim)
            victim._client._process._proc.kill()
            out["drain"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                  for r in requests))
            out["drain_status"] = rset.status()
            out["survivor"] = survivor
            out["drained"] = len(on_victim)
            out["victim_state"] = victim.state
            await rset.close()
        finally:
            await ex_a.close()
            await ex_b.close()
        return out

    out = run_async(flow())
    assert out["plain"] == want
    assert set(out["placed"]) == {"r0", "r1"}
    assert out["cut_short"] > 0
    assert out["reconnect"] == want
    status = out["reconnect_status"]
    assert status["reconnects"] == 1 and status["rerouted"] == 0
    assert status["replay_mismatches"] == {"reconnect": 0, "reroute": 0, "hedge": 0, "handoff": 0,
                                           "preempt": 0}
    assert out["drain"] == want
    status = out["drain_status"]
    assert out["victim_state"] == "failed" and status["state"] == "open"
    assert status["rerouted"] == out["drained"] > 0
    assert status["replicas"][out["survivor"]]["served"] >= out["drained"]
    assert status["replay_mismatches"] == {"reconnect": 0, "reroute": 0, "hedge": 0, "handoff": 0,
                                           "preempt": 0}


def test_disaggregated_set_streams_equal_on_the_kv_road_and_every_degrade(
        tmp_path, run_async, lm):
    model, prompts, want = lm

    async def flow():
        ex_a, ex_b = _executor(tmp_path, "a"), _executor(tmp_path, "b")
        ex_lines = _executor(tmp_path, "lines", agent_frames=False)
        out = {}
        try:
            dset = await open_disaggregated_set([ex_a, ex_b], _factory(model, 0.0),
                                                min_prompt_tokens=2, retries=2)
            out["roles"] = dict(dset._role_of)
            out["kv"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                               for r in await _burst(dset, prompts)))
            out["kv_status"] = dset.status()

            # a bundle that does not hash to what the prefill worker announced
            prefill = dset.supervisors["r0"]
            honest = prefill.prefill_kv

            async def torn_on_the_way(*args, **kwargs):
                event = await honest(*args, **kwargs)
                return {**event, "data_bytes": event["data_bytes"][:-1] + b"\x00"}

            prefill.prefill_kv = torn_on_the_way
            out["mismatch"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                     for r in await _burst(dset, prompts)))
            prefill.prefill_kv = honest

            # bundles the decode worker refuses: a digest that does not match
            # (torn on the decode leg), and a bundle its engine refuses (a
            # sampling fingerprint of another engine)
            prepare = dset._prefill_kv_for

            async def torn_for_decode(request):
                data, _digest = await prepare(request)
                return data, "0" * 64

            async def foreign_bundle(request):
                import hashlib

                data, _digest = await prepare(request)
                bundle = pickle.loads(data)
                bundle["temperature"] = 0.7
                data = pickle.dumps(bundle, protocol=4)
                return data, hashlib.sha256(data).hexdigest()

            for road, fake in (("torn", torn_for_decode), ("refused", foreign_bundle)):
                dset._prefill_kv_for = fake
                out[road] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                   for r in await _burst(dset, prompts)))
            dset._prefill_kv_for = prepare
            await dset.close()  # the workers' last stats arrive with the close
            out["degraded_status"] = dset.status()

            # a decode channel without frames: the bundle ships by CAS path
            dset = await open_disaggregated_set([ex_a, ex_lines], _factory(model, 0.0),
                                                min_prompt_tokens=2, retries=2)
            out["lines_frames_active"] = [
                sup._client.frames_active for sup in dset.supervisors.values()]
            out["lines"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                  for r in await _burst(dset, prompts)))
            await dset.close()
            out["lines_status"] = dset.status()

            # a dead prefill tier: every request falls back to a full prefill
            dset = await open_disaggregated_set([ex_a, ex_b], _factory(model, 0.0),
                                                min_prompt_tokens=2, retries=2)
            prefill = dset.supervisors["r0"]
            _refuse_reopen(prefill)
            prefill._client._process._proc.kill()
            while prefill.state != "failed":
                await asyncio.sleep(0.01)
            out["dead_prefill"] = await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                         for r in await _burst(dset, prompts)))
            out["dead_status"] = dset.status()
            await dset.close()
        finally:
            for ex in (ex_a, ex_b, ex_lines):
                await ex.close()
        return out

    out = run_async(flow())
    n = len(prompts)
    assert out["roles"] == {"r0": "prefill", "r1": "decode"}
    assert out["kv"] == want
    status = out["kv_status"]
    assert status["kv_transfers"] == n and status["requests_by_path"] == {"disagg": n}
    assert status["placed"] == {"r1": n}
    for road in ("mismatch", "torn", "refused", "lines", "dead_prefill"):
        assert out[road] == want, road
    status = out["degraded_status"]
    assert status["requests_by_path"] == {"disagg": 3 * n, "fallback": n}
    # the torn and the refused bundles: admitted by a full prefill on the worker
    decode = status["replicas"]["r1"]
    assert (decode.get("kv_admits"), decode.get("kv_fallbacks")) == (n, 2 * n)
    assert out["lines_frames_active"] == [True, False]
    assert out["lines_status"]["requests_by_path"] == {"disagg": n}
    assert out["lines_status"]["replicas"]["r1"].get("kv_admits") == n
    assert out["dead_status"]["requests_by_path"] == {"fallback": n}
    assert out["dead_status"]["kv_transfers"] == 0


# ---------------------------------------------------------------------------
# The splice across supervisors, on stub sessions (no process)
# ---------------------------------------------------------------------------


class _Executor:
    """What a supervisor reads of its executor before it opens."""

    cache_dir = "."
    _serve_handles: dict = {}


def _chunk(rid, idx, tokens, done=False, error=""):
    return {"type": "serve.token", "rid": rid, "idx": idx, "tokens": tokens, "done": done,
            **({"error": error} if error else {})}


def test_replayed_tokens_that_differ_are_counted_by_road(run_async):
    """A replay below the high-water mark is dropped whatever it says; a
    token that differs from the delivered one is counted on its road: the
    replica's own reconnect, a re-route onto another replica, or the
    losing arm of a hedge, whose terminal error does not fail the request."""
    from covalent_tpu_plugin_torch.serving.supervisor import ServeRequest, SessionSupervisor

    async def flow():
        a = SessionSupervisor(_Executor(), sid="set:r0", replica_of=("set", "r0"))
        b = SessionSupervisor(_Executor(), sid="set:r1", replica_of=("set", "r1"))
        rerouted = ServeRequest("x1", [1], {}, 0.0)
        a._requests["x1"] = rerouted
        a._sink("g", _chunk("x1", 0, [5, 6, 7]))
        a._sink("g", _chunk("x1", 0, [5, 6, 8, 9]))          # a's reconnect replay
        b._requests["x1"] = a.detach_requests()[0]            # drained onto b
        b._sink("g", _chunk("x1", 0, [5, 0, 8, 9, 10], done=True))
        hedged = ServeRequest("x2", [1], {}, 0.0)
        hedged.hedged = True
        a._requests["x2"] = b._requests["x2"] = hedged
        b._sink("g", _chunk("x2", 0, [3, 4]))                 # b delivers first: it wins
        a._sink("g", _chunk("x2", 0, [3, 1, 2]))              # a's duplicate, one token new
        a._sink("g", _chunk("x2", 3, [], done=True, error="cancelled"))
        b._sink("g", _chunk("x2", 2, [2, 6], done=True))
        return (await rerouted.result(1), await hedged.result(1), hedged.served_by,
                a.replay_mismatches_by_road, b.replay_mismatches_by_road, a.in_flight,
                b.in_flight)

    rerouted, hedged, winner, by_a, by_b, a_left, b_left = run_async(flow())
    # the caller keeps what was delivered first: 7 stays, 9 and 10 are new
    assert rerouted == [5, 6, 7, 9, 10] and hedged == [3, 4, 2, 6]
    assert winner == "set:r1"
    assert by_a == {"reconnect": 1, "reroute": 0, "hedge": 1, "handoff": 0, "preempt": 0}
    assert by_b == {"reconnect": 0, "reroute": 2, "hedge": 0, "handoff": 0, "preempt": 0}
    assert (a_left, b_left) == (0, 0)


def test_a_dead_replica_s_hedged_request_stays_with_its_other_arm(run_async):
    """Drain-on-death re-routes what only the dead replica held; a hedged
    request whose other arm lives on streams on there, not twice.  A hedged
    request that only the dead replica held is re-routed as a plain one:
    the replica taking it over owns its stream."""
    from covalent_tpu_plugin_torch.serving.replicas import ReplicaSet
    from covalent_tpu_plugin_torch.serving.supervisor import ServeRequest, SessionSupervisor

    async def flow():
        rset = ReplicaSet([_Executor(), _Executor()], factory=None, name="s")
        a = SessionSupervisor(_Executor(), sid="s:r0", replica_of=("s", "r0"))
        b = SessionSupervisor(_Executor(), sid="s:r1", replica_of=("s", "r1"))
        b._ready.set()
        rset._replicas = {"r0": a, "r1": b}
        hedged, lone = ServeRequest("h", [1], {}, 0.0), ServeRequest("l", [2], {}, 0.0)
        hedged.hedged = lone.hedged = True  # lone's other arm already lost
        for sup, request in ((a, hedged), (b, hedged), (a, lone)):
            sup._requests[request.rid] = request
            request.arms[sup.sid] = 0.0
        a._failed = RuntimeError("gone")
        rset._on_replica_failed(a, a._failed)
        queued = [item.task_metadata["request"].rid for item in rset.router.drain()]
        for task in rset._pump_tasks:
            task.cancel()
        return queued, rset.rerouted, list(b._requests), hedged.arms, lone.hedged

    queued, rerouted, on_b, arms, lone_hedged = run_async(flow())
    assert (queued, rerouted, on_b, list(arms)) == (["l"], 1, ["h"], ["s:r1"])
    assert lone_hedged is False


# ---------------------------------------------------------------------------
# Hedging and scaling, on stub engines (no model)
# ---------------------------------------------------------------------------


def stub_factory():
    """Two lanes; prompt ``[..., base]`` streams ``base+1, base+2, ...`` two
    tokens a step; each step first sleeps ``STUB_STEP_DELAY`` seconds of the
    worker's environment.  Closure-local: it ships by value."""

    def factory():
        import os as os_mod
        import time as time_mod

        delay = float(os_mod.environ.get("STUB_STEP_DELAY", "0"))

        class Engine:
            slots = 2

            def __init__(self):
                self.lanes = {}

            def admit(self, rid, prompt, params):
                cap = int((params or {}).get("max_new_tokens", 6))
                self.lanes[rid] = [int(prompt[-1]) + i + 1 for i in range(cap)]

            def step(self):
                time_mod.sleep(delay)
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


def test_a_slow_replica_s_request_is_hedged_and_the_fast_arm_wins(tmp_path, run_async):
    """Two replicas, one whose steps take 4 s: the request placed there has
    no token after the hedge threshold (1 s before 8 samples), goes to the
    other replica as well, and the fast arm wins; the slow arm is
    abandoned and every stream is the stub's, exactly once."""

    async def flow():
        fast = _executor(tmp_path, "fast")
        slow = _executor(tmp_path, "slow", env={"STUB_STEP_DELAY": "4"})
        try:
            rset = await open_replica_set([fast, slow], stub_factory())
            requests = [await rset.request([10 * (i + 1)], params={"max_new_tokens": 6})
                        for i in range(2)]
            results = [await r.result(timeout=RESULT_S) for r in requests]
            status = rset.status()
            placed = {r.rid: r.served_by for r in requests}
            await rset.close()
        finally:
            await fast.close()
            await slow.close()
        return results, status, placed

    results, status, placed = run_async(flow())
    assert results == [[11, 12, 13, 14, 15, 16], [21, 22, 23, 24, 25, 26]]
    assert (status["hedge"]["issued"], status["hedge"]["wins"]) == (1, 1)
    assert set(placed.values()) == {status["name"] + ":r0"}  # both served by the fast one
    assert status["replicas"]["r1"]["in_flight"] == 0
    assert status["replay_mismatches"] == {"reconnect": 0, "reroute": 0, "hedge": 0, "handoff": 0,
                                           "preempt": 0}


def test_scale_to_grows_shrinks_and_rewarms_from_zero(tmp_path, run_async):
    async def flow():
        executors = [_executor(tmp_path, "s0"), _executor(tmp_path, "s1")]
        seen = []
        try:
            rset = await open_replica_set(executors, stub_factory(), replicas=1)
            seen.append((rset.live_replicas, rset.state))
            seen.append(await rset.scale_to(2))
            seen.append(await (await rset.request([0])).result(timeout=RESULT_S))
            seen.append(await rset.scale_to(1))
            seen.append(await rset.scale_to(0))
            seen.append((rset.live_replicas, rset.state, rset.suspended))
            # the next request re-warms the suspended set, then streams
            seen.append(await (await rset.request([100])).result(timeout=RESULT_S))
            seen.append((rset.live_replicas, rset.state))
            await rset.close()
        finally:
            for ex in executors:
                await ex.close()
        return seen

    assert run_async(flow()) == [
        (1, "open"), 2, [1, 2, 3, 4, 5, 6], 1, 0, (0, "suspended", True),
        [101, 102, 103, 104, 105, 106], (1, "open")]
