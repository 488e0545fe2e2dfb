"""Live adapter attach and detach over a resident serving session, on the CPU.

A tiny float32 LM (2 layers, d_model 64, 4 heads, a 256 vocabulary) served
from the pool server (``harness.py --serve``), from a replica set of two
pool servers and from the native agent's ``--serve-child``, its engine
hosting an adapter bank.  Adapters go in through the handle and the replica
set (``attach_adapter``: a bundle the JAX package's registry packed, the
port's registry by name, a leaf list), ride the worker's CAS sha256-checked,
and splice into the running engine; each request under an adapter must
stream what a local single-adapter engine streams, token for token.  The
supervisor journals each attach and detach, the router learns where a
partly attached adapter lives (``adapter_affinity``), and a refusal of the
worker's engine (another rank) is permanent.  Interleavings are forced
with held streams, never with a sleep.
"""

import asyncio
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from covalent_tpu_plugin.serving import registry as jax_registry
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.fleet import journal as journal_mod
from covalent_tpu_plugin_torch.models import lora, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.obs.metrics import REGISTRY
from covalent_tpu_plugin_torch.resilience import FaultClass, classify_error
from covalent_tpu_plugin_torch.serving import (
    ServeError,
    ServeRequestRejected,
    open_replica_set,
    open_session,
)
from covalent_tpu_plugin_torch.serving.registry import adapter_content_digest

REPO = Path(__file__).resolve().parent.parent
RESULT_S = 120.0
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=48)
RANK = 2
ENGINE = dict(max_batch=2, sync_steps=4, max_new_tokens=6, length=40)
PROMPT = np.arange(3, 11, dtype=np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = torch_tf.TransformerConfig(**TINY, dtype=torch.float32, attention="reference")
    return torch_tf.TransformerLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def wire(model, seed):
    """An adapter in the wire form, every leaf random (B non-zero)."""
    template = lora.add_lora(model, RANK)
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.3).astype(np.float32)
            for shape in lora.adapter_shapes(template)]


def oracle(model, leaves, prompt=PROMPT, cap=6):
    """What a single-adapter engine (or the base's, ``leaves`` None) streams."""
    target = model if leaves is None else lora.load_adapter(lora.add_lora(model, RANK), leaves)
    engine = serve.ContinuousEngine(target, **ENGINE)
    engine.admit("x", prompt, {"max_new_tokens": cap})
    out = []
    while engine.busy:
        for event in engine.step():
            out += event["tokens"]
    return out


def factory(model, **kwargs):
    return serve.lm_engine_factory(model, device="cpu", **ENGINE, adapter_rank=RANK, **kwargs)


def executor(tmp_path, name="ex", **kwargs):
    kwargs.setdefault("use_agent", "pool")
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / name / "cache"),
        remote_cache=str(tmp_path / name / "remote"), python_path=sys.executable,
        pool_preload="cloudpickle", task_env={"PYTHONPATH": str(REPO)}, **kwargs)


def counter(name: str, **labels) -> float:
    metric = REGISTRY.get(name)
    if metric is None:
        return 0.0
    return sum(series.value for series_labels, series in metric._series()
               if all(series_labels.get(k) == v for k, v in labels.items()))


def stepping_factory(inner, gate: str):
    """``inner``'s engine, stepping only while ``<gate>.run`` exists, or
    once for each ``<gate>.once`` it finds (and removes): the test decides
    when lanes advance.  Closure-local, so cloudpickle ships it by value."""

    def factory():
        import os as os_mod

        engine = inner()
        step = engine.step

        def gated_step():
            if os_mod.path.exists(gate + ".run"):
                return step()
            if os_mod.path.exists(gate + ".once"):
                os_mod.remove(gate + ".once")
                return step()
            return []

        engine.step = gated_step
        return engine

    return factory


def test_attach_and_detach_through_the_handle_and_the_pool_server(model, tmp_path, run_async):
    """One session on the pool server: a JAX-packed bundle attached by
    payload, a second adapter from the executor's registry by name, a hot
    swap while a stream under the old generation is mid-way (its engine
    stepped once, then held), a detach that refuses the name afterwards, a
    rank refusal that is permanent, and every attach and detach journaled."""
    a, b, a2 = wire(model, 1), wire(model, 2), wire(model, 3)
    want = {"a": oracle(model, a, cap=20), "b": oracle(model, b), "a2": oracle(model, a2),
            "base": oracle(model, None)}
    attaches0 = counter("covalent_tpu_serve_adapter_attaches_total", op="attach", outcome="ok")
    gate = str(tmp_path / "gate")
    journal_mod.reset()
    journal_mod.configure(str(tmp_path / "journal"))

    async def flow():
        ex = executor(tmp_path)
        try:
            handle = await open_session(ex, stepping_factory(factory(model, adapters={}), gate),
                                        stats_interval_s=0.2)
            ack = await handle.attach_adapter("a", jax_registry.pack_adapter(a, name="a"))
            ex.adapter_registry().put("b", b)
            ack_b = await handle.attach_adapter("b")
            held = await handle.request(PROMPT, params={"adapter": "a", "max_new_tokens": 20})
            Path(gate + ".once").touch()  # one step: the prefill and 4 tokens
            while not held.tokens:
                await asyncio.sleep(0.01)
            in_flight = len(held.tokens)
            swap = await handle.attach_adapter("a", a2)
            swapped = await handle.request(PROMPT, params={"adapter": "a", "max_new_tokens": 6})
            base = await handle.request(PROMPT, params={"max_new_tokens": 6})
            under_b = await handle.request(PROMPT, params={"adapter": "b", "max_new_tokens": 6})
            Path(gate + ".run").touch()
            streams = {name: await r.result(RESULT_S) for name, r in
                       (("a", held), ("a2", swapped), ("base", base), ("b", under_b))}
            await handle.detach_adapter("b")
            gone = await handle.request(PROMPT, params={"adapter": "b"})
            with pytest.raises(ServeRequestRejected):
                await gone.result(RESULT_S)
            with pytest.raises(ServeError) as refusal:
                await handle.attach_adapter("r4", [np.zeros((64, 4), np.float32)] * 2)
            adapters = handle.adapters
            status = ex.serve_sessions()[handle.sid]
            journaled = dict(journal_mod.get_journal().state.sessions[handle.sid])
            await handle.close()
            return ack, ack_b, swap, streams, refusal.value, adapters, status, journaled, in_flight
        finally:
            await ex.close()

    try:
        ack, ack_b, swap, streams, refusal, adapters, status, journaled, in_flight = \
            run_async(flow())
    finally:
        journal_mod.reset()
    assert 0 < in_flight < 20
    assert streams == want
    assert ack["digest"] == adapter_content_digest(a) == lora.adapter_digest(a)
    assert ack_b["digest"] == adapter_content_digest(b) and ack["attach_s"] >= 0
    assert swap["digest"] == adapter_content_digest(a2)
    assert adapters == {"a": adapter_content_digest(a2)} and status["adapters"] == adapters
    assert classify_error(refusal)[0] is FaultClass.PERMANENT
    assert "leaves" in str(refusal)
    assert counter("covalent_tpu_serve_adapter_attaches_total", op="attach",
                   outcome="ok") == attaches0 + 3
    assert set(journaled["adapters"]) == {"a"}
    assert journaled["adapters"]["a"]["content"] == adapter_content_digest(a2)


def test_a_replica_set_attaches_on_every_member_or_on_the_least_loaded(model, tmp_path,
                                                                        run_async):
    """Attach on both members, then one adapter on one member only: the
    router learns its site and places requests naming it there
    (``adapter_affinity``); each stream equals the single-adapter engine's;
    detach clears both."""
    a, b = wire(model, 4), wire(model, 5)
    want_a, want_b = oracle(model, a), oracle(model, b)
    affinity0 = counter("covalent_tpu_serve_router_decisions_total", outcome="adapter_affinity")

    async def flow():
        executors = [executor(tmp_path, f"r{i}") for i in range(2)]
        try:
            rset = await open_replica_set(executors, factory(model, adapters={}),
                                          stats_interval_s=0.2)
            acks = await rset.attach_adapter("a", a)
            only = await rset.attach_adapter("b", b, replicas=1)
            residency = rset.adapter_residency()
            runs = [await rset.request(PROMPT, params={"adapter": "b"}) for _ in range(3)]
            on_a = await rset.request(PROMPT, params={"adapter": "a"})
            streams = [await r.result(RESULT_S) for r in runs] + [await on_a.result(RESULT_S)]
            detached = await rset.detach_adapter("a")
            after = rset.adapter_residency()
            await rset.close()
            return acks, only, residency, streams, detached, after
        finally:
            for ex in executors:
                await ex.close()

    acks, only, residency, streams, detached, after = run_async(flow())
    assert set(acks) == {"r0", "r1"} and all("digest" in ack for ack in acks.values())
    (site,) = only
    assert residency == {"a": ["r0", "r1"], "b": [site]}
    assert streams == [want_b] * 3 + [want_a]
    assert counter("covalent_tpu_serve_router_decisions_total",
                   outcome="adapter_affinity") >= affinity0 + 3
    assert set(detached) == {"r0", "r1"} and after == {"b": [site]}


@pytest.mark.skipif(not any(shutil.which(c) for c in ("g++", "c++", "clang++")),
                    reason="needs a C++ compiler to build the native agent")
def test_the_native_agent_forwards_the_adapter_verbs(model, tmp_path, run_async):
    """The native agent relays serving frames verbatim to the session's
    ``--serve-child``: an attach and a detach go through it and answer."""
    a = wire(model, 6)
    want = oracle(model, a)

    async def flow():
        ex = executor(tmp_path, use_agent="native")
        try:
            handle = await open_session(ex, factory(model, adapters={}))
            ack = await handle.attach_adapter("a", a)
            stream = await (await handle.request(PROMPT, params={"adapter": "a"})).result(
                RESULT_S)
            detached = await handle.detach_adapter("a")
            mode = handle.supervisor._client.mode
            await handle.close()
            return ack, stream, detached, mode
        finally:
            await ex.close()

    ack, stream, detached, mode = run_async(flow())
    assert mode == "native"
    assert ack["digest"] == adapter_content_digest(a) and stream == want
    assert detached["event"] == "serve_detached" and detached["adapter"] == "a"
