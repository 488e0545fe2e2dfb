"""Serving sessions over SSH: ``open_session``, ``open_replica_set`` and
``open_disaggregated_set`` on ``GPUExecutor(transport="minissh")`` targets.

The session's verbs and frames ride the pool server's channel, which over
SSH is an exec channel of the port's own minissh server (on loopback, in a
thread with its own event loop, as ``tests/test_torch_ssh_executor.py``
runs it).  Every stream is held token for token against the same requests
through a session over ``transport="local"``:

* a stub engine (pickled by value) on frames and on JSON lines, with its
  pool server killed mid-stream: every stream completes exactly once;
* a small LM (2 layers, d_model 64, float32) whose port weights are
  converted from the reference's (``models/convert.py``): greedy streams
  equal to the local session's and to the JAX package's ``generate`` of
  each prompt alone (the reference's top-2 margin at every generated step
  exceeds 1e-4 first, as in ``tests/test_torch_session.py``);
* a two-replica set whose replicas are two SSH addresses of the server, and
  a disaggregated set whose KV bundles ride the SSH channels, both equal to
  the local session's streams;
* a session on the native agent started over SSH.
"""

from __future__ import annotations

import asyncio
import shutil
import sys
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("cryptography", reason="minissh needs the `cryptography` package")

from covalent_tpu_plugin.models import decode as jax_decode
from covalent_tpu_plugin.models import transformer as jax_tf
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.models import convert, serve
from covalent_tpu_plugin_torch.models import transformer as torch_tf
from covalent_tpu_plugin_torch.serving import (
    open_disaggregated_set,
    open_replica_set,
    open_session,
)
from covalent_tpu_plugin_torch.serving.supervisor import split_target

from .test_torch_session import make_factory
from .test_torch_ssh_executor import MARKER, ThreadedServer

REPO = Path(__file__).resolve().parent.parent
RESULT_S = 120.0
SMALL = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128,
             max_seq=48)
ENGINE = dict(max_batch=2, sync_steps=3, max_new_tokens=16)
CAPS = [3, 12, 5, 8, 1, 9]
MARGIN = 1e-4


@pytest.fixture(scope="module")
def sshd(tmp_path_factory):
    server = ThreadedServer(tmp_path_factory.mktemp("sshd"))
    yield server
    server.close()


def _local(tmp_path, name: str, **kwargs) -> GPUExecutor:
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / name / "cache"),
        remote_cache=str(tmp_path / name / "remote"), python_path=sys.executable,
        use_agent="pool", pool_preload="cloudpickle",
        task_env={"PYTHONPATH": str(REPO)}, **kwargs)


def _ssh(tmp_path, sshd, name: str, host: str = "127.0.0.1", **kwargs) -> GPUExecutor:
    settings = dict(
        transport="minissh", hostname=sshd.address(host), ssh_key_file=str(sshd.key_file),
        known_host_key_file=str(sshd.host_pub), strict_host_keys=True,
        cache_dir=str(tmp_path / name / "cache"), remote_cache=str(tmp_path / name / "remote"),
        remote_workdir=str(tmp_path / name / "work"), python_path=sys.executable,
        use_agent="pool", pool_preload="cloudpickle", task_env={"PYTHONPATH": str(REPO)},
        max_connection_attempts=2, retry_wait_time=0.1)
    settings.update(kwargs)
    return GPUExecutor(**settings)


async def _streams(front, prompts, caps) -> list:
    requests = await asyncio.gather(*(front.request(p, params={"max_new_tokens": c})
                                      for p, c in zip(prompts, caps)))
    return [list(t) for t in await asyncio.gather(*(r.result(timeout=RESULT_S)
                                                     for r in requests))]


def marker_factory(inner):
    """``inner``'s engine, whose first stream starts with a token that says
    whether the worker runs under the SSH server (its environment holds the
    server's marker)."""

    def factory():
        import os as os_mod

        engine = inner()
        admit = engine.admit

        def marked_admit(rid, prompt, params):
            admit(rid, prompt, params)
            if rid in engine.lanes:
                engine.lanes[rid] = ([1 if os_mod.environ.get(MARKER) else 0]
                                     + engine.lanes[rid])

        engine.admit = marked_admit
        return engine

    return factory


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "lines"])
def test_a_session_over_minissh_streams_like_the_local_session(tmp_path, sshd, run_async,
                                                                frames):
    """A stub engine's streams over minissh equal a local session's, on
    frames and on JSON lines; the worker runs under the SSH server.  Then
    the lanes are held after their first chunk (``make_factory(hold=)``), the pool
    server is killed while they are held, and once released every stream
    still completes exactly once on the reconnected worker."""
    prompts = [[10 * i] for i in range(6)]
    caps = [4, 9, 2, 7, 5, 3]
    hold = tmp_path / "hold"
    hold.write_text("")

    async def flow():
        local = _local(tmp_path, "local")
        remote = _ssh(tmp_path, sshd, "remote", agent_frames=frames)
        out = {}
        try:
            handle = await open_session(local, make_factory(slots=2, chunk=2))
            out["local"] = await _streams(handle, prompts, caps)
            await handle.close()
            handle = await open_session(remote, marker_factory(
                make_factory(slots=2, chunk=2, hold=str(hold))), retries=2)
            out["ssh"] = await _streams(handle, prompts, caps)
            out["address"] = handle.supervisor.address
            key = remote._pool_key(sshd.address())
            out["frames"] = remote._agents[remote._transports[key].address].frames_active
            hold.unlink()
            requests = await asyncio.gather(*(handle.request(p, params={"max_new_tokens": c})
                                              for p, c in zip(prompts, caps)))
            while sum(bool(r.tokens) for r in requests) < 2:  # both slots' first chunks
                await asyncio.sleep(0.01)
            client = next(c for c in remote._agents.values() if c is not None)
            await remote._transports[key].run(f"kill -9 {client._banner['pid']}")
            hold.write_text("")
            out["killed"] = [list(t) for t in await asyncio.gather(
                *(r.result(timeout=RESULT_S) for r in requests))]
            out["reconnects"] = handle.reconnects
            out["closed"] = await handle.close()
        finally:
            await local.close()
            await remote.close()
        return out

    out = run_async(flow())
    marked = [[1] + s for s in out["local"]]
    assert out["ssh"] == marked and out["killed"] == marked
    assert out["frames"] is frames
    assert out["address"].startswith("tester@127.0.0.1")
    assert out["reconnects"] == 1
    # the reconnected generation served the killed burst's replays
    assert out["closed"]["served"] == len(prompts)


@pytest.fixture(scope="module")
def lm():
    """(port model, prompts, the reference's greedy ``generate`` of each
    prompt alone)."""
    jcfg = jax_tf.TransformerConfig(**SMALL, dtype=jnp.float32, attention="reference")
    tcfg = torch_tf.TransformerConfig(**SMALL, dtype=torch.float32, attention="reference")
    jmodel = jax_tf.TransformerLM(jcfg)
    params = flax.core.meta.unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(7), jnp.zeros((1, 4), jnp.int32))["params"])
    params["lm_head"]["kernel"] = params["lm_head"]["kernel"] * 10.0  # clear margins
    model = torch_tf.TransformerLM(tcfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, SMALL["vocab_size"], 3 + i % 4).astype(np.int32)
               for i in range(len(CAPS))]
    want = []
    for p, c in zip(prompts, CAPS):
        out = jax_decode.generate(jmodel, params, jnp.asarray(p)[None], c)
        want.append(np.asarray(out)[0, p.size:].tolist())
    seqs = np.zeros((len(CAPS), SMALL["max_seq"]), np.int32)
    for row, p, w in zip(seqs, prompts, want):
        row[: p.size + len(w)] = np.concatenate([p, w])
    logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(seqs)))
    for row, p, w in zip(logits, prompts, want):
        top2 = np.sort(row[p.size - 1: p.size + len(w) - 1], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > MARGIN
    return model, prompts, want


def test_the_small_lm_over_minissh_equals_the_local_session_and_the_reference(
        tmp_path, sshd, run_async, lm):
    """Greedy streams of the converted small LM through a session over
    minissh equal the local session's and the JAX package's ``generate``."""
    model, prompts, want = lm
    factory = serve.lm_engine_factory(model, device="cpu", **ENGINE)

    async def flow():
        local, remote = _local(tmp_path, "local"), _ssh(tmp_path, sshd, "remote")
        try:
            handle = await open_session(local, factory)
            got_local = await _streams(handle, prompts, CAPS)
            await handle.close()
            handle = await open_session(remote, factory)
            got_ssh = await _streams(handle, prompts, CAPS)
            closed = await handle.close()
        finally:
            await local.close()
            await remote.close()
        return got_local, got_ssh, closed

    got_local, got_ssh, closed = run_async(flow())
    assert got_ssh == got_local == want
    assert closed["served"] == len(CAPS)


def test_a_replica_set_over_minissh_streams_like_the_local_session(tmp_path, sshd,
                                                                   run_async, lm):
    """Two replicas behind one front, each a pool server reached over its
    own SSH address: every stream equals the local session's, and both
    replicas took requests."""
    model, prompts, want = lm
    factory = serve.lm_engine_factory(model, device="cpu", **ENGINE)

    async def flow():
        ex_a = _ssh(tmp_path, sshd, "a", host="127.0.0.1")
        ex_b = _ssh(tmp_path, sshd, "b", host="localhost")
        try:
            rset = await open_replica_set([ex_a, ex_b], factory)
            got = await _streams(rset, prompts + prompts, CAPS + CAPS)
            status = rset.status()
            await rset.close()
        finally:
            await ex_a.close()
            await ex_b.close()
        return got, status

    got, status = run_async(flow())
    assert got == want + want
    served = [r["served"] for r in status["replicas"].values()]
    assert len(served) == 2 and all(n > 0 for n in served) and sum(served) == 2 * len(CAPS)


def test_a_disaggregated_set_over_minissh_moves_its_bundles_over_ssh(tmp_path, sshd,
                                                                      run_async, lm):
    """The prefill tier and the decode tier are pool servers over two SSH
    addresses: every long prompt takes the KV road, on frames and, with the
    decode channel on JSON lines, by the CAS road, and every stream equals
    the local session's."""
    model, prompts, want = lm
    factory = serve.lm_engine_factory(model, device="cpu", **ENGINE)

    async def flow():
        out = {}
        for road, frames in (("frames", True), ("cas", False)):
            ex_a = _ssh(tmp_path, sshd, f"{road}_a", host="127.0.0.1")
            ex_b = _ssh(tmp_path, sshd, f"{road}_b", host="localhost", agent_frames=frames)
            try:
                dset = await open_disaggregated_set([ex_a, ex_b], factory,
                                                    min_prompt_tokens=2, retries=2)
                out[road] = await _streams(dset, prompts, CAPS)
                await dset.close()
                out[f"{road}_status"] = dset.status()
            finally:
                await ex_a.close()
                await ex_b.close()
        return out

    out = run_async(flow())
    for road in ("frames", "cas"):
        assert out[road] == want, road
        status = out[f"{road}_status"]
        assert status["requests_by_path"]["disagg"] == len(CAPS), status["requests_by_path"]
        assert status["kv_bytes_total"] > 0


@pytest.mark.skipif(not any(shutil.which(c) for c in ("g++", "c++", "clang++")),
                    reason="the native agent needs a C++ compiler on the worker")
def test_a_session_on_the_native_agent_over_minissh(tmp_path, sshd, run_async):
    """``use_agent="native"`` over SSH: the agent is uploaded, built and
    started through the SSH channel, and its ``--serve-child`` streams
    equal a local session's."""
    prompts = [[10 * i] for i in range(4)]
    caps = [4, 9, 2, 7]

    async def flow():
        local, remote = _local(tmp_path, "local"), _ssh(tmp_path, sshd, "native",
                                                        use_agent="native")
        try:
            handle = await open_session(local, make_factory(slots=2, chunk=2))
            want = await _streams(handle, prompts, caps)
            await handle.close()
            handle = await open_session(remote, marker_factory(make_factory(slots=2, chunk=2)))
            got = await _streams(handle, prompts, caps)
            modes = {c.mode for c in remote._agents.values() if c is not None}
            await handle.close()
        finally:
            await local.close()
            await remote.close()
        return want, got, modes

    want, got, modes = run_async(flow())
    assert got == [[1] + s for s in want]
    assert modes == {"native"}


@pytest.mark.parametrize("kind", ["ssh", "minissh"])
def test_a_serving_target_over_ssh_is_taken_as_it_is(kind):
    """``split_target`` takes an SSH executor, and a pool over one, like a
    local one."""
    ex = GPUExecutor(transport=kind, hostname="user@host:2222")
    assert split_target(ex) == (ex, None)

    class PoolLike:
        spec = object()
        executor = ex

    pool = PoolLike()
    assert split_target(pool) == (ex, pool)
