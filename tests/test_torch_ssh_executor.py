"""The SSH slice as a whole: ``GPUExecutor(transport="minissh")`` over a real
SSH server on loopback.

One minissh server (the port's own, ``transport/minissh.py``) runs for the
module in a thread with its own event loop, so a dispatcher that waits
synchronously never starves it.  It authorizes one ed25519 client key, and
every executor pins its ed25519 host key.  Its environment carries a marker
that no other process has: every electron returns it, which proves the
electron ran under the SSH server.

* BASELINE config 1 (``socket.gethostname()`` in a lattice) on the launch
  road, with the stage timings, the pre-flight and the wire accounted.
* The warm pool over SSH: ``pool_run`` (a zygote fork) and ``rpc``; a
  discarded channel takes its pool server with it, and the next electron
  starts a fresh one.
* A small LM's training electron: losses bit-equal to the same electron
  over ``transport="local"``, and within ``tests/test_torch_train.py``'s
  bound (atol 1e-5) of the JAX reference's optax steps on the same weights
  and batches.
* A two-worker FSDP gang whose workers are two SSH addresses of the one
  server, on gloo and the CPU: losses within 1e-6 of the same gang over
  the local transport.
* The ``"gpu"`` alias builds an SSH executor from ``[executors.gpu]``; an
  unreachable worker emits ``task.dispatch_failed`` and raises (or runs on
  the dispatcher with ``run_local_on_dispatch_fail``), and its breaker then
  fails fast; the addressing, the pre-flight command and the credential
  check follow the JAX package's executor.

Module-level functions pickle by reference: the worker imports this module
from the checkout (``task_env`` PYTHONPATH), so it imports nothing of JAX
at the top.
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import socket
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("cryptography", reason="minissh needs the `cryptography` package")

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519

import covalent_tpu_plugin_torch.workflow as ct
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch.models import train
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.parallel import MeshPlan
from covalent_tpu_plugin_torch.transport import codec, minissh
from covalent_tpu_plugin_torch.utils import config as config_mod
from covalent_tpu_plugin_torch.workflow import runner

REPO = Path(__file__).resolve().parents[1]
MARKER = "COVALENT_SSH_TEST_MARKER"
USER = "tester"
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128, max_seq=128)


class ThreadedServer:
    """The port's minissh server on 127.0.0.1, on its own loop and thread."""

    def __init__(self, root: Path) -> None:
        self.marker = f"ssh-{os.getpid()}-{os.urandom(4).hex()}"
        client = ed25519.Ed25519PrivateKey.generate()
        host = ed25519.Ed25519PrivateKey.generate()
        self.key_file = root / "id_ed25519"
        self.key_file.write_bytes(client.private_bytes(
            serialization.Encoding.PEM, serialization.PrivateFormat.OpenSSH,
            serialization.NoEncryption()))
        os.chmod(self.key_file, 0o600)
        self.host_pub = root / "host_ed25519.pub"
        self.host_pub.write_bytes(host.public_key().public_bytes(
            serialization.Encoding.OpenSSH, serialization.PublicFormat.OpenSSH))
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, name="minissh",
                                        daemon=True)
        self._thread.start()
        self.server = asyncio.run_coroutine_threadsafe(minissh.serve(
            host_key=host, authorized_keys={USER: [client]},
            env={**os.environ, MARKER: self.marker}), self._loop).result(30)
        self.port = self.server.port

    def address(self, host: str = "127.0.0.1") -> str:
        return f"{USER}@{host}:{self.port}"

    def close(self) -> None:
        async def stop():
            self.server.close()
            await self.server.wait_closed()

        asyncio.run_coroutine_threadsafe(stop(), self._loop).result(30)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(30)


@pytest.fixture(scope="module")
def sshd(tmp_path_factory):
    server = ThreadedServer(tmp_path_factory.mktemp("sshd"))
    yield server
    server.close()


@pytest.fixture()
def events():
    seen: list = []
    obs_events.add_listener(seen.append)
    yield seen
    obs_events.remove_listener(seen.append)


def _executor(tmp_path, sshd, **kwargs) -> GPUExecutor:
    settings = dict(
        transport="minissh", hostname=sshd.address(), ssh_key_file=str(sshd.key_file),
        known_host_key_file=str(sshd.host_pub), strict_host_keys=True,
        cache_dir=str(tmp_path / "cache"), remote_cache=str(tmp_path / "remote"),
        remote_workdir=str(tmp_path / "work"), python_path=sys.executable, poll_freq=0.1,
        task_env={"PYTHONPATH": str(REPO)}, pool_preload="cloudpickle",
        max_connection_attempts=2, retry_wait_time=0.1)
    settings.update(kwargs)
    return GPUExecutor(**settings)


def _close_on_dispatcher(executor) -> None:
    asyncio.run_coroutine_threadsafe(executor.close(), runner._dispatcher_loop()).result(120)


def _failures(events) -> list:
    return [e for e in events if e["type"] == "task.dispatch_failed"]


def where_am_i() -> tuple:
    import os
    import socket

    return socket.gethostname(), os.environ.get("COVALENT_SSH_TEST_MARKER"), os.getpid()


def two_adamw_steps(state: dict, batches: list, config: dict) -> list:
    """Two AdamW steps of the port's LM from the given weights; its losses."""
    import torch

    from covalent_tpu_plugin_torch.models import train
    from covalent_tpu_plugin_torch.models import transformer as tf

    cfg = tf.TransformerConfig(**config, dtype=torch.float32, param_dtype=torch.float32,
                               logits_dtype=torch.float32, attention="flash")
    model = tf.TransformerLM(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    step = train.make_train_step(model, train.adamw(model), loss_fn=train.lm_loss)
    return [float(step(batch)["loss"]) for batch in batches]


def test_config1_runs_as_a_lattice_over_ssh(tmp_path, sshd, events):
    """BASELINE config 1 on the reference's own road (``use_agent=False``:
    staged files, a nohup launch, status probes, a fetch, a cleanup)."""
    ex = _executor(tmp_path, sshd, use_agent=False)
    up = codec.WIRE_BYTES_TOTAL.labels(direction="up", codec="raw").value
    hello = ct.electron(where_am_i, executor=ex)
    flow = ct.lattice(lambda: hello())
    try:
        first = ct.dispatch_sync(flow)()
        timings = dict(ex.last_timings)
        second = ct.dispatch_sync(flow)()
    finally:
        _close_on_dispatcher(ex)
    assert first.status is ct.Status.COMPLETED, first.error
    host, marker, pid = first.result
    assert (host, marker) == (socket.gethostname(), sshd.marker) and pid != os.getpid()
    assert second.result[:2] == first.result[:2] and second.result[2] != pid
    assert ex.last_dispatch_mode == "launch" and not _failures(events)
    assert {"connect", "preflight", "upload", "submit", "poll", "fetch", "cleanup",
            "execute"} <= set(timings)
    assert timings["overhead"] == pytest.approx(sum(
        v for k, v in timings.items()
        if k not in ("execute", "total", "overhead", "wall_overhead")))
    # one dial and one pre-flight for the connection, whatever ran on it
    assert [e["type"] for e in events].count("transport.retry") == 0
    spans = [e for e in events if e["type"] == "span" and e["name"] == "pool.connect"]
    assert len(spans) == 1
    assert codec.WIRE_BYTES_TOTAL.labels(direction="up", codec="raw").value >= up
    # the harness and the function pickle stay in the worker's CAS under
    # their digests; nothing else is left
    remote = tmp_path / "remote"
    assert sorted(p.name for p in remote.iterdir()) == ["cas"]
    held = [(p.suffix, p.stem == hashlib.sha256(p.read_bytes()).hexdigest())
            for p in (remote / "cas").iterdir()]
    assert {suffix for suffix, _ in held} == {".pkl", ".py"} and all(ok for _, ok in held)


def test_the_warm_pool_runs_both_roads_over_ssh(tmp_path, sshd, run_async, events):
    ex = _executor(tmp_path, sshd, use_agent="pool")

    async def flow():
        try:
            got = []
            for node, mode in enumerate(("launch", "rpc", "launch", "rpc")):
                out = await ex.run(where_am_i, [], {}, {"dispatch_id": "pool", "node_id": node,
                                                       "dispatch_mode": mode})
                got.append((ex.last_dispatch_mode, out, dict(ex.last_timings)))
            (client,) = [c for c in ex._agents.values() if c is not None]
            frames, server_pid = client.frames_active, client._banner.get("pid")
            # a discarded channel takes its pool server with it; the next
            # electron dials afresh and starts a new one
            await ex._discard_workers()
            assert not ex._preflighted and not ex._agents
            after = await ex.run(where_am_i, [], {}, {"dispatch_id": "pool", "node_id": 9,
                                                      "dispatch_mode": "rpc"})
            (fresh,) = [c for c in ex._agents.values() if c is not None]
            return got, frames, server_pid, after, fresh._banner.get("pid")
        finally:
            await ex.close()

    got, frames, server_pid, after, fresh_pid = run_async(flow())
    assert [mode for mode, _, _ in got] == ["launch", "rpc", "launch", "rpc"]
    for _, (host, marker, pid), _ in got:
        assert (host, marker) == (socket.gethostname(), sshd.marker)
    # RPC electrons run in the pool server itself; launches are its zygote's forks
    assert got[1][1][2] == got[3][1][2] == server_pid
    assert got[0][1][2] != got[2][1][2] and server_pid not in (got[0][1][2], got[2][1][2])
    assert frames is True and got[0][2]["connect"] > got[2][2]["connect"]
    assert after[1] == sshd.marker and after[2] == fresh_pid != server_pid
    assert not _failures(events)
    assert not [e for e in events if e["type"] in ("task.rpc_fallback", "agent.unavailable")]


def test_an_lm_electron_over_ssh_equals_local_and_the_reference(tmp_path, sshd, run_async):
    from .test_torch_train import LOSS_ATOL, _jax_steps, _setup
    from covalent_tpu_plugin_torch.models import data

    jmodel, params, model, _ = _setup()
    batches = list(data.synthetic_lm_batches(steps=2, batch_size=2, seq_len=33,
                                             vocab_size=TINY["vocab_size"], seed=3))
    _, want = _jax_steps(jmodel, params, batches)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    async def flow(ex):
        try:
            return await ex.run(two_adamw_steps, [state, batches, TINY], {},
                                {"dispatch_id": "lm", "node_id": 0})
        finally:
            await ex.close()

    over_ssh = run_async(flow(_executor(tmp_path / "ssh", sshd, use_agent=False)))
    local = run_async(flow(GPUExecutor(
        transport="local", cache_dir=str(tmp_path / "lc"), remote_cache=str(tmp_path / "lr"),
        python_path=sys.executable, poll_freq=0.1, use_agent=False,
        task_env={"PYTHONPATH": str(REPO)})))
    assert over_ssh == local  # the same bits
    np.testing.assert_allclose(over_ssh, want, rtol=0, atol=LOSS_ATOL)


def test_a_gang_over_two_ssh_addresses_trains_like_the_local_gang(tmp_path, sshd, run_async,
                                                                  events):
    kwargs = dict(steps=3, batch_size=4, seq_len=16, seed=0, device="cpu",
                  mesh_plan=MeshPlan(fsdp=2), **TINY)
    workers = [sshd.address("127.0.0.1"), sshd.address("localhost")]

    async def flow(ex):
        try:
            out = await ex.run(train.train_lm, [], kwargs, {"dispatch_id": "g", "node_id": 0})
            return out, dict(ex.last_timings), ex._coordinator_address()
        finally:
            await ex.close()

    over_ssh, timings, coordinator = run_async(flow(_executor(
        tmp_path / "ssh", sshd, workers=workers, coordinator_port=0, use_agent="pool")))
    local, _, _ = run_async(flow(GPUExecutor(
        transport="local", workers=["w0", "w1"], coordinator_port=0, use_agent="pool",
        pool_preload="cloudpickle", cache_dir=str(tmp_path / "lc"),
        remote_cache=str(tmp_path / "lr"), python_path=sys.executable, poll_freq=0.1,
        task_env={"PYTHONPATH": str(REPO)})))
    np.testing.assert_allclose(over_ssh["losses"], local["losses"], rtol=0, atol=1e-6)
    assert over_ssh["world_size"] == 2 and over_ssh["backend"] == "gloo"
    assert [r["rank"] for r in over_ssh["ranks"]] == [0, 1]
    assert coordinator.startswith("127.0.0.1:") and timings["rendezvous"] >= 0
    assert not _failures(events)


def test_the_gpu_alias_builds_an_ssh_executor_from_the_config(tmp_path, sshd, monkeypatch):
    monkeypatch.setenv("COVALENT_TPU_CONFIG", str(tmp_path / "config.toml"))
    config_mod._reset_cache_for_tests()
    try:
        for key, value in dict(
                transport="minissh", hostname=sshd.address(), ssh_key_file=str(sshd.key_file),
                known_host_key_file=str(sshd.host_pub), use_agent=False,
                cache_dir=str(tmp_path / "cache"), remote_cache=str(tmp_path / "remote"),
                python_path=sys.executable, poll_freq=0.1,
                task_env={"PYTHONPATH": str(REPO)}).items():
            config_mod.set_config(f"executors.gpu.{key}", value)
        hello = ct.electron(where_am_i, executor="gpu")
        result = ct.dispatch_sync(ct.lattice(lambda: hello()))()
    finally:
        config_mod._reset_cache_for_tests()
    assert result.status is ct.Status.COMPLETED, result.error
    assert result.result[1] == sshd.marker


def _closed_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_an_unreachable_worker_fails_loudly_then_fast(tmp_path, sshd, run_async, events):
    dead = f"{USER}@127.0.0.1:{_closed_port()}"

    async def flow():
        ex = _executor(tmp_path, sshd, hostname=dead, max_connection_attempts=1,
                       use_agent=False)
        messages = []
        try:
            for node in range(4):
                with pytest.raises(RuntimeError) as caught:
                    await ex.run(where_am_i, [], {}, {"dispatch_id": "dead", "node_id": node})
                messages.append(str(caught.value))
        finally:
            await ex.close()
        fallback = _executor(tmp_path, sshd, hostname=dead, max_connection_attempts=1,
                             use_agent=False, run_local_on_dispatch_fail=True)
        try:
            local = await fallback.run(where_am_i, [], {}, {"dispatch_id": "dead", "node_id": 5})
        finally:
            await fallback.close()
        return messages, local

    messages, local = run_async(flow())
    assert all(m.startswith("could not reach GPU workers") for m in messages)
    # the breaker opens after 3 refused dials: the 4th fails without dialing
    assert "circuit open" in messages[3] and "circuit open" not in messages[2]
    assert local[1] is None and local[2] == os.getpid()  # ran here, not under the server
    failed = _failures(events)
    assert [e["fallback_local"] for e in failed] == [False] * 4 + [True]


def test_addressing_and_preflight_follow_the_reference(tmp_path, sshd):
    from covalent_tpu_plugin import TPUExecutor

    common = dict(transport="ssh", workers=["alice@w0:2222", "w1", "fe80::1"],
                  ssh_key_file=str(sshd.key_file), cache_dir=str(tmp_path / "cache"),
                  remote_cache="/abs/cache", python_path="/py/python3", use_agent=False,
                  conda_env="env one")
    ours, theirs = GPUExecutor(**common), TPUExecutor(**common)
    assert ours._worker_addresses() == theirs._worker_addresses()
    assert ours._coordinator_address() == theirs._coordinator_address() == "w0:8476"
    for address in common["workers"]:
        a, b = ours._make_transport(address), theirs._make_transport(address)
        assert (a.hostname, a.username, a.port, a.backend) == (
            b.hostname, b.username, b.port, b.backend)
    assert ours._preflight_command() == theirs._preflight_command()
    assert ours._pool_key("w1") == theirs._pool_key("w1") == "ssh:w1"
    with pytest.raises(ValueError, match="duplicate"):
        GPUExecutor(**{**common, "workers": ["w0", "w0"]})._worker_addresses()
    with pytest.raises(ValueError, match="hostname"):
        GPUExecutor(transport="ssh")._worker_addresses()
    with pytest.raises(ValueError, match="another host"):
        GPUExecutor(**{**common, "coordinator_port": 0})._coordinator_address()


def test_a_missing_key_file_is_refused_before_any_dial(tmp_path, sshd, run_async, events):
    ex = _executor(tmp_path, sshd, ssh_key_file=str(tmp_path / "nope"))
    with pytest.raises(RuntimeError, match="no SSH key file"):
        run_async(ex.run(where_am_i, [], {}, {"dispatch_id": "d", "node_id": 0}))
    assert not [e for e in events if e["type"] == "span" and e["name"] == "pool.connect"]
