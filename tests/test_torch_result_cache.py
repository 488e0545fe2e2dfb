"""The port's result cache and the worker CAS's prunes against the JAX
package's, on the CPU.

``ResultCache`` (its keys, bounds, corrupt and unpicklable entries), the
executor's memoization on both roads through ``GPUExecutor(transport=
"local")`` with real harness subprocesses (a hit touches no transport, any
fingerprint field, the arguments or the function's code is a miss, a
remote exception is never stored, the two roads never serve each other's
entries), the keys equal to the reference executor's on the same settings,
and the CAS's upkeep: the TTL clause in the pre-flight, the touch-then-prune
maintenance after each launched electron, and the byte budget, whose local
and remote forms evict the same files as the reference's ``prune_cas_dir``
on trees built from a seed.  The cases follow ``tests/test_cache.py``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from covalent_tpu_plugin import cache as jax_cache
from covalent_tpu_plugin import TPUExecutor
from covalent_tpu_plugin_torch import GPUExecutor
from covalent_tpu_plugin_torch import cache as cache_mod
from covalent_tpu_plugin_torch import harness as harness_mod
from covalent_tpu_plugin_torch.cache import (
    RESULT_CACHE_TOTAL,
    CASIndex,
    ResultCache,
    cas_bytes_prune_command,
    file_digest,
    harness_digest,
    prune_cas_dir,
)
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.transport import LocalTransport

REPO = Path(__file__).resolve().parent.parent
METADATA = {"dispatch_id": "d123", "node_id": 1}


def counter_value(counter, **labels) -> float:
    return counter.labels(**labels).value


def _executor(tmp_path, **kwargs) -> GPUExecutor:
    kwargs.setdefault("use_agent", False)
    return GPUExecutor(
        transport="local", cache_dir=str(tmp_path / "cache"),
        remote_cache=str(tmp_path / "remote"), remote_workdir=str(tmp_path / "work"),
        python_path=sys.executable, poll_freq=0.05, pool_preload="cloudpickle",
        task_env={"PYTHONPATH": str(REPO)}, **kwargs)


class Traffic:
    """Every control-plane operation any executor makes: channel acquires
    and the local transport's commands and file moves."""

    def __init__(self, monkeypatch) -> None:
        self.ops: list = []
        for name in ("run", "put", "get", "remove", "exists_batch", "put_bundle"):
            real = getattr(LocalTransport, name)

            def spy(conn, *args, _real=real, _name=name, **kwargs):
                self.ops.append(_name)
                return _real(conn, *args, **kwargs)

            monkeypatch.setattr(LocalTransport, name, spy)
        real_connect = GPUExecutor._client_connect

        def connect(ex, address, _real=real_connect):
            self.ops.append("connect")
            return _real(ex, address)

        monkeypatch.setattr(GPUExecutor, "_client_connect", connect)


class Events:
    def __init__(self) -> None:
        self.events: list = []

    def __enter__(self):
        obs_events.add_listener(self.events.append)
        return self

    def __exit__(self, *exc):
        obs_events.remove_listener(self.events.append)

    def of(self, kind: str) -> list:
        return [e for e in self.events if e.get("type") == kind]

    def spans(self, name: str) -> list:
        return [e for e in self.events if e.get("type") == "span" and e.get("name") == name]


# --------------------------------------------------------------------------
# ResultCache


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_key_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    parts = [bytes(rng.integers(32, 127, int(rng.integers(0, 40)), dtype=np.uint8)).decode()
             for _ in range(int(rng.integers(1, 5)))]
    assert ResultCache.make_key(*parts) == jax_cache.ResultCache.make_key(*parts)
    assert ResultCache.make_key(*parts) != ResultCache.make_key(*parts, "")


def test_result_cache_roundtrip_and_miss(tmp_path):
    cache = ResultCache(str(tmp_path / "rc"))
    key = ResultCache.make_key("fn", "args", "env")
    assert cache.get(key) == (False, None)
    assert cache.put(key, {"loss": 0.25})
    assert cache.get(key) == (True, {"loss": 0.25})


def test_result_cache_entry_bound_evicts_oldest(tmp_path):
    cache = ResultCache(str(tmp_path / "rc"), max_entries=2)
    evicted0 = counter_value(RESULT_CACHE_TOTAL, result="evict")
    keys = [ResultCache.make_key("fn", str(i), "env") for i in range(3)]
    for i, key in enumerate(keys):
        cache.put(key, i)
        path = cache._path(key)
        if os.path.exists(path):  # mtime is the LRU clock: oldest first
            stamp = time.time() - 10 + i
            os.utime(path, (stamp, stamp))
    assert len(cache) == 2
    assert cache.get(keys[0])[0] is False
    assert cache.get(keys[2]) == (True, 2)
    assert counter_value(RESULT_CACHE_TOTAL, result="evict") - evicted0 >= 1


def test_result_cache_byte_bound(tmp_path):
    cache = ResultCache(str(tmp_path / "rc"), max_entries=100, max_bytes=64)
    key = ResultCache.make_key("fn", "big", "env")
    before = counter_value(RESULT_CACHE_TOTAL, result="oversize")
    assert cache.put(key, "x" * 10_000) is False
    assert cache.get(key)[0] is False
    assert counter_value(RESULT_CACHE_TOTAL, result="oversize") == before + 1


def test_result_cache_unpicklable_value_is_counted_not_fatal(tmp_path):
    import socket

    cache = ResultCache(str(tmp_path / "rc"))
    before = counter_value(RESULT_CACHE_TOTAL, result="unpicklable")
    sock = socket.socket()
    try:
        assert cache.put("k2", sock) is False
    finally:
        sock.close()
    assert counter_value(RESULT_CACHE_TOTAL, result="unpicklable") == before + 1


def test_result_cache_corrupt_entry_is_a_miss(tmp_path):
    cache = ResultCache(str(tmp_path / "rc"))
    key = ResultCache.make_key("fn", "args", "env")
    cache.put(key, 42)
    with open(cache._path(key), "wb") as f:
        f.write(b"\x80garbage")
    assert cache.get(key) == (False, None)


# --------------------------------------------------------------------------
# The executor's memoization


@pytest.mark.parametrize("mode", ["launch", "rpc"])
def test_a_repeat_is_served_ahead_of_the_connect(tmp_path, monkeypatch, run_async, mode):
    """The first electron runs in a worker; the identical second one is a
    hit: the same value, no control-plane operation at all, the
    ``executor.cache_lookup`` span, ``task.result_cached`` and the
    ``cached`` outcome."""
    ex = _executor(tmp_path, cache_results=True,
                   use_agent="pool" if mode == "rpc" else False)
    traffic = Traffic(monkeypatch)
    scale = 3.0

    def fn(x):
        import os as os_mod

        return {"y": x * scale, "pid": os_mod.getpid()}

    meta = {**METADATA, "dispatch_mode": mode}

    async def flow():
        try:
            first = await ex.run(fn, [2], {}, meta)
            road = ex.last_dispatch_mode
            before = len(traffic.ops)
            with Events() as log:
                second = await ex.run(fn, [2], {}, meta)
            return first, road, second, traffic.ops[before:], log, dict(ex.last_timings)
        finally:
            await ex.close()

    hits0 = counter_value(RESULT_CACHE_TOTAL, result="hit")
    first, road, second, ops, log, timings = run_async(flow())
    assert road == mode and first["pid"] != os.getpid()
    assert second == first and ops == []
    assert counter_value(RESULT_CACHE_TOTAL, result="hit") == hits0 + 1
    assert len(log.of("task.result_cached")) == 1
    assert [e["state"] for e in log.of("task.state")][-1] == "cached"
    assert log.spans("executor.cache_lookup") and not log.spans("executor.connect")
    assert "cache_lookup" in timings and timings["overhead"] >= 0.0


def test_arguments_are_part_of_the_key(tmp_path, run_async):
    ex = _executor(tmp_path, cache_results=True)
    with Events() as log:
        async def flow():
            try:
                return [await ex.run(lambda x: x + 1, [i], {}, {**METADATA, "node_id": i})
                        for i in (1, 2, 1)]
            finally:
                await ex.close()

        assert run_async(flow()) == [2, 3, 2]
    assert len(log.of("task.result_cached")) == 1  # only the third


def test_a_remote_exception_is_never_memoised(tmp_path, run_async):
    ex = _executor(tmp_path, cache_results=True)

    def boom():
        raise KeyError("boom")

    async def flow():
        try:
            for node in (0, 1):
                with pytest.raises(KeyError):
                    await ex.run(boom, [], {}, {**METADATA, "node_id": node})
        finally:
            await ex.close()

    with Events() as log:
        run_async(flow())
    assert not log.of("task.result_cached")
    assert len(ex._result_cache) == 0


@pytest.mark.parametrize("env,expected", [("1", True), ("0", False), (None, False)])
def test_cache_results_from_the_environment(tmp_path, monkeypatch, env, expected):
    if env is None:
        monkeypatch.delenv("COVALENT_TPU_RESULT_CACHE", raising=False)
    else:
        monkeypatch.setenv("COVALENT_TPU_RESULT_CACHE", env)
    ex = _executor(tmp_path)
    assert ex.cache_results is expected and (ex._result_cache is not None) is expected
    assert ex.cache_results == TPUExecutor(transport="local",
                                           cache_dir=str(tmp_path / "c")).cache_results


@pytest.mark.parametrize("field,value", [
    ("transport", "minissh"), ("python_path", "/usr/bin/python3.11"),
    ("conda_env", "env-b"), ("task_env", {"PYTHONPATH": "/elsewhere"}),
    ("pip_deps", ["scikit-learn"]), ("workers", ["w0", "w1"]), ("workdir", "/other")])
def test_every_fingerprint_field_splits_the_key(tmp_path, field, value):
    settings = dict(transport="local", cache_dir=str(tmp_path / "cache"),
                    remote_workdir="/wd", python_path=sys.executable,
                    task_env={"PYTHONPATH": str(REPO)}, cache_results=True)
    fn = lambda: 1  # noqa: E731
    base = GPUExecutor(**settings)
    key = base._result_cache_key(fn, (), {}, dict(METADATA))
    assert key == base._result_cache_key(fn, (), {}, dict(METADATA))
    meta = dict(METADATA)
    if field == "pip_deps":
        meta["pip_deps"] = value
        other = base
    else:
        changed = {"workdir": {"remote_workdir": value},
                   "transport": {"transport": value, "hostname": "user@host"}}.get(
                       field, {field: value})
        other = GPUExecutor(**{**settings, **changed})
    assert other._result_cache_key(fn, (), {}, meta) != key


def test_the_function_code_is_part_of_the_key(tmp_path):
    """A function pickled by reference keeps its payload bytes when its
    body changes; the code digest still splits the keys."""
    ex = _executor(tmp_path, cache_results=True)

    def f1():
        return 1

    def f2():
        return 2

    same = b"identical-bytes"
    k1 = ex._result_cache_key(f1, (), {}, {}, payload=same)
    assert k1 != ex._result_cache_key(f2, (), {}, {}, payload=same)
    assert k1 == ex._result_cache_key(f1, (), {}, {}, payload=same)
    import functools

    assert ex._result_cache_key(functools.partial(f1), (), {}, {}, payload=b"x") is not None
    assert ex._fn_code_digest(functools.partial(f1)) == ""


def test_the_keys_equal_the_reference_executors(tmp_path):
    """On the same settings, function and arguments, both roads' keys are
    the JAX package executor's."""
    settings = dict(transport="local", cache_dir=str(tmp_path / "cache"),
                    remote_workdir="/wd", python_path="/py/python3",
                    task_env={"A": "1"}, conda_env="e", cache_results=True)
    ours, theirs = GPUExecutor(**settings), TPUExecutor(**settings)
    factor = 7

    def fn(x, y=1):
        return x * factor + y

    meta = {**METADATA, "pip_deps": ["numpy"]}
    assert ours._result_cache_key(fn, (3,), {"y": 2}, meta) == \
        theirs._result_cache_key(fn, (3,), {"y": 2}, meta)
    assert ours._fn_code_digest(fn) == theirs._fn_code_digest(fn)
    assert ours._rpc_result_cache_key(fn, "a" * 64, "b" * 64, meta) == \
        theirs._rpc_result_cache_key(fn, "a" * 64, "b" * 64, meta)
    assert ours._rpc_result_cache_key(fn, "a" * 64, "b" * 64, meta) != \
        ours._result_cache_key(fn, (3,), {"y": 2}, meta)


def test_the_store_is_shared_by_executors_on_one_cache_dir(tmp_path, monkeypatch, run_async):
    """A workflow builds a fresh executor per dispatch from an alias: the
    store under ``cache_dir`` is what the second one hits."""
    traffic = Traffic(monkeypatch)
    fn = lambda: 7  # noqa: E731

    async def flow(ex):
        try:
            return await ex.run(fn, [], {}, dict(METADATA))
        finally:
            await ex.close()

    assert run_async(flow(_executor(tmp_path, cache_results=True))) == 7
    before = len(traffic.ops)
    assert run_async(flow(_executor(tmp_path, cache_results=True))) == 7
    assert traffic.ops[before:] == []


def test_the_roads_never_serve_each_others_entries(tmp_path, run_async):
    """A result stored by the launch road is a miss on the RPC road and the
    reverse: each road runs its electron once, then hits its own entry."""
    ex = _executor(tmp_path, cache_results=True, use_agent="pool")
    fn = lambda: 11  # noqa: E731

    async def flow():
        roads = []
        try:
            for mode in ("launch", "rpc", "launch", "rpc"):
                await ex.run(fn, [], {}, {**METADATA, "dispatch_mode": mode})
                roads.append(ex.last_dispatch_mode)
        finally:
            await ex.close()
        return roads

    with Events() as log:
        assert run_async(flow()) == ["launch", "rpc", "launch", "rpc"]
    assert len(log.of("task.result_cached")) == 2


# --------------------------------------------------------------------------
# The worker CAS: TTL, maintenance, byte budget


@pytest.mark.parametrize("hours", [0, 0.001, 2, 168.0, 1e4])
def test_the_ttl_clause_and_the_preflight_equal_the_references(tmp_path, hours):
    settings = dict(transport="local", cache_dir=str(tmp_path / "c"),
                    remote_cache="/abs/cache", python_path="/py/python3", cas_ttl_hours=hours)
    ours, theirs = GPUExecutor(**settings), TPUExecutor(**settings)
    assert ours._cas_prune_clause() == theirs._cas_prune_clause()
    assert ours._preflight_command() == theirs._preflight_command()
    command = ours._preflight_command()
    if hours > 0:
        minutes = max(1, int(hours * 60))
        assert f"-mmin +{minutes}" in command and "|| true" in command
    else:
        assert "find" not in command
    assert command.rstrip().endswith("sys.version_info[0])'")


@pytest.mark.parametrize("ttl,budget", [(1.0, 0), (0, 0), (0, 12345), (168.0, 4096)])
def test_the_maintenance_command_equals_the_references(tmp_path, ttl, budget):
    settings = dict(transport="local", cache_dir=str(tmp_path / "c"),
                    remote_cache="/abs/cache", python_path="/py/python3",
                    cas_ttl_hours=ttl, cas_max_bytes=budget)
    staged = SimpleNamespace(remote_function_file="/abs/cache/cas/f.pkl",
                             remote_harness_file="/abs/cache/cas/h.py")
    ours = GPUExecutor(**settings)._cas_maintenance_command(staged)
    assert ours == TPUExecutor(**settings)._cas_maintenance_command(staged)
    assert ours.startswith("touch -c") and ours.rstrip().endswith("true")
    assert ("find" in ours) is (ttl > 0)
    assert ("CAS_EVICTED" in ours) is (budget > 0)
    if budget:
        assert ours.index("touch -c") < ours.index("CAS_EVICTED")


def test_cleanup_keeps_the_cas_artifacts_and_maintains_them(tmp_path, monkeypatch, run_async):
    """After a launched electron the worker's CAS holds the harness and the
    function pickle under their digests, the index knows both, and one
    maintenance round trip touched both before its prune."""
    ex = _executor(tmp_path, cas_ttl_hours=1)
    commands: list = []
    real = LocalTransport.run

    async def spy(conn, command, *args, **kwargs):
        commands.append(command)
        return await real(conn, command, *args, **kwargs)

    monkeypatch.setattr(LocalTransport, "run", spy)
    staged = {}
    stage = ex._write_function_files

    def keep(*args, **kwargs):
        staged["task"] = stage(*args, **kwargs)
        return staged["task"]

    ex._write_function_files = keep

    async def flow():
        try:
            return await ex.run(lambda: 1, [], {}, dict(METADATA))
        finally:
            await ex.close()

    assert run_async(flow()) == 1
    task = staged["task"]
    held = sorted(p.name for p in (tmp_path / "remote" / "cas").iterdir())
    assert held == sorted([f"{task.function_digest}.pkl", f"{harness_digest()}.py"])
    assert file_digest(task.remote_function_file) == task.function_digest
    maintenance = [c for c in commands if c.startswith("touch -c")]
    assert len(maintenance) == 1
    assert task.remote_function_file in maintenance[0]
    assert task.remote_harness_file in maintenance[0] and "-mmin +60" in maintenance[0]


def _tree(root: Path, seed: int) -> int:
    """A CAS directory of files with seeded sizes and ages; returns its
    total bytes."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    now = time.time()
    total = 0
    ages = rng.permutation(20) * 60.0
    for i in range(20):
        size = int(rng.integers(10, 5000))
        path = root / f"{i:02d}{'.pkl' if i % 3 else '.kv'}"
        path.write_bytes(b"z" * size)
        os.utime(path, (now - 5000 + ages[i], now - 5000 + ages[i]))
        total += size
    return total


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_both_byte_prunes_evict_what_the_reference_evicts(tmp_path, seed):
    total = _tree(tmp_path / "a", seed)
    budget = int(np.random.default_rng(100 + seed).integers(0, total))
    for name in ("b", "c"):
        shutil.copytree(tmp_path / "a", tmp_path / name)
        for src in (tmp_path / "a").iterdir():
            stat = src.stat()
            os.utime(tmp_path / name / src.name, (stat.st_atime, stat.st_mtime))
    want = jax_cache.prune_cas_dir(str(tmp_path / "a"), budget)
    assert prune_cas_dir(str(tmp_path / "b"), budget) == want
    out = subprocess.run(["sh", "-c", cas_bytes_prune_command(sys.executable,
                                                              str(tmp_path / "c"), budget)],
                         capture_output=True, text=True, check=True)
    assert f"CAS_EVICTED={want}" in out.stdout
    left = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert want > 0
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == left
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == left
    assert prune_cas_dir(str(tmp_path / "b"), 0) == 0


def test_the_byte_budget_runs_after_each_electron_and_spares_the_hot_artifacts(
        tmp_path, run_async):
    """Electrons with distinct 64 KiB arguments, a budget of the harness and
    100 KiB: each electron's maintenance evicts the earlier pickles
    (``CAS_EVICTED``, counted on the remote site), the harness and the
    running electron's pickle survive, and the first electron run again,
    whose pickle was evicted while its channel's index still named it, ships
    it again and runs."""
    budget = Path(harness_mod.__file__).stat().st_size + 100 * 1024
    ex = _executor(tmp_path, cas_max_bytes=budget)
    remote_cas = tmp_path / "remote" / "cas"
    counter = cache_mod.CAS_EVICTIONS_TOTAL.labels(site="remote")
    before = counter.value
    fn = lambda b: len(b) + b[0]  # noqa: E731

    async def flow():
        out = []
        try:
            for i in (0, 1, 2, 0):
                out.append(await ex.run(fn, [bytes([i]) * (64 * 1024)], {},
                                        {**METADATA, "node_id": len(out)}))
                out.append(sorted(p.suffix for p in remote_cas.iterdir()))
        finally:
            await ex.close()
        return out

    with Events() as log:
        out = run_async(flow())
    assert out[0::2] == [65536, 65537, 65538, 65536]
    assert all(held == [".pkl", ".py"] for held in out[1::2])
    pruned = [e["evicted"] for e in log.of("cas.bytes_pruned") if e.get("site") == "remote"]
    assert pruned == [1, 1, 1] and counter.value - before == 3


def test_the_index_knows_holds_and_forgets_a_digest(tmp_path, run_async):
    index = CASIndex()
    local = tmp_path / "spec.json"
    local.write_bytes(b"{}")
    digest = file_digest(str(local))
    remote = tmp_path / "rc" / "cas"
    remote.mkdir(parents=True)

    async def flow():
        conn = LocalTransport()
        await index.ensure("k1", conn, digest, str(local), str(remote / "s.json"))
        await index.ensure("k2", conn, digest, str(local), str(remote / "s.json"))

    run_async(flow())
    assert index.known("k1", digest) and index.known("k2", digest) and index.holds(digest)
    index.forget_digest(digest)
    assert not index.known("k1", digest) and not index.holds(digest)
    assert hashlib.sha256((remote / "s.json").read_bytes()).hexdigest() == digest
