"""The port's SSH transport, connection pool and circuit breaker against the
JAX package's.

* The ``auto`` backend ladder (asyncssh > the ``ssh`` binary > minissh)
  picks the same backend in both packages for the same installation.
* The OpenSSH argv (``_ssh_base``/``_scp_base``) is equal for the same
  settings.
* The dial's retry envelope: success after refusals, exhaustion and
  ``retry_connect=False``, on a fake ``ssh``/``scp`` on ``PATH`` (the
  reference's ``tests/test_ssh_transport.py`` tier), each package once.
* The asyncssh branch through a stub module: the same connect arguments,
  exec, scp shapes and process channel.
* ``TransportPool``: single-flight dials, the breaker gate, scoped discards.
* ``CircuitBreaker``: the same state transitions for the same failures,
  successes and clock in both packages.
* minissh is imported only when its backend opens: without
  ``cryptography`` the port imports and runs locally, and only that
  backend fails.
"""

from __future__ import annotations

import asyncio
import os
import stat
import subprocess
import sys
import types
from pathlib import Path

import pytest

from covalent_tpu_plugin import resilience as ref_resilience
from covalent_tpu_plugin.transport import pool as ref_pool
from covalent_tpu_plugin.transport import ssh as ref_ssh
from covalent_tpu_plugin_torch import resilience
from covalent_tpu_plugin_torch.obs import events as obs_events
from covalent_tpu_plugin_torch.transport import pool, ssh
from covalent_tpu_plugin_torch.transport.base import TransportError

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"port": ssh, "reference": ref_ssh}

FAKE_SSH = r"""#!/bin/sh
# A fake OpenSSH client: parse ssh's options, run the command here.
# While FAKE_SSH_FAIL_FILE holds a positive count, count down and exit 255
# (ssh's own connect-failure code).
if [ -n "$FAKE_SSH_FAIL_FILE" ] && [ -s "$FAKE_SSH_FAIL_FILE" ]; then
  n=$(cat "$FAKE_SSH_FAIL_FILE")
  if [ "$n" -gt 0 ]; then
    echo $((n - 1)) > "$FAKE_SSH_FAIL_FILE"
    echo "ssh: connect to host refused" >&2
    exit 255
  fi
fi
while [ $# -gt 0 ]; do
  case "$1" in
    -p|-o|-i) shift 2 ;;
    -*) shift ;;
    *) break ;;
  esac
done
shift
exec sh -c "$*"
"""

FAKE_SCP = r"""#!/bin/sh
while [ $# -gt 0 ]; do
  case "$1" in
    -P|-o|-i) shift 2 ;;
    -*) shift ;;
    *) break ;;
  esac
done
src="$1"; dst="$2"
case "$src" in *:*) src="${src#*:}" ;; esac
case "$dst" in *:*) dst="${dst#*:}" ;; esac
src=$(eval "printf %s $src"); dst=$(eval "printf %s $dst")
exec cp "$src" "$dst"
"""


@pytest.fixture()
def fake_ssh_bin(tmp_path, monkeypatch):
    """A fake ``ssh``/``scp`` pair ahead of ``PATH``."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    for name, body in (("ssh", FAKE_SSH), ("scp", FAKE_SCP)):
        path = bindir / name
        path.write_text(body)
        path.chmod(path.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    return bindir


@pytest.mark.parametrize("have_asyncssh,have_ssh", [(True, True), (True, False),
                                                    (False, True), (False, False)])
def test_the_auto_ladder_picks_as_the_reference_does(fake_ssh_bin, monkeypatch, have_asyncssh,
                                                     have_ssh):
    if not have_ssh:
        monkeypatch.setenv("PATH", "/nonexistent")
    picked = []
    for mod in (ssh, ref_ssh):
        monkeypatch.setattr(mod, "_HAVE_ASYNCSSH", have_asyncssh)
        t = mod.SSHTransport(hostname="h")
        picked.append((t.backend, t._use_asyncssh))
    want = "asyncssh" if have_asyncssh else "openssh" if have_ssh else "minissh"
    assert picked == [(want, have_asyncssh)] * 2
    # a pinned backend is kept whatever is installed
    assert ssh.SSHTransport(hostname="h", backend="minissh").backend == "minissh"
    with pytest.raises(ValueError, match="backend"):
        ssh.SSHTransport(hostname="h", backend="telnet")


@pytest.mark.parametrize("settings", [
    dict(),
    dict(username="u", ssh_key_file="/k", port=2222, strict_host_keys=False),
    dict(username="alice", port=22, strict_host_keys=True),
    dict(ssh_key_file="/keys/id ed25519", strict_host_keys=False),
])
def test_openssh_argv_equals_the_reference(settings):
    ours = ssh.SSHTransport(hostname="w0", **settings)
    theirs = ref_ssh.SSHTransport(hostname="w0", **settings)
    assert ours._ssh_base() == theirs._ssh_base()
    assert ours._scp_base() == theirs._scp_base()
    assert ours.address == theirs.address


@pytest.mark.parametrize("package", ["port", "reference"])
def test_the_dial_retries_refusals_then_connects(fake_ssh_bin, tmp_path, monkeypatch,
                                                 run_async, package):
    mod = PACKAGES[package]
    monkeypatch.setattr(mod, "_HAVE_ASYNCSSH", False)
    fail_file = tmp_path / "failcount"
    fail_file.write_text("2")
    monkeypatch.setenv("FAKE_SSH_FAIL_FILE", str(fail_file))
    retries = []
    obs_events.add_listener(retries.append)
    try:
        t = mod.SSHTransport(hostname="127.0.0.1")
        assert run_async(mod.connect_with_retries(t, max_attempts=5, retry_wait_time=0.01)) is t
        result = run_async(t.run("echo hello; echo oops >&2; exit 3"))
    finally:
        obs_events.remove_listener(retries.append)
    assert (result.exit_status, result.stdout.strip(), result.stderr.strip()) == (
        3, "hello", "oops")
    if package == "port":
        assert [e["attempt"] for e in retries if e["type"] == "transport.retry"] == [1, 2]


@pytest.mark.parametrize("package", ["port", "reference"])
def test_the_dial_gives_up_after_its_attempts(fake_ssh_bin, tmp_path, monkeypatch, run_async,
                                              package):
    mod = PACKAGES[package]
    monkeypatch.setattr(mod, "_HAVE_ASYNCSSH", False)
    fail_file = tmp_path / "failcount"
    fail_file.write_text("99")
    monkeypatch.setenv("FAKE_SSH_FAIL_FILE", str(fail_file))
    t = mod.SSHTransport(hostname="127.0.0.1")
    with pytest.raises(Exception, match="after 3 attempts") as caught:
        run_async(mod.connect_with_retries(t, max_attempts=3, retry_wait_time=0.01))
    assert type(caught.value).__name__ == "TransportError"
    assert fail_file.read_text().strip() == "96"


@pytest.mark.parametrize("package", ["port", "reference"])
def test_retry_connect_false_raises_at_once(fake_ssh_bin, tmp_path, monkeypatch, run_async,
                                            package):
    mod = PACKAGES[package]
    monkeypatch.setattr(mod, "_HAVE_ASYNCSSH", False)
    fail_file = tmp_path / "failcount"
    fail_file.write_text("9")
    monkeypatch.setenv("FAKE_SSH_FAIL_FILE", str(fail_file))
    t = mod.SSHTransport(hostname="127.0.0.1")
    with pytest.raises(ConnectionRefusedError):
        run_async(mod.connect_with_retries(t, max_attempts=5, retry_wait_time=0.01,
                                           retry_connect=False))
    assert fail_file.read_text().strip() == "8"  # exactly one attempt


def test_openssh_put_get_and_a_process(fake_ssh_bin, tmp_path, monkeypatch, run_async):
    monkeypatch.setattr(ssh, "_HAVE_ASYNCSSH", False)
    (tmp_path / "src.txt").write_text("payload")

    async def flow():
        t = ssh.SSHTransport(hostname="127.0.0.1", strict_host_keys=False)
        await ssh.connect_with_retries(t, max_attempts=1)
        await t.put(str(tmp_path / "src.txt"), str(tmp_path / "up.txt"))
        await t.get(str(tmp_path / "up.txt"), str(tmp_path / "down.txt"))
        proc = await t.start_process("while read line; do echo got:$line; done")
        await proc.write_line("ping")
        line = await proc.read_line(timeout=10)
        await proc.close()
        with pytest.raises(TransportError, match="scp upload failed"):
            await t.put(str(tmp_path / "missing"), str(tmp_path / "x"))
        await t.close()
        with pytest.raises(TransportError, match="closed"):
            await t.run("true")
        return line

    assert run_async(flow()) == "got:ping"
    assert (tmp_path / "down.txt").read_text() == "payload"


def _stub_asyncssh(calls: list):
    """An asyncssh stand-in that records what the transport asks of it."""

    class Completed:
        exit_status, stdout, stderr = 0, "ran", ""

    class Process:
        exit_status = None

        def __init__(self):
            self.stdout = asyncio.StreamReader()
            self.stdin = types.SimpleNamespace(write=lambda data: None, close=lambda: None)

    class Conn:
        async def run(self, command):
            calls.append(("run", command))
            return Completed()

        async def create_process(self, command, encoding=None):
            calls.append(("create_process", command, encoding))
            return Process()

        def close(self):
            calls.append(("close",))

        async def wait_closed(self):
            calls.append(("wait_closed",))

    async def connect(host, **kwargs):
        calls.append(("connect", host, tuple(sorted(kwargs.items()))))
        return Conn()

    async def scp(src, dst):
        calls.append(("scp", src if isinstance(src, str) else src[1],
                      dst if isinstance(dst, str) else dst[1]))

    return types.SimpleNamespace(connect=connect, scp=scp, ConnectionLost=ConnectionError)


@pytest.mark.parametrize("strict", [True, False])
def test_the_asyncssh_branch_asks_what_the_reference_asks(monkeypatch, run_async, strict):
    seen = []
    for mod in (ssh, ref_ssh):
        calls: list = []
        monkeypatch.setattr(mod, "asyncssh", _stub_asyncssh(calls))
        monkeypatch.setattr(mod, "_HAVE_ASYNCSSH", True)

        async def flow():
            t = mod.SSHTransport(hostname="w0", username="u", ssh_key_file="/k", port=2200,
                                 strict_host_keys=strict)
            await mod.connect_with_retries(t, max_attempts=1)
            result = await t.run("hostname")
            await t.put("/local/a", "/remote/a")
            await t.get("/remote/b", "/local/b")
            await t.start_process("harness --serve")
            await t.close()
            return result.stdout

        assert run_async(flow()) == "ran"
        seen.append(calls)
    assert seen[0] == seen[1]
    connect = seen[0][0]
    assert connect[1] == "w0" and (("known_hosts", None) in connect[2]) is (not strict)
    # an explicit host-key pin is refused on asyncssh (it pins through known_hosts)
    monkeypatch.setattr(ssh, "_HAVE_ASYNCSSH", True)
    pinned = ssh.SSHTransport(hostname="w0", known_host_key="/host.pub")
    with pytest.raises(TransportError, match="known_hosts"):
        run_async(pinned._open())


class _Fake:
    def __init__(self, n):
        self.n = n
        self.closed = False

    async def close(self):
        self.closed = True


def test_the_pool_dials_once_and_discards_only_what_failed(run_async):
    async def flow():
        p = pool.TransportPool()
        dials = []

        async def factory():
            dials.append(1)
            await asyncio.sleep(0.01)
            return _Fake(len(dials))

        first = await asyncio.gather(*(p.acquire("k", factory) for _ in range(5)))
        assert len(dials) == 1 and all(t is first[0] for t in first)
        stale = _Fake(-1)
        assert await p.discard("k", only=[stale]) is False  # someone else's channel stays
        assert await p.discard("k", only=[first[0]]) is True and first[0].closed
        second = await p.acquire("k", factory)
        assert second.n == 2 and p.has("k") and len(p) == 1
        await p.close_all()
        return second.closed, len(p)

    assert run_async(flow()) == (True, 0)


def test_the_pool_gate_fails_fast_once_the_breaker_opens(run_async):
    clock = [0.0]
    breaker = resilience.CircuitBreaker("w0", failure_threshold=2, cooldown=30.0,
                                        clock=lambda: clock[0])

    async def refused():
        raise ConnectionRefusedError("no")

    async def flow():
        p = pool.TransportPool()
        for _ in range(2):
            with pytest.raises(ConnectionRefusedError):
                await p.acquire("k", refused, gate=breaker)
        with pytest.raises(resilience.CircuitOpenError) as caught:
            await p.acquire("k", refused, gate=breaker)
        clock[0] = 31.0  # the cooldown passed: one probe goes through

        async def ok():
            return _Fake(1)

        return caught.value, await p.acquire("k", ok, gate=breaker)

    error, transport = run_async(flow())
    assert resilience.classify_error(error) == (resilience.FaultClass.TRANSIENT, "circuit_open")
    assert transport.n == 1 and breaker.state is resilience.CircuitState.CLOSED


def test_the_pool_counts_its_hits_and_misses_as_the_reference(run_async):
    async def flow(mod):
        p = mod.TransportPool()

        async def factory():
            return _Fake(0)

        before = {r: mod._POOL_ACQUIRES.labels(result=r).value for r in ("hit", "miss")}
        for key in ("a", "a", "b", "a"):
            await p.acquire(key, factory)
        await p.close_all()
        return {r: mod._POOL_ACQUIRES.labels(result=r).value - before[r] for r in before}

    assert run_async(flow(pool)) == run_async(flow(ref_pool)) == {"hit": 2, "miss": 2}


@pytest.mark.parametrize("script", [
    "fffsfff", "ffftfffts", "fffttf tst", "sfsfsfs", "ffff t f t s f",
])
def test_the_breaker_moves_as_the_reference_does(script):
    """``f`` a failure, ``s`` a success, ``t`` 31 s on the clock, ``c`` a
    check: after each, both breakers are in the same state and agree on
    whether a check fails fast."""
    clock = [0.0]
    breakers = [mod.CircuitBreaker("w", failure_threshold=3, cooldown=30.0,
                                   clock=lambda: clock[0])
                for mod in (resilience, ref_resilience)]
    trail = []
    for step in script.replace(" ", "c"):
        if step == "t":
            clock[0] += 31.0
        outcomes = []
        for breaker in breakers:
            if step == "f":
                breaker.record_failure()
            elif step == "s":
                breaker.record_success()
            elif step == "c":
                try:
                    breaker.check()
                    outcomes.append("pass")
                except Exception as err:  # each package's CircuitOpenError
                    outcomes.append(type(err).__name__)
            outcomes.append(breaker.state.value)
        trail.append(outcomes)
        assert outcomes[: len(outcomes) // 2] == outcomes[len(outcomes) // 2:], trail
    registry = resilience.CircuitBreakerRegistry(failure_threshold=1)
    registry.get("a").record_failure()
    assert registry.states() == {"a": "open"} and registry.get("a") is registry.get("a")


def test_minissh_is_imported_only_where_it_is_used(tmp_path):
    """With ``cryptography`` unimportable, the port and its executor still
    import and run on the local transport; only the minissh backend fails,
    naming what it lacks."""
    script = r"""
import asyncio, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "cryptography":
            raise ModuleNotFoundError("No module named 'cryptography'")
sys.meta_path.insert(0, Refuse())
import covalent_tpu_plugin_torch, covalent_tpu_plugin_torch.gpu
from covalent_tpu_plugin_torch.transport import LocalTransport, SSHTransport
assert "covalent_tpu_plugin_torch.transport.minissh" not in sys.modules
print(asyncio.run(LocalTransport().run("echo local")).stdout.strip())
t = SSHTransport(hostname="127.0.0.1", backend="minissh", strict_host_keys=False)
try:
    asyncio.run(t._open())
except ImportError as err:
    print("minissh:", err)
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == [
        "local", "minissh: the minissh backend needs the `cryptography` package (No module "
        "named 'cryptography'); install it, or use backend='asyncssh'/'openssh'"]
