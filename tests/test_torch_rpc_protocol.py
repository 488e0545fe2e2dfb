"""The port's task and RPC verbs against the reference's, on one command script.

``python covalent_tpu_plugin/harness.py --serve`` and the port's
``python covalent_tpu_plugin_torch/harness.py --serve`` run as subprocesses
(``tests/test_torch_session_protocol.py``'s runner) and are fed the same
lines: ``register_fn`` (good, again, digest mismatch, missing artifact,
no path), ``invoke`` (inline args, args staged by path, torn staged args,
unregistered, self-healed from its path, raising, result staged by size,
no id), ``run`` and its ``exit``, ``run`` without a spec, ``kill`` of a
running and of an unknown task, ``watch``/``unwatch`` of a task file,
``task_inventory``, and ``shutdown``.  Each step waits for its answer, so
both runtimes see the same order.  They must answer with the same events:
only pids, timestamps and seq values may differ, and a result's pickle is compared by its value (the
port's also carries the electron's start and end times, as its launch-mode
result file does).

The script runs on JSON lines and again on negotiated binary frames
(``frames`` arm): there the args ride frame bodies, results come back as
frames, the invocations' records in ``telemetry_batch`` frames, and three
more steps send ``multi_invoke`` frames (three ops of one digest, a body
whose lengths do not add up, an unregistered digest).  A run of results of
ops that run at once is compared in the order of their ids.
"""

import base64
import hashlib
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path

import cloudpickle
import pytest

from .test_torch_session_protocol import RUNTIMES, VOLATILE, WAIT_S, Runtime, is_event



def _fn(kind):
    """Closure-local functions: cloudpickle ships them by value."""
    if kind == "square":
        def fn(x):
            return x * x
    elif kind == "concat":
        def fn(a, b="!"):
            return f"{a}{b}"
    elif kind == "boom":
        def fn():
            raise ValueError("rpc-protocol-boom")
    elif kind == "big":
        def fn(n):
            return "y" * n
    elif kind == "marked_sleep":
        def fn(seconds, marker):
            import time

            open(marker, "w").close()  # the electron runs: a kill now ends it
            time.sleep(seconds)
            return seconds
    else:
        def fn(seconds):
            import time

            time.sleep(seconds)
            return seconds
    return fn


def _artifact(root: Path, fn) -> tuple[str, str]:
    payload = cloudpickle.dumps(fn)
    digest = hashlib.sha256(payload).hexdigest()
    path = root / f"{digest}.pkl"
    path.write_bytes(payload)
    return digest, str(path)


def _args(*args, **kwargs) -> bytes:
    return cloudpickle.dumps((args, kwargs))


def _spec(root: Path, name: str, fn, args) -> str:
    fn_file = root / f"fn_{name}.pkl"
    fn_file.write_bytes(cloudpickle.dumps((fn, tuple(args), {})))
    spec = root / f"spec_{name}.json"
    spec.write_text(json.dumps({"function_file": str(fn_file),
                                "result_file": str(root / f"result_{name}.pkl")}))
    return str(spec)


def run_script(rt: Runtime, root: Path) -> None:
    def step(command, predicate, count=1):
        rt.send(command)
        rt.wait(predicate, count)

    def answered(kind, key, value):
        return lambda e: e.get("event") == kind and e.get(key) == value

    def result_of(op):
        return answered("result", "id", op)

    square, square_path = _artifact(root, _fn("square"))
    concat, concat_path = _artifact(root, _fn("concat"))
    boom, boom_path = _artifact(root, _fn("boom"))
    big, big_path = _artifact(root, _fn("big"))
    heal, heal_path = _artifact(root, _fn("sleep"))
    args_file = root / "args.pkl"
    args_file.write_bytes(cloudpickle.dumps(((7,), {"b": "?"})))
    args_digest = hashlib.sha256(args_file.read_bytes()).hexdigest()

    rt.wait(is_event("ready"))
    step({"cmd": "register_fn", "digest": square, "path": square_path},
         answered("registered", "digest", square))
    step({"cmd": "register_fn", "digest": square, "path": square_path},     # idempotent
         answered("registered", "digest", square), 2)
    step({"cmd": "register_fn", "digest": "0" * 64, "path": square_path},   # mismatch
         answered("register_error", "digest", "0" * 64))
    step({"cmd": "register_fn", "digest": "1" * 64, "path": str(root / "gone.pkl")},
         answered("register_error", "digest", "1" * 64))                    # missing
    step({"cmd": "register_fn", "digest": square}, is_event("error"))       # no path
    for digest, path in ((concat, concat_path), (boom, boom_path), (big, big_path)):
        step({"cmd": "register_fn", "digest": digest, "path": path},
             answered("registered", "digest", digest))

    step({"cmd": "invoke", "id": "i1", "digest": square, "args_bytes": _args(6)}, result_of("i1"))
    step({"cmd": "invoke", "id": "i2", "digest": concat, "args_path": str(args_file),
          "args_digest": args_digest}, result_of("i2"))
    step({"cmd": "invoke", "id": "i2b", "digest": concat, "args_path": str(args_file),
          "args_digest": "2" * 64}, result_of("i2b"))                       # torn args
    step({"cmd": "invoke", "id": "i3", "digest": "3" * 64, "args_bytes": _args(1)},
         answered("error", "id", "i3"))                                     # unregistered
    step({"cmd": "invoke", "id": "i4", "digest": heal, "path": heal_path,
          "args_bytes": _args(0.01)}, result_of("i4"))                            # self-heal
    step({"cmd": "invoke", "id": "i5", "digest": boom, "args_bytes": _args()}, result_of("i5"))
    step({"cmd": "invoke", "id": "i6", "digest": big, "args_bytes": _args(5000),
          "result_path": str(root / "staged_result.pkl"), "result_max_inline": 1024},
         result_of("i6"))                                                   # staged result
    step({"cmd": "invoke", "digest": square, "args_bytes": _args(1)}, is_event("error"), 3)

    step({"cmd": "run", "id": "r1", "spec": _spec(root, "r1", _fn("square"), (5,)),
          "log": str(root / "r1.log")}, answered("exit", "id", "r1"))
    step({"cmd": "run", "id": "r0"}, answered("error", "id", "r0"))         # no spec
    running = root / f"r2_running_{rt.proc.pid}"
    step({"cmd": "run", "id": "r2", "spec": _spec(root, "r2", _fn("marked_sleep"),
                                                 (30, str(running)))},
         answered("started", "id", "r2"))
    step({"cmd": "task_inventory"}, is_event("task_inventory"))
    # ``started`` comes at the fork: a kill before the child reaches the
    # electron races its start-up; the marker the electron writes first
    # is the proof that it runs
    deadline = time.monotonic() + WAIT_S
    while not running.exists():
        assert time.monotonic() < deadline, "r2 never started its electron"
        time.sleep(0.01)
    step({"cmd": "kill", "id": "r2"}, answered("exit", "id", "r2"))
    step({"cmd": "kill", "id": "nobody"}, answered("error", "id", "nobody"))
    step({"cmd": "task_inventory"}, is_event("task_inventory"), 2)

    watched = root / "watched.jsonl"
    watched.write_text("".join(json.dumps({"type": "progress", "step": i}) + "\n"
                               for i in range(2)) + "not json\n")
    step({"cmd": "watch", "id": "w1", "path": str(watched)},
         lambda e: e.get("event") == "telemetry" and e.get("id") == "w1"
         and e["data"].get("step") == 1)
    step({"cmd": "unwatch", "id": "w1"}, answered("unwatched", "id", "w1"))
    step({"cmd": "watch", "id": "w2"}, answered("error", "id", "w2"))      # no path
    if rt.frames:
        def ops_answered(kind, ids):
            return lambda e: e.get("event") == kind and e.get("id") in ids

        bodies = [_args(n) for n in (2, 3, 4)]
        step({"cmd": "multi_invoke", "digest": square, "ops": [{"id": f"m{n}"} for n in (1, 2, 3)],
              "args_lens": [len(b) for b in bodies], "args_bytes": b"".join(bodies)},
             ops_answered("result", ("m1", "m2", "m3")), 3)
        step({"cmd": "multi_invoke", "digest": square, "ops": [{"id": "t1"}, {"id": "t2"}],
              "args_lens": [len(bodies[0]), 99], "args_bytes": bodies[0]},
             ops_answered("error", ("t1", "t2")), 2)                       # torn body
        step({"cmd": "multi_invoke", "digest": "4" * 64, "ops": [{"id": "u1"}, {"id": "u2"}],
              "args_lens": [len(bodies[0])] * 2, "args_bytes": bodies[0] * 2},
             ops_answered("error", ("u1", "u2")), 2)                       # unregistered
    step({"cmd": "shutdown"}, is_event("bye"))


def _value(data: bytes, root: Path):
    """A result pickle's (value, exception type, message), the run's
    directory in the message as ``<root>``."""
    result, exception, *_times = pickle.loads(data)
    message = str(exception).replace(str(root), "<root>") if exception else ""
    return result, type(exception).__name__, message


def normalized(events: list[dict], root: Path) -> tuple[list, dict]:
    """(the non-telemetry events in order, id -> its records in order),
    volatile fields removed, result pickles replaced by their values and
    the run's directory by ``<root>``."""
    def strip(d):
        d = {k: v for k, v in d.items() if k not in VOLATILE}
        return json.loads(json.dumps(d).replace(str(root), "<root>"))

    top, streams = [], {}
    for e in events:
        if e.get("event") == "telemetry":
            streams.setdefault(e["id"], []).append(strip(e["data"]))
            continue
        data_bytes = e.get("data_bytes")
        e = strip({k: v for k, v in e.items() if k != "data_bytes"})
        if e.get("event") == "result":
            if data_bytes is not None:
                e["data"] = _value(data_bytes, root)  # a result frame's body
            elif "data" in e:
                e["data"] = _value(base64.b64decode(e["data"]), root)
            else:
                data = Path(e["data_path"].replace("<root>", str(root))).read_bytes()
                assert hashlib.sha256(data).hexdigest() == e.pop("data_digest")
                assert len(data) == e.pop("bytes")
                e["data_path"] = _value(data, root)
        if e.get("event") == "task_inventory":
            e["tasks"] = [t["id"] for t in e["tasks"]]
        if e.get("event") == "register_error":
            e["message"] = e["message"].split("(")[0]  # the repr's detail names the runtime
        if e.get("event") == "result" and top and top[-1].get("event") == "result" \
                and str(top[-1].get("id")) > str(e.get("id")):
            # ops of one multi_invoke finish in any order: keep a run of
            # results sorted by id
            at = len(top)
            while at and top[at - 1].get("event") == "result" \
                    and str(top[at - 1].get("id")) > str(e.get("id")):
                at -= 1
            top.insert(at, e)
            continue
        top.append(e)
    return top, streams


def run_both(tmp_path_factory, frames: bool) -> dict:
    """The script on both runtimes at once; name -> (its Runtime, its root)."""
    import threading

    runs, errors = {}, {}

    def drive(name):
        root = tmp_path_factory.mktemp(f"rpc_{name}{'_frames' if frames else ''}")
        rt = None
        try:
            rt = Runtime(RUNTIMES[name], root, frames=frames)
            run_script(rt, root)
        except BaseException as err:  # noqa: BLE001 - reported below
            errors[name] = err
        finally:
            if rt is not None:
                rt.close()
        runs[name] = (rt, root)

    threads = [threading.Thread(target=drive, args=(n,)) for n in RUNTIMES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return runs


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    return {name: (rt.events, root)
            for name, (rt, root) in run_both(tmp_path_factory, frames=False).items()}


@pytest.fixture(scope="module")
def framed_runs(tmp_path_factory):
    return run_both(tmp_path_factory, frames=True)


def test_port_runtime_answers_the_rpc_script_like_the_reference(both_runs):
    ref_top, ref_streams = normalized(*both_runs["reference"])
    port_top, port_streams = normalized(*both_runs["port"])
    assert port_top == ref_top
    assert port_streams == ref_streams


def test_port_runtime_answers_the_rpc_script_like_the_reference_on_frames(framed_runs):
    ref_top, ref_streams = normalized(framed_runs["reference"][0].events,
                                      framed_runs["reference"][1])
    port_top, port_streams = normalized(framed_runs["port"][0].events, framed_runs["port"][1])
    assert port_top == ref_top
    assert port_streams == ref_streams


def test_the_frames_arm_batches_invokes_and_frames_results(framed_runs, both_runs):
    """On frames: results come back as frames, the invocations' records in
    ``telemetry_batch`` frames, one ``multi_started`` acks a batch of three
    ops whose results are each op's own, a torn batch and an unregistered
    one refuse every op; every value equals the JSON-lines arm's."""
    rt, root = framed_runs["port"]
    top, streams = normalized(rt.events, root)
    assert "result" in rt.frame_kinds and rt.batches > 0
    results = {e["id"]: e for e in top if e["event"] == "result"}
    assert [results[f"m{n}"]["data"] for n in (1, 2, 3)] == [
        (4, "NoneType", ""), (9, "NoneType", ""), (16, "NoneType", "")]
    started = [e for e in top if e["event"] == "multi_started"]
    assert [e["ids"] for e in started] == [["m1", "m2", "m3"]]
    errors = {e["id"]: e for e in top if e["event"] == "error" and e.get("id")}
    assert all(errors[t]["code"] == "bad_frame" and errors[t]["permanent"] for t in ("t1", "t2"))
    assert all(errors[t]["code"] == "unregistered" for t in ("u1", "u2"))
    line_top, line_streams = normalized(*both_runs["port"])
    line_results = {e["id"]: e for e in line_top if e["event"] == "result"}
    assert {k: results[k] for k in line_results} == line_results
    assert {k: v for k, v in streams.items() if k in line_streams} == line_streams


def test_the_rpc_script_covers_every_outcome(both_runs):
    top, streams = normalized(*both_runs["port"])
    by_id = {}
    for e in top:
        by_id.setdefault(e.get("id") or e.get("digest") or e["event"], []).append(e)
    results = {e["id"]: e for e in top if e["event"] == "result"}
    assert results["i1"]["data"] == (36, "NoneType", "")
    assert results["i2"]["data"] == ("7?", "NoneType", "")
    assert results["i2b"]["ok"] is False and "content digest" in results["i2b"]["data"][2]
    assert results["i4"]["data"] == (0.01, "NoneType", "")
    assert results["i5"]["data"] == (None, "ValueError", "rpc-protocol-boom")
    assert results["i6"]["data_path"] == ("y" * 5000, "NoneType", "")
    codes = [e["code"] for e in top if e["event"] == "register_error"]
    assert codes == ["digest_mismatch", "missing"]
    assert [e.get("code") for e in by_id["i3"]] == ["unregistered"]
    exits = {e["id"]: (e["code"], e["signal"]) for e in top if e["event"] == "exit"}
    assert exits == {"r1": (0, 0), "r2": (-1, 15)}
    inventories = [e["tasks"] for e in top if e["event"] == "task_inventory"]
    assert inventories == [["r2"], []]
    assert [e["event"] for e in by_id["nobody"]] == ["error"]
    assert [d["step"] for d in streams["w1"]] == [0, 1]
    assert [d["type"] for d in streams["i1"]] == ["worker.task_started", "worker.task_finished"]
    assert streams["i5"][-1]["ok"] is False
    root = both_runs["port"][1]
    assert pickle.loads((root / "result_r1.pkl").read_bytes())[:2] == (25, None)


@pytest.mark.parametrize("mode,item", [("--rpc-child", "2c.6"), ("--serve-child", "2c.6")])
def test_port_harness_refuses_modes_of_later_items(mode, item):
    proc = subprocess.run([sys.executable, str(RUNTIMES["port"]), mode, "x"],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "not ported yet" in proc.stderr and item in proc.stderr
