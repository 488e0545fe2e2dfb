"""Run ``chip_smoke.py``'s ``ssh`` phase (with its ``cache`` arm) and its
``lifecycle`` phase alone on one card, in about seven minutes.

    python3 tools/lifecycle_phase.py [lines.jsonl]

Builds the kernels, trains the ``train`` phase's standard arm in-process
for the losses the ``ssh`` phase compares against, runs
``chip_smoke.ssh_phase``, then serves the ``session`` phase's traffic
through a local session for the streams the serve cell over SSH must
equal, then runs ``chip_smoke.lifecycle_phase`` (prewarm and teardown, a
straggler and the canary, the CAS's byte budget, a session and a replica
set over minissh).  Prints the card and each line, and writes the lines
to ``lines.jsonl`` when a path is given.
"""

import asyncio
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


async def local_streams() -> list:
    """The serve cell's 16 requests through a local session: its streams."""
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config
    from covalent_tpu_plugin_torch.serving import open_session

    config = lm_125m_config(max_seq=512)
    prompts, caps = cs.session_prompts(config.vocab_size)
    ex = GPUExecutor(transport="local", cache_dir=str(cs.WORK / "cache"),
                     remote_cache=str(cs.WORK / "remote_local_session"),
                     python_path=sys.executable, use_agent="pool",
                     pool_preload=cs.SERVE_PRELOAD, task_env={"PYTHONPATH": cs.ROOT.as_posix()})
    try:
        handle = await open_session(ex, cs.serve_factory(config, "cuda"), open_timeout_s=300)
        await cs._warm(handle, config, 1)
        results, *_ = await cs._timed_burst(handle, prompts, caps)
        await handle.close()
        return results
    finally:
        await ex.close()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lifecycle_phase: no CUDA device is available", file=sys.stderr)
        return 1
    os.environ["COVALENT_TPU_CONFIG"] = str(cs.WORK / "config.toml")
    from covalent_tpu_plugin_torch.models.train import train_lm
    from covalent_tpu_plugin_torch.ops import _kernels

    print(cs.nvidia_smi(), flush=True)
    start = time.perf_counter()
    _kernels.build()
    print("build_s", time.perf_counter() - start, flush=True)
    losses = train_lm(steps=cs.SSH_STEPS, batch_size=cs.BATCH, seq_len=cs.SEQ, seed=0)["losses"]
    torch.cuda.empty_cache()
    out = []
    start = time.perf_counter()
    lines, launches, cache_launches = cs.ssh_phase(losses)
    out += [{"phase": "ssh", **line} for line in lines]
    out.append({"phase": "ssh", "seconds": time.perf_counter() - start, "launches": launches,
                "cache_launches": cache_launches})
    start = time.perf_counter()
    streams = asyncio.run(local_streams())
    out.append({"phase": "local_session", "seconds": time.perf_counter() - start})
    start = time.perf_counter()
    lines, serving = cs.lifecycle_phase(streams)
    out += [{"phase": "lifecycle", **line} for line in lines]
    out.append({"phase": "lifecycle", "seconds": time.perf_counter() - start,
                "serving_launches": serving})
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            for line in out:
                f.write(json.dumps(line, default=str) + "\n")
    for line in out:
        print(json.dumps(line, default=str)[:4000], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
