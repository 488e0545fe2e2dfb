"""Run ``chip_smoke.py``'s ``agent`` phase alone on one card.

    python3 tools/agent_phase.py

Builds the kernels, trains the ``train`` phase's standard arm in-process
for the losses the phase compares against, serves the ``session`` phase's
16 requests through a pool-mode session (no reconnect) for the streams and
the tokens/s it compares against, then runs ``chip_smoke.agent_phase``: the
native agent's build, the 125M LM's training electron by RPC through
``--rpc-child``, a capture on the pool server during an RPC training
electron, a ``--serve-child`` session opened on a fleet ``Pool``, a capture
of it while it decodes, and its handoff to a second ``Pool``.  Prints the
card and one JSON line per step.
"""

import asyncio
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("agent_phase: no CUDA device is available", file=sys.stderr)
        return 1
    os.environ["COVALENT_TPU_CONFIG"] = str(cs.WORK / "config.toml")
    from covalent_tpu_plugin_torch import GPUExecutor
    from covalent_tpu_plugin_torch.models.train import train_lm
    from covalent_tpu_plugin_torch.models.transformer import lm_125m_config
    from covalent_tpu_plugin_torch.ops import _kernels

    print(cs.nvidia_smi(), flush=True)
    start = time.perf_counter()
    _kernels.build()
    print("build_s", time.perf_counter() - start, flush=True)
    losses = train_lm(steps=cs.STEPS, batch_size=cs.BATCH, seq_len=cs.SEQ, seed=0)["losses"]
    torch.cuda.empty_cache()

    async def pool_session() -> dict:
        executor = GPUExecutor(transport="local", cache_dir=str(cs.WORK / "cache"),
                               remote_cache=str(cs.WORK / "remote_session"),
                               python_path=sys.executable, use_agent="pool",
                               pool_preload=cs.SERVE_PRELOAD,
                               task_env={"PYTHONPATH": ROOT})
        try:
            return await cs._serve_session(executor, [], lm_125m_config(max_seq=512), "cuda",
                                           reconnect=False)
        finally:
            await executor.close()

    session = asyncio.run(pool_session())
    print(json.dumps({"pool_session_tokens_per_s": session["tokens_per_s"],
                      "open_s": session["open_s"]}), flush=True)
    start = time.perf_counter()
    launches = cs.agent_phase(losses, session)
    print(json.dumps({"launches": launches, "seconds": time.perf_counter() - start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
