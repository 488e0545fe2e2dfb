"""Run ``chip_smoke.py``'s ``ssh`` phase alone on one card, in about two minutes.

    python3 tools/ssh_phase.py [lines.jsonl]

Builds the kernels, trains the ``train`` phase's standard arm in-process
for the losses the phase compares against, then runs
``chip_smoke.ssh_phase`` (config 1, the warm pool, the 125M LM by RPC, the
result cache on that pool and the FSDP gang over two SSH addresses, through
a minissh server on loopback).  Prints the card and each line of the phase, and writes the
lines to ``lines.jsonl`` when a path is given.
"""

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
        print("ssh_phase: no CUDA device is available", file=sys.stderr)
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
    start = time.perf_counter()
    lines, launches, cache_launches = cs.ssh_phase(losses)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            for line in lines:
                f.write(json.dumps(line, default=str) + "\n")
    for line in lines:
        print(json.dumps(line, default=str), flush=True)
    print(json.dumps({"launches": launches, "cache_launches": cache_launches,
                      "seconds": time.perf_counter() - start}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
