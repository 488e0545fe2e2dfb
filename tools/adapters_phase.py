"""Run ``chip_smoke.py``'s ``adapters`` phase alone on one card.

    python3 tools/adapters_phase.py [lines.jsonl]

Builds the kernels, serves the ``session`` phase's traffic through a local
session for the streams the base lanes must equal, then runs
``chip_smoke.adapters_phase``: the int8-weight kernel against
``bi_gemm_tc`` on the widened weight and its times, the LoRA fine-tune
electrons (float base and QLoRA) by RPC, and one session hosting the four
decode modes and a bank of adapters, one attached and detached mid-burst.
Prints the card and each line, and writes the lines to ``lines.jsonl``
when a path is given.
"""

import asyncio
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
from lifecycle_phase import local_streams  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("adapters_phase: no CUDA device is available", file=sys.stderr)
        return 1
    os.environ["COVALENT_TPU_CONFIG"] = str(cs.WORK / "config.toml")
    from covalent_tpu_plugin_torch.ops import _kernels

    print(cs.nvidia_smi(), flush=True)
    start = time.perf_counter()
    _kernels.build()
    out = [{"phase": "build", "seconds": time.perf_counter() - start}]
    start = time.perf_counter()
    streams = asyncio.run(local_streams())
    out.append({"phase": "local_session", "seconds": time.perf_counter() - start})
    start = time.perf_counter()
    lines, serving = cs.adapters_phase({"results": streams})
    out += [{"phase": "adapters", **line} for line in lines]
    out.append({"phase": "adapters", "seconds": time.perf_counter() - start,
                "serving_launches": serving})
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            for line in out:
                f.write(json.dumps(line, default=str) + "\n")
    for line in out:
        print(json.dumps(line, default=str)[:6000], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
