"""Run ``chip_smoke.py``'s ``serve_moe`` phase alone on one card.

    python3 tools/serve_moe_phase.py [lines.jsonl]

Builds the kernels, then runs ``chip_smoke.serve_moe_phase``: the 125M
Switch-MoE LM (8 experts, capacity factor 1.25, bf16 weights from seed 0)
through ``generate``, the continuous engine on the ``serve`` phase's
traffic, each request served alone, the MoE block against its plain twin,
one profiled decode step and the resident session.  Prints the card and
each line, and writes the lines to ``lines.jsonl`` when a path is given.
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
        print("serve_moe_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["COVALENT_TPU_CONFIG"] = str(cs.WORK / "config.toml")
    from covalent_tpu_plugin_torch.ops import _kernels

    print(cs.nvidia_smi(), flush=True)
    start = time.perf_counter()
    _kernels.build()
    out = [{"phase": "build", "seconds": time.perf_counter() - start}]
    start = time.perf_counter()
    lines, launches = cs.serve_moe_phase()
    out += [{"phase": "serve_moe", **line} for line in lines]
    out.append({"phase": "serve_moe", "seconds": time.perf_counter() - start,
                "serving_launches": launches})
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            for line in out:
                f.write(json.dumps(line, default=str) + "\n")
    for line in out:
        print(json.dumps(line, default=str)[:6000], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
