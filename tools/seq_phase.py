"""Run the sequence-parallel parts of ``chip_smoke.py`` alone on one card.

    python3 tools/seq_phase.py [lines.jsonl]

Builds the kernels, holds the f32-output variants of the three flash
kernels against their plain versions at the ring's hops
(``chip_smoke.variant_parity_case``), times them beside the bf16-output
kernels (``chip_smoke.variant_timing``), trains the ``train`` phase's
standard arm in-process for the losses the gang arms are compared with,
then runs ``chip_smoke.gang_phase`` with only its ``lm_ring2`` and
``lm_ulysses2`` arms (the collective probe and the rank-shape parity
included).  Prints the card and each line, and writes the lines to
``lines.jsonl`` when a path is given.
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
        print("seq_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["COVALENT_TPU_CONFIG"] = str(cs.WORK / "config.toml")
    from covalent_tpu_plugin_torch.models.train import train_lm
    from covalent_tpu_plugin_torch.ops import _kernels

    lines = [{"card": cs.nvidia_smi()}]
    start = time.perf_counter()
    _kernels.build()
    lines.append({"build_s": time.perf_counter() - start})
    for i, case in enumerate(cs.VARIANT_CASES):
        lines.append({"parity": case["name"], "errors": cs.variant_parity_case(case, 200 + i)})
    lines.append({"timing": cs.variant_timing()})
    losses = train_lm(steps=cs.GANG_STEPS, batch_size=cs.BATCH, seq_len=cs.SEQ, seed=0)["losses"]
    lines.append({"train_losses": losses})
    torch.cuda.empty_cache()
    cs.GANG_ARMS = {arm: cs.GANG_ARMS[arm] for arm in ("lm_ring2", "lm_ulysses2")}
    start = time.perf_counter()
    gang_lines, launches, arm_launches = cs.gang_phase({"standard": losses})
    lines.extend(gang_lines)
    lines.append({"launches": launches, "arm_launches": arm_launches,
                  "gang_seconds": time.perf_counter() - start})
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            for line in lines:
                f.write(json.dumps(line, default=str) + "\n")
    for line in lines:
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
