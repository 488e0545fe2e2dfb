"""Run ``chip_smoke.py``'s ``train`` phase and some of its gang arms alone on one card.

    python3 tools/parallel_phase.py [lines.jsonl] [gang arm ...]

Builds the kernels, runs ``model_check`` (the small LM's flash and MoE
checks) and the ``train`` phase (every arm of ``chip_smoke.TRAIN_ARMS``,
printed, then checked as ``chip_smoke.py`` checks them), then
``chip_smoke.gang_phase`` with the named arms of ``chip_smoke.GANG_ARMS``
(default: ``lm_fsdp2`` and the pipeline, fused-loss and MoE arms), the
collective probe and the rank-shape parity included.  Prints the card and
each line, and writes the lines to ``lines.jsonl`` when a path is given.
"""

import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

DEFAULT_ARMS = ("lm_fsdp2", "lm_pipe2", "lm_tensor2_fused", "lm_moe_tensor2")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parallel_phase: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["COVALENT_TPU_CONFIG"] = str(cs.WORK / "config.toml")
    from covalent_tpu_plugin_torch.ops import _kernels

    out = sys.argv[1] if len(sys.argv) > 1 else None
    arms = tuple(sys.argv[2:]) or DEFAULT_ARMS
    lines = [{"card": cs.nvidia_smi()}]
    start = time.perf_counter()
    _kernels.build()
    lines.append({"build_s": time.perf_counter() - start})
    lines.append({"model_check": cs.model_check()})
    start = time.perf_counter()
    train, _ = cs.train_phase()
    for arm in train:
        line = {"train": arm["arm"], "losses": arm["losses"],
                "steady_step_ms": statistics.median(arm["step_s"][1:]) * 1e3,
                "peak_mem_bytes": arm["peak_mem_bytes"], "launches": arm["launches"],
                "launch_shapes": arm["launch_shapes"], "n_params": arm["n_params"],
                "wall_s": arm["wall_s"]}
        if "moe_aux" in arm:
            line.update({"moe_aux": arm["moe_aux"], "lm_losses": cs.lm_losses(arm)})
        print(json.dumps(line), flush=True)
        lines.append(line)
    lines.append({"train_seconds": time.perf_counter() - start})
    cs.check_train(train)
    by_arm = {arm["arm"]: arm["losses"] for arm in train}
    cs.GANG_ARMS = {arm: cs.GANG_ARMS[arm] for arm in arms}
    start = time.perf_counter()
    gang_lines, launches, arm_launches = cs.gang_phase(by_arm)
    lines.extend(gang_lines)
    lines.append({"launches": launches, "arm_launches": arm_launches,
                  "gang_seconds": time.perf_counter() - start})
    if out:
        with open(out, "w") as f:
            for line in lines:
                f.write(json.dumps(line, default=str) + "\n")
    for line in lines:
        print(json.dumps(line, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
