"""Compare the ``moe8`` train step of several checkouts of the port on one card.

    python3 tools/moe_train_steps.py PARENT_DIR . . PARENT_DIR

runs ``covalent_tpu_plugin_torch.models.train.train_lm`` (the 125M LM with
every MLP a Switch MoE of 8 experts, batch 8 x 1024, seed 0, 8 steps: the
``train`` phase's ``moe8`` arm, 3 steps longer) from each checkout in the
order given, each in a fresh interpreter whose imports come from that
checkout, and prints one JSON line a run: the steady step (the median of
the steps after the first), every step's seconds, the losses and the peak
device memory; then the card's name and power limit.  Give the order
parent, change, change, parent so that drift of the host or the card shows
as a difference between the two runs of one tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json
import statistics
import torch
from covalent_tpu_plugin_torch.models.train import train_lm
out = train_lm(steps=8, batch_size=8, seq_len=1024, seed=0, moe_experts=8)
print(json.dumps({
    "steady_step_ms": 1000 * statistics.median(out["step_s"][1:]),
    "step_s": out["step_s"],
    "losses": out["losses"],
    "peak_mem_bytes": torch.cuda.max_memory_allocated(),
}))
"""


def main(dirs: list[str]) -> int:
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    for i, checkout in enumerate(dirs):
        root = Path(checkout).resolve()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(root), os.environ.get("PYTHONPATH", "")])))
        done = subprocess.run([sys.executable, "-c", _RUN], cwd=root, env=env,
                              capture_output=True, text=True, timeout=900)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        row = json.loads(done.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": i, "checkout": checkout, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
