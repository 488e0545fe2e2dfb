"""Compare the serving electron of several checkouts of the port on one card.

    python3 tools/serve_ab.py PARENT_DIR . . PARENT_DIR

runs ``covalent_tpu_plugin_torch.models.serve.serve_lm`` (the 125M LM, bf16
weights, seed 0) from each checkout in the order given, each in a fresh
interpreter whose imports come from that checkout, and prints one JSON line
a run: decode and serve tokens/s, TTFT p50, batch-1 agreement and the
serving kernels' launches; then the card's name and power limit.  Give the
order parent, change, change, parent so that drift of the host or the card
shows as a difference between the two runs of one tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json
from covalent_tpu_plugin_torch.models.serve import serve_lm
out = serve_lm(seed=0)
print(json.dumps({
    "decode_tokens_per_s": out["decode"]["e2e_tokens_per_s"],
    "serve_tokens_per_s": out["serve"]["tokens_per_s"],
    "ttft_p50_s": out["serve"]["ttft_s"]["p50"],
    "batch1_agreement": [out["batch1_agreement"]["equal"], out["batch1_agreement"]["rows"]],
    "serving_launches": out["serving_launches"],
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
