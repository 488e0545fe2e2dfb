"""Compare the serving norm of several checkouts of the port on one card.

    python3 tools/norm_ab.py PARENT_DIR . . PARENT_DIR

times ``ops.batch_invariant.rms_norm`` (and ``add_rms_norm`` where the
checkout has it) of each checkout in the order given, at the 125M LM's
width (768, bf16 rows and scale) and M 1, 8, 128 and 1024, each checkout in
a fresh interpreter whose imports and kernel build come from it (two builds
of ``csrc/bi_rmsnorm.cu`` export the same C symbol, so they never share a
process).  Beside each: ``F.rms_norm`` on the same rows, and ``x + delta``
then ``F.rms_norm``.  Device time from ``torch.profiler``, 50 calls a cell
after one warm call.  Then one batch-8 decode step of the 125M LM (bf16
weights from seed 0, 8 rows of 128-token prompts after the admission wave
and 20 steps, as ``chip_smoke.py``'s ``serve_profile``) under the
profiler: its device events and device time, and its events counted by
kernel name.  Prints one JSON line a run (the counts by name under
``step_events_by_name``), then the card's name and power limit.  Give
the order parent, change, change, parent so that drift of the card shows
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
import numpy as np
import torch
import torch.nn.functional as F
from covalent_tpu_plugin_torch.models import decode, serve
from covalent_tpu_plugin_torch.models.transformer import TransformerLM, lm_125m_config
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

def device_ms(fn, match=None, iters=50):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and (match is None or match in e.name)]
    if not events:
        raise AssertionError(f"no device events matching {match!r}")
    return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3

gen = torch.Generator(device="cuda").manual_seed(11)
rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
scale, out = rand(768), {}
for m in (1, 8, 128, 1024):
    x, dx = rand(m, 768), rand(m, 768)
    out[f"norm.m{m}"] = device_ms(lambda: bi.rms_norm(x, scale, torch.bfloat16), "rmsnorm")
    if hasattr(bi, "add_rms_norm"):
        out[f"add_norm.m{m}"] = device_ms(
            lambda: bi.add_rms_norm(x, dx, scale, torch.bfloat16), "rmsnorm")
    out[f"F_rms_norm.m{m}"] = device_ms(lambda: F.rms_norm(x, (768,), scale, 1e-6))
    out[f"add_then_F_rms_norm.m{m}"] = device_ms(
        lambda: F.rms_norm(x + dx, (768,), scale, 1e-6))

model = decode.inference_params(TransformerLM(
    lm_125m_config(max_seq=512), device="cuda",
    generator=torch.Generator(device="cuda").manual_seed(0)))
engine = serve.ContinuousEngine(model, max_batch=8, sync_steps=4, max_new_tokens=256)
rng = np.random.default_rng(1)
for i in range(8):
    engine.admit(str(i), rng.integers(0, 32768, 128), {"max_new_tokens": 256})
with torch.no_grad():
    engine.step()
    for _ in range(16):
        serve._run_steps(model, engine._state, 1, 0.0, None, None, None)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        serve._run_steps(model, engine._state, 1, 0.0, None, None, None)
        torch.cuda.synchronize()
events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
by_name = {}
for e in events:
    by_name[e.name[:100]] = by_name.get(e.name[:100], 0) + 1
engine.close()
out.update(step_events=len(events),
           step_device_ms=sum(e.time_range.elapsed_us() for e in events) / 1e3,
           step_events_by_name=by_name)
print(json.dumps(out))
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
                              capture_output=True, text=True, timeout=600)
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
