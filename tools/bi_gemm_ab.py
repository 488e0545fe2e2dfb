"""Compare the f32 CUDA-core product and the int8-weight product of several
checkouts of the port on one card.

    python3 tools/bi_gemm_ab.py [--quick] [--out FILE] [--ptxas CHECKOUT FILE] PARENT . . PARENT

Each checkout runs in a fresh interpreter whose imports and kernel build
come from it (two builds of a kernel source export the same C symbols, so
they never share a process).  In each, device time from ``torch.profiler``
(20 calls a cell after one warm call) of

- the f32 route (``csrc/bi_gemm.cu`` through ``batch_invariant.linear``):
  the lm_head on f32 features (32768 x 768, bf16 weight, f32 logits) at M
  1, 8, 128 and 1024; the MoE's router (8 x 768, bf16 weight, f32 out) at
  M 1, 8 and 128; an f32 model's MLP wi (3072 x 768, f32 weight) at M 1,
  8 and 1024.  Beside each, ``F.linear`` on f32 operands (TF32 off); the
  kernel's own device events only (not the wrapper's casts);
- the int8-weight product (``csrc/bi_gemm_w8.cu`` through
  ``batch_invariant.linear_w8``) at the 125M LM's q/k/v/o, wi, wo and
  lm_head and M 1, 8, 128 and 1024 (and q/k/v/o with f32 outputs, whose
  wrapper launches no cast), beside ``F.linear`` on the weight widened to
  bf16 beforehand;
- one decode step of the 125M ``moe8`` LM (8 rows at position 128, as
  ``chip_smoke.py``'s ``serve_moe`` profiles it): device ms by serving
  kernel, the router's ``bi_gemm`` among them;
- one decode step of the 125M LM with 8 rows on int8 weights (the
  ``adapters`` session's int8 lane, ``decode_modes`` fp and int8, 128
  prompt tokens; a chunk of 8 steps profiled): device ms a step and the
  int8 product's share;

and the checks: every row of a batch of 8, 128 and 1024 against the same
row alone (rows that differ, must be 0) on each f32 shape and each int8
shape; the int8 product against ``bi_gemm_tc`` on the widened weight
(elements that differ, must be 0); each route against its plain version.
Prints one JSON line a run (and appends it to ``--out FILE``), then the
card's name and power limit.  Give
the order parent, change, change, parent, so that drift of the card shows
as a difference between the two runs of one tree.  ``--ptxas CHECKOUT
FILE`` first writes ptxas's registers, shared memory and spills of every
kernel of the two sources of CHECKOUT to FILE.  ``--quick`` times the
int8 product at M 1 and 8 only (no f32 route, no checks, no decode steps).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json
import os
import torch
import torch.nn.functional as F
import chip_smoke as cs
from covalent_tpu_plugin_torch.models.transformer import lm_125m_config, use_batch_invariant
from covalent_tpu_plugin_torch.ops import _kernels
from covalent_tpu_plugin_torch.ops import batch_invariant as bi

torch.backends.cuda.matmul.allow_tf32 = False
QUICK = os.environ.get("BI_GEMM_AB_QUICK") == "1"
gen = torch.Generator(device="cuda").manual_seed(11)

def randn(*shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

def bound_ms(flops, nbytes, peak):
    return max(flops / peak, nbytes / 3.35e12) * 1e3

out, fns, rows_differ, errs, bounds, plans = {}, {}, {}, {}, {}, {}
# f32 route: name -> (N, K, weight dtype, rows)
F32 = {"lm_head_f32_features": (32768, 768, torch.bfloat16, (1, 8, 128, 1024)),
       "router": (8, 768, torch.bfloat16, (1, 8, 128)),
       "f32_mlp_wi": (3072, 768, torch.float32, (1, 8, 1024))}
for name, (n, k, wdt, ms) in ({} if QUICK else F32).items():
    w = randn(n, k, dtype=wdt, scale=0.02)
    w32 = w.float()
    wave = randn(1024, k)
    for m in ms:
        x = wave[:m].contiguous()
        label = f"fma.{name}.m{m}"
        fns[f"{label}:kernel"] = (lambda x=x, w=w: bi.linear(x, w, torch.float32), "bi_gemm")
        fns[f"{label}:library"] = (lambda x=x, w=w32: F.linear(x, w), None)
        got = bi.linear(x, w, torch.float32)
        want = bi.linear_plain(x, w, torch.float32)
        errs[label] = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
        bounds[label] = bound_ms(2 * m * n * k, x.numel() * 4 + w.numel() * w.element_size()
                                 + m * n * 4, 67e12)
        plans[label] = str(_kernels.bi_gemm_plan(x, w, got))
    whole = bi.linear(wave, w, torch.float32)
    for batch in (8, 128, 1024):
        part = bi.linear(wave[:batch], w, torch.float32)
        differ = int((part != whole[:batch]).any(dim=1).sum())
        for r in range(batch):
            differ += not torch.equal(bi.linear(wave[r:r + 1], w, torch.float32)[0], part[r])
        rows_differ[f"fma.{name}.batch{batch}"] = differ

# int8 route
W8 = {"qkvo": (768, 768, torch.bfloat16), "mlp_wi": (3072, 768, torch.bfloat16),
      "mlp_wo": (768, 3072, torch.bfloat16), "lm_head": (32768, 768, torch.float32),
      "qkvo_f32_out": (768, 768, torch.float32)}
elements_differ = {}
for name, (n, k, dtype) in W8.items():
    wf = randn(n, k, scale=0.02)
    scale = wf.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale[:, None]), -127, 127).to(torch.int8)
    wide = q.to(torch.bfloat16)
    wave = randn(1024, k, dtype=torch.bfloat16)
    for m in (1, 8) if QUICK else (1, 8, 128, 1024):
        x = wave[:m].contiguous()
        label = f"w8.{name}.m{m}"
        fns[f"{label}:kernel"] = (lambda x=x, q=q, s=scale, d=dtype: bi.linear_w8(x, q, s, d),
                                  "w8_")
        fns[f"{label}:library"] = (lambda x=x, w=wide: F.linear(x, w), None)
        got = bi.linear_w8(x, q, scale, dtype)
        twin = torch.empty(m, n, dtype=dtype, device="cuda")
        _kernels.bi_gemm(x, wide, twin)
        twin = twin * scale.to(dtype)
        elements_differ[label] = int((got != twin).sum())
        want = bi.linear_w8_plain(x, q, scale, dtype).float()
        errs[label] = (got.float() - want).abs().max().item() / max(1.0, want.abs().max().item())
        bounds[label] = bound_ms(2 * m * n * k, x.numel() * 2 + q.numel() + n * 4
                                 + m * n * got.element_size(), 989e12)
        plans[label] = str(_kernels.plan_bi_gemm(torch.bfloat16, torch.int8, (1, 1, 1, m, n, k)))
    whole = bi.linear_w8(wave, q, scale, dtype)
    for batch in () if QUICK else (8, 128, 1024):
        part = bi.linear_w8(wave[:batch], q, scale, dtype)
        differ = int((part != whole[:batch]).any(dim=1).sum())
        for r in range(batch):
            differ += not torch.equal(bi.linear_w8(wave[r:r + 1], q, scale, dtype)[0], part[r])
        rows_differ[f"w8.{name}.batch{batch}"] = differ

times = cs.device_ms_labelled(fns, 20)
for label in sorted({key.split(":")[0] for key in fns}):
    out[label] = {"ms": times[f"{label}:kernel"], "library_ms": times[f"{label}:library"],
                  "bound_ms": bounds[label], "rel_err_plain": errs[label],
                  "plan": plans[label]}

if QUICK:
    print(json.dumps(out))
    raise SystemExit(0)
model = use_batch_invariant(cs._moe_model(lm_125m_config(**cs.MOE_SERVE), "cuda"))
step = cs._moe_profile(model)
out["moe8_decode_step"] = {k: step[k] for k in ("device_ms", "kernels_per_step",
                                                 "device_ms_by_serving_kernel",
                                                 "serving_kernel_launches")}
# one decode step of the 125M LM with every row on int8 weights (the
# adapters session's int8 lane), 8 rows at position 128
import numpy as np
from covalent_tpu_plugin_torch.models import decode, serve
from covalent_tpu_plugin_torch.models.transformer import TransformerLM
base = decode.inference_params(TransformerLM(
    lm_125m_config(max_seq=512), device="cuda",
    generator=torch.Generator(device="cuda").manual_seed(0)))
engine = serve.ContinuousEngine(base, max_batch=8, sync_steps=8, max_new_tokens=128,
                                decode_modes=("fp", "int8"))
rng = np.random.default_rng(1)
for i in range(8):
    engine.admit(str(i), rng.integers(0, 32768, 128), {"max_new_tokens": 128, "quality": "int8"})
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.no_grad():
    engine.step()
    engine.step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        engine.step()
        torch.cuda.synchronize()
engine.close()
events = cs.device_events(prof)
step_ms = lambda tag: sum(e.time_range.elapsed_us() for e in events  # noqa: E731
                          if tag is None or tag in e.name) / 1e3 / 8
out["int8_decode_step"] = {"device_ms": step_ms(None), "w8_ms": step_ms("w8_"),
                           "w8_launches": sum("w8_" in e.name for e in events) / 8}
out["rows_differ"] = rows_differ
out["elements_differ_bi_gemm_tc"] = elements_differ
print(json.dumps(out))
"""

_SOURCES = ("bi_gemm.cu", "bi_gemm_w8.cu")


def ptxas(checkout: Path, path: Path) -> None:
    """ptxas's report of every kernel of the two sources, demangled."""
    sys.path.insert(0, str(checkout))
    from covalent_tpu_plugin_torch.ops import _kernels

    lines = []
    for src in _SOURCES:
        cubin = checkout / "build" / f"{src}.cubin"
        cubin.parent.mkdir(parents=True, exist_ok=True)
        flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
        done = subprocess.run(
            [_kernels._nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
             str(_kernels.CSRC / src)], capture_output=True, text=True, timeout=900)
        report = done.stdout + done.stderr
        try:
            report = subprocess.run(["c++filt"], input=report, capture_output=True,
                                    text=True).stdout or report
        except FileNotFoundError:
            pass
        lines += [f"== {src} (exit {done.returncode})"] + report.splitlines()
    path.write_text("\n".join(lines) + "\n")
    spilling = [line for line in lines
                if "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads" not in line]
    print(json.dumps({"ptxas": str(path), "lines_with_spills": len(spilling)}), flush=True)


def main(argv: list[str]) -> int:
    out, quick = None, argv[:1] == ["--quick"]
    argv = argv[quick:]
    if argv[:1] == ["--out"]:
        out, argv = Path(argv[1]), argv[2:]
    if argv[:1] == ["--ptxas"]:
        ptxas(Path(argv[1]).resolve(), Path(argv[2]))
        argv = argv[3:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for i, checkout in enumerate(argv):
        root = Path(checkout).resolve()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(root), os.environ.get("PYTHONPATH", "")])),
                   BI_GEMM_AB_QUICK="1" if quick else "0")
        done = subprocess.run([sys.executable, "-c", _RUN], cwd=root, env=env,
                              capture_output=True, text=True, timeout=900)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        line = json.dumps({"run": i, "checkout": checkout,
                           **json.loads(done.stdout.strip().splitlines()[-1])})
        print(line, flush=True)
        if out is not None:
            with out.open("a") as f:
                f.write(line + "\n")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
