"""First check of the flash kernels' f32-output variants on one card.

    git archive <parent commit> | tar -x -C build/parent
    python3 tools/flash_f32_check.py [ptxas.json]

Builds the kernels, writes what ptxas reports for the three flash sources
(registers and spills of every instantiation, the f32-output ones beside
the 16-bit ones) to ``ptxas.json`` (or prints it), checks that the default
(input-type) outputs of this tree's kernels equal, bit for bit, those of the
tree unpacked under ``build/parent`` (each in its own process: two builds of
the same kernels in one process interpose each other's host stubs), then
holds each sweep's f32 variant against its plain f32 version and its 16-bit
output (``chip_smoke.variant_parity_case``) at the parity phase's hops and
also on the scalar route and in f16.  Every file it writes lies in a private
temporary directory (under ``TMPDIR``), removed at the end.  Exits non-zero
on any difference.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: case -> (B, H, H_kv, S_q, S_k, D), input type, causal: the default outputs
DEFAULT_CASES = {"path": ((8, 12, 12, 1024, 1024, 64), "bfloat16", True),
                 "gqa128": ((2, 8, 2, 256, 256, 128), "bfloat16", True),
                 "f16_d32": ((1, 4, 2, 256, 192, 32), "float16", False),
                 "f32": ((1, 4, 4, 256, 192, 32), "float32", True)}
#: beyond the parity phase's hops: the scalar route and f16 without positions
EXTRA_VARIANT_CASES = [
    dict(name="scalar_d32", shape=(1, 4, 2, 256, 256, 32), dtype="bfloat16", causal=True,
         positions=("zigzag", 0, 1)),
    dict(name="f16_full", shape=(1, 4, 4, 192, 100, 64), dtype="float16", causal=False),
]


def _inputs(shape, dtype, seed):
    import torch

    b, h, hkv, sq, sk, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dtype)

    def randn(*dims):
        return torch.randn(*dims, generator=gen, device="cuda").to(dtype)

    return randn(b, h, sq, d), randn(b, hkv, sk, d), randn(b, hkv, sk, d), randn(b, h, sq, d)


def outputs(root: str, out: str) -> None:
    """The default outputs of the kernels of the tree at ``root``, saved."""
    import torch

    sys.path.insert(0, root)
    from covalent_tpu_plugin_torch.ops import _kernels

    res = {}
    for name, (shape, dtype, causal) in DEFAULT_CASES.items():
        q, k, v, dout = _inputs(shape, dtype, 7)
        o, lse = _kernels.flash_fwd(q, k, v, None, None, causal, None, 0)
        delta = (dout.float() * o.float()).sum(-1)
        args = (q, k, v, dout, lse, delta, None, None, causal, None, 0)
        dk, dv = _kernels.flash_bwd_dkdv(*args)
        dq = _kernels.flash_bwd_dq(*args)
        res[name] = [t.cpu() for t in (o, lse, dk, dv, dq)]
    torch.cuda.synchronize()
    torch.save(res, out)


def ptxas(scratch: Path) -> dict:
    """What ptxas prints for each flash source: the kernel names, their
    registers and spills (the libraries go to ``scratch``)."""
    csrc = ROOT / "covalent_tpu_plugin_torch" / "csrc"
    procs = {src: subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
         str(scratch / f"{src}.so"), str(csrc / src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("flash_fwd.cu", "flash_bwd_dq.cu", "flash_bwd_dkdv.cu")}
    keep = ("_tc_kernel", "registers", "spill", "error", "warning")
    return {src: [line for line in proc.communicate()[0].splitlines()
                  if any(word in line.lower() for word in keep)][-60:]
            for src, proc in procs.items()}


def variants() -> tuple[dict, bool]:
    """Each sweep's f32 variant against its plain version and its 16-bit
    output, case by case; a case that fails reports its error."""
    import chip_smoke as cs

    report, ok = {}, True
    for i, case in enumerate(cs.VARIANT_CASES + EXTRA_VARIANT_CASES):
        try:
            report[case["name"]] = cs.variant_parity_case(case, seed=200 + i)
        except AssertionError as exc:
            report[case["name"]], ok = {"error": str(exc)}, False
    return report, ok


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from covalent_tpu_plugin_torch.ops import _kernels

    start = time.time()
    _kernels.build()
    print(json.dumps({"build_s": time.time() - start}), flush=True)
    with tempfile.TemporaryDirectory(prefix="flash_f32_check_") as scratch:
        scratch = Path(scratch)
        report = json.dumps(ptxas(scratch), indent=1)
        if len(sys.argv) > 1:
            Path(sys.argv[1]).write_text(report)
        else:
            print(report, flush=True)
        saved = {}
        for tag, root in (("parent", ROOT / "build" / "parent"), ("new", ROOT)):
            saved[tag] = scratch / f"{tag}.pt"
            subprocess.run([sys.executable, __file__, "outputs", str(root), str(saved[tag])],
                           check=True)
        parent, new = torch.load(saved["parent"]), torch.load(saved["new"])
    bits = {name: [bool(torch.equal(x, y)) for x, y in zip(parent[name], new[name])]
            for name in parent}
    print(json.dumps({"bit_equal_parent": bits}), flush=True)
    report, ok = variants()
    print(json.dumps({"f32_variants": report, "ok": ok}), flush=True)
    print(json.dumps({"launch_shapes": _kernels.launch_shapes()}), flush=True)
    return 0 if ok and all(all(v) for v in bits.values()) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["outputs"]:
        outputs(sys.argv[2], sys.argv[3])
    else:
        sys.exit(main())
