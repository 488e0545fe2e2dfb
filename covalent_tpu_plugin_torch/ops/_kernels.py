"""Build, load and launch the hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C entry point.  At
first use the sources are compiled with ``nvcc`` for ``sm_90a`` (Hopper),
one process per source, all started together, into
``build/torch_kernels/<hash of the sources>/`` at the root of the checkout,
and loaded with ``ctypes``.  Importing this module builds nothing.

The wrappers take CUDA tensors only: they check device, type, shape and
contiguity, allocate the outputs with ``torch.empty``, launch on the current
stream without synchronising, raise if the launch reported a CUDA error, and
count the launch.  The plain PyTorch versions of the same functions live in
:mod:`.attention`, which picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: head widths the kernels are instantiated for (csrc/flash_common.cuh)
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Kernel:
    """One CUDA kernel: its source, its C entry point, the TPU kernel it
    replaces (``file:line`` of the Pallas kernel body) and its launch count."""

    def __init__(self, name: str, source: str, argtypes: list, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self._argtypes = argtypes
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = ctypes.CDLL(str(build()[self.source]))
            fn = getattr(lib, self.name)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd.cu",
    [_P] * 7 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/ops/attention.py:356",
)
FLASH_BWD_DKDV = Kernel(
    "flash_bwd_dkdv", "flash_bwd_dkdv.cu",
    [_P] * 10 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/ops/attention.py:591",
)
FLASH_BWD_DQ = Kernel(
    "flash_bwd_dq", "flash_bwd_dq.cu",
    [_P] * 9 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/ops/attention.py:694",
)
KERNELS = (FLASH_FWD, FLASH_BWD_DKDV, FLASH_BWD_DQ)

_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources_digest() -> str:
    sha = hashlib.sha256()
    for name in sorted({k.source for k in KERNELS} | set(_HEADERS)):
        sha.update(name.encode())
        sha.update((CSRC / name).read_bytes())
    sha.update(" ".join(NVCC_FLAGS).encode())
    return sha.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every kernel source not yet built; return source -> library.

    The libraries are keyed by a hash of the sources and flags, so an edit
    rebuilds and an unchanged tree reuses what an earlier process built.
    Each library is written under a temporary name and renamed into place,
    so a concurrent process never loads a half-written file.
    """
    with _build_lock:
        out = BUILD_ROOT / sources_digest()
        libs = {k.source: out / f"lib{Path(k.source).stem}.so" for k in KERNELS}
        missing = {src: lib for src, lib in libs.items() if not lib.exists()}
        if not missing:
            return libs
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src, lib in missing.items():
            tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failures = []
        for src, lib, tmp, proc in procs:
            output, _ = proc.communicate()
            if proc.returncode:
                failures.append(f"{src}:\n{output}")
            else:
                os.replace(tmp, lib)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return libs


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0


def launch_counts() -> dict[str, int]:
    return {kernel.name: kernel.launches for kernel in KERNELS}


def _check(tensors: dict, dtype: torch.dtype, device: torch.device) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_qkv(q, k, v, extra: dict):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q (B, H, S, D) and k, v (B, H_kv, S_k, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    batch, heads, seq_q, head_dim = q.shape
    kv_heads, seq_k = k.shape[1], k.shape[2]
    if k.shape[0] != batch or k.shape[3] != head_dim:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if kv_heads == 0 or heads % kv_heads:
        raise ValueError(
            f"GQA needs query heads ({heads}) divisible by kv heads ({kv_heads})"
        )
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if min(batch, heads, seq_q, seq_k) < 1:
        raise ValueError("empty attention input")
    tensors = {"q": q, "k": k, "v": v}
    tensors.update({n: t for n, t in extra.items() if t is not None})
    _check(
        {n: t for n, t in tensors.items() if n not in ("lse", "delta", "qpos", "kpos")},
        q.dtype, q.device,
    )
    for name in ("lse", "delta"):
        if name in extra:
            t = extra[name]
            _check({name: t}, torch.float32, q.device)
            if t.shape != (batch, heads, seq_q):
                raise ValueError(f"{name} shape {tuple(t.shape)} != {(batch, heads, seq_q)}")
    for name, length in (("qpos", seq_q), ("kpos", seq_k)):
        t = extra.get(name)
        if t is not None:
            _check({name: t}, torch.int32, q.device)
            if t.shape != (length,):
                raise ValueError(f"{name} shape {tuple(t.shape)} != {(length,)}")
    return batch, heads, kv_heads, seq_q, seq_k, head_dim


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _band(causal: bool, window: int | None, sinks: int) -> tuple[int, int, int]:
    return int(causal), -1 if window is None else int(window), int(sinks)


def flash_fwd(q, k, v, qpos, kpos, causal: bool, window: int | None, sinks: int):
    """Forward sweep: ``(out, lse)`` with ``out`` in q's type and ``lse``
    (B, H, S) f32."""
    b, h, hkv, sq, sk, d = _check_qkv(q, k, v, {"qpos": qpos, "kpos": kpos})
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(qpos), _ptr(kpos), _ptr(out), _ptr(lse),
        _DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d, d**-0.5,
        *_band(causal, window, sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


def flash_bwd_dkdv(q, k, v, dout, lse, delta, qpos, kpos, causal: bool,
                   window: int | None, sinks: int):
    """dK/dV sweep: ``(dk, dv)`` at kv-head shape, in k's type."""
    b, h, hkv, sq, sk, d = _check_qkv(
        q, k, v,
        {"dout": dout, "lse": lse, "delta": delta, "qpos": qpos, "kpos": kpos},
    )
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    FLASH_BWD_DKDV.launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta),
        _ptr(qpos), _ptr(kpos), _ptr(dk), _ptr(dv),
        _DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d, d**-0.5,
        *_band(causal, window, sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, qpos, kpos, causal: bool,
                 window: int | None, sinks: int):
    """dQ sweep: ``dq`` in q's type."""
    b, h, hkv, sq, sk, d = _check_qkv(
        q, k, v,
        {"dout": dout, "lse": lse, "delta": delta, "qpos": qpos, "kpos": kpos},
    )
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    dq = torch.empty_like(q)
    FLASH_BWD_DQ.launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta),
        _ptr(qpos), _ptr(kpos), _ptr(dq),
        _DTYPE_CODES[q.dtype], b, h, hkv, sq, sk, d, d**-0.5,
        *_band(causal, window, sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    return dq
