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
:mod:`.attention` (the flash sweeps, which port the reference's Pallas
kernels) and :mod:`.batch_invariant` (the serving products and RMSNorm,
which port no Pallas kernel), each picking between the two by the tensors'
device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: head widths the kernels are instantiated for (csrc/flash_common.cuh)
HEAD_DIMS = (16, 32, 64, 128, 256)
#: names of the kernels a C entry point's (dtype, head dim) switch picks
#: between, by the value its ``<name>_route`` export returns
ROUTES = ("scalar-fma", "wgmma+tma")
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Kernel:
    """One CUDA kernel: its source, its C entry point, what it replaces
    (``file:line`` of the Pallas kernel body, or of the reference op XLA
    computes where there is no Pallas kernel) and its launch count."""

    def __init__(self, name: str, source: str, argtypes: list, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        #: "BxHxSxD dtype" of the query each launch took -> launches (flash
        #: kernels); "BxHxSxD dtype->float32" for a launch with f32 outputs
        self.shapes: dict[str, int] = {}
        self._argtypes = argtypes
        self._fn = None

    def _export(self, symbol: str, argtypes: list):
        fn = getattr(ctypes.CDLL(str(build()[self.source])), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def route(self, dtype: torch.dtype, head_dim: int) -> str:
        """The kernel a launch with these inputs runs, as the C entry point's
        switch picks it (csrc/flash_common.cuh: route).  Builds the kernels."""
        code = self._export(f"{self.name}_route", [_I, _I])(_DTYPE_CODES[dtype], head_dim)
        return ROUTES[code]

    def note_shape(self, q: torch.Tensor, out_dtype: torch.dtype) -> None:
        """Count a launch's query shape and output type (called beside a
        launch)."""
        key = "x".join(map(str, q.shape)) + " " + str(q.dtype).removeprefix("torch.")
        if out_dtype != q.dtype:
            key += "->" + str(out_dtype).removeprefix("torch.")
        self.shapes[key] = self.shapes.get(key, 0) + 1

    def launch(self, *args) -> None:
        if self._fn is None:
            self._fn = self._export(self.name, self._argtypes)
        err = self._fn(*args)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


FLASH_FWD = Kernel(
    "flash_fwd", "flash_fwd.cu",
    [_P] * 7 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/ops/attention.py:356",
)
FLASH_BWD_DKDV = Kernel(
    "flash_bwd_dkdv", "flash_bwd_dkdv.cu",
    [_P] * 10 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/ops/attention.py:591",
)
FLASH_BWD_DQ = Kernel(
    "flash_bwd_dq", "flash_bwd_dq.cu",
    [_P] * 9 + [_I] * 8 + [_F] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/ops/attention.py:694",
)
#: The ports of the reference's three Pallas kernels (the training path).
KERNELS = (FLASH_FWD, FLASH_BWD_DKDV, FLASH_BWD_DQ)

_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
#: The batch-invariant product's three routes (``plan_bi_gemm`` picks the
#: cores by the operands' types, a tensor-core kernel by W's layout): a pair
#: with an f32 operand on the CUDA cores ...
BI_GEMM = Kernel(
    "bi_gemm", "bi_gemm.cu", [_P] * 3 + [_I] * 3 + [_I64P, _I64P] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/models/transformer.py:467 (no Pallas kernel: XLA's dense "
    "and decode-attention products; f32 operands)",
)
#: ... bf16 operands, W k-contiguous, on the tensor cores (the
#: dense products, the lm_head, the decode attention's scores) ...
BI_GEMM_TC = Kernel(
    "bi_gemm_tc", "bi_gemm_tc.cu", [_P] * 3 + [_I] + [_I64P, _I64P] + [_I] * 4 + [_P],
    "covalent_tpu_plugin/models/transformer.py:467 (no Pallas kernel: XLA's dense "
    "products, the lm_head and the decode attention's scores)",
)
#: ... and the decode attention's mix, its cache operand read transposed.
BI_GEMM_MIX = Kernel(
    "bi_gemm_mix", "bi_gemm_mix.cu", [_P] * 3 + [_I] + [_I64P, _I64P] + [_I] * 3 + [_P],
    "covalent_tpu_plugin/models/transformer.py:496 (no Pallas kernel: XLA's "
    "decode-attention mix)",
)
#: ... and the int8-weight product of the quantized denses: bf16 features,
#: the weight read as int8 and widened in registers, the scale applied in
#: the epilogue.
BI_GEMM_W8 = Kernel(
    "bi_gemm_w8", "bi_gemm_w8.cu",
    [_P] * 4 + [_I] + [_I64P, _I64P] + [_I] * 4 + [_P],
    "covalent_tpu_plugin/models/quant.py:84-89 (no Pallas kernel: XLA's int8-weight "
    "dense products and lm_head)",
)
#: The norm, alone or with the residual add before it (one entry point, one
#: count).
BI_RMSNORM = Kernel(
    "bi_rmsnorm", "bi_rmsnorm.cu", [_P] * 5 + [_I] * 3 + [_I64, _I64, _F, _P],
    "covalent_tpu_plugin/models/transformer.py:183 and :542-549 (no Pallas kernel: XLA's "
    "RMSNorm and the residual add before it)",
)
#: The serving paths' batch-invariant kernels (ops/batch_invariant.py).
SERVING_KERNELS = (BI_GEMM, BI_GEMM_TC, BI_GEMM_MIX, BI_RMSNORM, BI_GEMM_W8)
#: ``plan_bi_gemm``'s route -> the kernel that takes it.
BI_GEMM_ROUTES = {"fma": BI_GEMM, "tc": BI_GEMM_TC, "mix": BI_GEMM_MIX, "w8": BI_GEMM_W8}

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
    """Hash of every ``*.cu`` and ``*.cuh`` under ``csrc/`` and the flags:
    the sources are read from the directory, so a new header is covered
    without being listed anywhere."""
    sha = hashlib.sha256()
    for path in sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        sha.update(path.name.encode())
        sha.update(path.read_bytes())
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
        libs = {k.source: out / f"lib{Path(k.source).stem}.so"
                for k in KERNELS + SERVING_KERNELS}
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
    for kernel in KERNELS + SERVING_KERNELS:
        kernel.launches = 0
        kernel.shapes = {}


def launch_counts() -> dict[str, int]:
    """Launches of the flash kernels (the training path's)."""
    return {kernel.name: kernel.launches for kernel in KERNELS}


def launch_shapes() -> dict[str, dict[str, int]]:
    """The flash kernels' launches by query shape and type ("BxHxSxD dtype",
    "...->float32" where the launch wrote f32)."""
    return {kernel.name: dict(kernel.shapes) for kernel in KERNELS}


def serving_launch_counts() -> dict[str, int]:
    """Launches of the serving paths' batch-invariant kernels, one key per
    route of the product (``bi_gemm``: f32 operands on the CUDA cores,
    ``bi_gemm_tc``, ``bi_gemm_mix``: bf16 on the tensor cores,
    ``bi_gemm_w8``: an int8 weight on them) and the norm's."""
    return {kernel.name: kernel.launches for kernel in SERVING_KERNELS}


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


def _out_dtype(out_dtype: torch.dtype | None, like: torch.dtype) -> torch.dtype:
    """The type a sweep writes: the input's, or float32 (the reference's
    ``out_dtype`` / ``grad_dtype``, for callers that sum partials)."""
    out_dtype = like if out_dtype is None else out_dtype
    if out_dtype not in (like, torch.float32):
        raise ValueError(f"the flash kernels write {like} or float32, not {out_dtype}")
    return out_dtype


def flash_fwd(q, k, v, qpos, kpos, causal: bool, window: int | None, sinks: int,
              out_dtype: torch.dtype | None = None):
    """Forward sweep: ``(out, lse)`` with ``out`` in ``out_dtype`` (q's type
    by default, or float32) and ``lse`` (B, H, S) f32."""
    b, h, hkv, sq, sk, d = _check_qkv(q, k, v, {"qpos": qpos, "kpos": kpos})
    out_dtype = _out_dtype(out_dtype, q.dtype)
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(qpos), _ptr(kpos), _ptr(out), _ptr(lse),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[out_dtype], b, h, hkv, sq, sk, d, d**-0.5,
        *_band(causal, window, sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    FLASH_FWD.note_shape(q, out_dtype)
    return out, lse


def flash_bwd_dkdv(q, k, v, dout, lse, delta, qpos, kpos, causal: bool,
                   window: int | None, sinks: int, grad_dtype: torch.dtype | None = None):
    """dK/dV sweep: ``(dk, dv)`` at kv-head shape, in ``grad_dtype`` (k's
    type by default, or float32)."""
    b, h, hkv, sq, sk, d = _check_qkv(
        q, k, v,
        {"dout": dout, "lse": lse, "delta": delta, "qpos": qpos, "kpos": kpos},
    )
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    grad_dtype = _out_dtype(grad_dtype, k.dtype)
    dk = torch.empty(k.shape, dtype=grad_dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=grad_dtype, device=v.device)
    FLASH_BWD_DKDV.launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta),
        _ptr(qpos), _ptr(kpos), _ptr(dk), _ptr(dv),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[grad_dtype], b, h, hkv, sq, sk, d, d**-0.5,
        *_band(causal, window, sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    FLASH_BWD_DKDV.note_shape(q, grad_dtype)
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, qpos, kpos, causal: bool,
                 window: int | None, sinks: int, grad_dtype: torch.dtype | None = None):
    """dQ sweep: ``dq`` in ``grad_dtype`` (q's type by default, or
    float32)."""
    b, h, hkv, sq, sk, d = _check_qkv(
        q, k, v,
        {"dout": dout, "lse": lse, "delta": delta, "qpos": qpos, "kpos": kpos},
    )
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} != q {tuple(q.shape)}")
    grad_dtype = _out_dtype(grad_dtype, q.dtype)
    dq = torch.empty(q.shape, dtype=grad_dtype, device=q.device)
    FLASH_BWD_DQ.launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(dout), _ptr(lse), _ptr(delta),
        _ptr(qpos), _ptr(kpos), _ptr(dq),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[grad_dtype], b, h, hkv, sq, sk, d, d**-0.5,
        *_band(causal, window, sinks), torch.cuda.current_stream(q.device).cuda_stream,
    )
    FLASH_BWD_DQ.note_shape(q, grad_dtype)
    return dq


#: input and output types of the batch-invariant kernels (csrc/bi_*.cu)
_BI_DTYPES = {torch.float32: 0, torch.bfloat16: 2}


def _bi_check(tensors: dict) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernels take CUDA tensors, got {name} on {t.device}")
        if t.dtype not in _BI_DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; the batch-invariant kernels take "
                             "float32 and bfloat16")


def _batch5(t: torch.Tensor) -> tuple[tuple, tuple]:
    """Shape and strides of ``t`` (up to 3 leading batch dims, then 2) as
    five dims, without making a view (a view costs the host more than the
    planner and the launch together)."""
    if not 2 <= t.dim() <= 5:
        raise ValueError(f"expected 2 to 5 dims, got shape {tuple(t.shape)}")
    pad = 5 - t.dim()
    return (1,) * pad + tuple(t.shape), (0,) * pad + t.stride()


#: The segment of the tensor-core routes' order of summation
#: (csrc/bi_mma.cuh: one chain of mma steps from zeros, then added to the
#: total); the kernels check that the plan carries it.
BI_SEG_K = 256
#: The wide tiles (64 x 128) are taken above 16 rows where there are at
#: least this many of them: fewer leave most of the card's 132 SMs idle
#: while each block walks the whole of K, and the skinny tiles, which split
#: K across warps, finish first (H100: M 128 at 768 x 768 and 3072 -> 768).
WIDE_MIN_TILES = 48
#: The int8-weight product's skinny tiles: each warp's ring, and A's rows
#: whole in shared memory where warps walk whole columns
#: (csrc/bi_gemm_w8.cu: skinny_smem); a block that does not fit takes the
#: wide tiles.
W8_SMEM_MAX = 232448
W8_MAX_WARPS = 12
#: Column tiles of 8 (times row tiles and batches) from which the int8
#: skinny tiles give each warp whole columns (rs 1): eight warps on two
#: blocks of each of the card's 132 SMs.
W8_WHOLE_COLUMNS = 2 * 132 * 8
W8_STAGE_BYTES = 8 * BI_SEG_K
W8_STAGES = 4
#: The CUDA-core route's segment (csrc/bi_gemm.cu: one FMA chain from +0,
#: then added to the total); the kernel checks that the plan carries it.
FMA_SEG_K = 64
#: Its blocks' threads, and the skinny tiles' column strips (cw columns x
#: 256 / cw segment slots).
FMA_THREADS = 256
FMA_STRIPS = (256, 128, 64, 32, 16, 8)
#: The skinny tiles' shared memory: A's rows and the partials
#: (csrc/bi_gemm.cu: SKINNY_SMEM_MAX).
FMA_SKINNY_SMEM = 232448
#: Blocks the skinny tiles aim for: two on each of the card's 132 SMs.
FMA_SKINNY_BLOCKS = 264
#: The wide tiles (128 x 128) are taken above 16 rows where there are at
#: least this many of them (the admission wave's lm_head: 256 at M 128).
FMA_WIDE_MIN_TILES = 48


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How :func:`bi_gemm` takes one product.

    ``route`` follows from the dtypes alone: bf16 x bf16 on the tensor
    cores (``tc``, or ``mix`` where W is read transposed; both sum in
    csrc/bi_mma.cuh's order), bf16 x int8 on them too (``w8``, the same
    order on the widened weight), anything else on the CUDA cores (``fma``,
    csrc/bi_gemm.cu's order: FMA chains over segments of 64).
    ``seg_k`` and ``segments`` follow from K.  ``tiles`` and the launch
    shape (``nt`` column tiles and ``rs`` segments a round for the skinny
    tiles, ``nt`` slices for the mix; for ``fma``'s skinny tiles ``nt``
    columns a block and ``rs`` = 256 / ``nt`` segment slots) may follow M,
    N and the batch: they change which thread computes a value, never how.
    """

    route: str  # "tc", "mix", "w8" or "fma"
    seg_k: int
    segments: int
    tiles: str  # "skinny", "wide", "mix" or "fma"
    nt: int = 0
    rs: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _runs_aligned(strides: tuple, run_dim: int) -> bool:
    """The dim ``run_dim`` is contiguous and every other dim moves by whole
    16-byte runs of bf16.  The strides alone decide, whatever the sizes, so
    a slice of one row and of eight rows of the same tensor are laid out
    alike."""
    return strides[run_dim] == 1 and all(
        stride % 8 == 0 for i, stride in enumerate(strides) if i != run_dim)


@functools.lru_cache(maxsize=4096)
def _tensor_core_layout(n: int, k: int, a_strides: tuple, w_strides: tuple) -> tuple:
    """``(copy_a, copy_w, transposed)`` for bf16 operands with these
    five-dim strides: the tensor-core kernels read A and W in 16-byte runs
    along k (``tc``), or W in runs along n (``mix``, the cache's v read
    transposed), so an operand whose runs are off them, or K off a multiple
    of 8, is copied onto them first (W into the k-contiguous layout)."""
    if k % 8:
        return True, True, False
    copy_a = not _runs_aligned(a_strides, 4)
    if w_strides[4] != 1 and n % 8 == 0 and _runs_aligned(w_strides, 3):
        return copy_a, False, True
    return copy_a, not _runs_aligned(w_strides, 4), False


def _onto_runs(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` copied into a fresh contiguous tensor (16-byte aligned), its
    last dim padded with zeros to ``k``: the zero products the kernels'
    last k group adds anyway, so the sums are the same bits."""
    out = (torch.zeros if k != t.shape[-1] else torch.empty)(
        (*t.shape[:-1], k), dtype=t.dtype, device=t.device)
    out[..., :t.shape[-1]].copy_(t)
    return out


@functools.lru_cache(maxsize=4096)
def plan_bi_gemm(a_dtype: torch.dtype, w_dtype: torch.dtype, sizes: tuple,
                 transposed: bool = False) -> GemmPlan:
    """The route and tiles of ``C[z, m, n] = sum_k A[z, m, k] W[z, n, k]``.

    ``sizes`` is (z1, z2, z3, M, N, K) of operands laid out as the route
    reads them (:func:`bi_gemm` copies them there first); ``transposed``
    says W is n-contiguous.  bf16 A and W take the tensor cores: ``tc``,
    or ``mix`` where W is transposed; bf16 A and an int8 W take ``w8``
    (k-contiguous W only); any other pair takes the f32 CUDA-core kernel.
    M picks tiles, never the route.
    """
    z1, z2, z3, m, n, k = sizes
    if a_dtype == torch.bfloat16 and w_dtype == torch.int8 and not transposed:
        route = "w8"
    elif a_dtype == w_dtype == torch.bfloat16:
        route = "tc"
    else:
        return plan_fma(sizes)
    segments = _cdiv(k, BI_SEG_K)
    if transposed:
        slices = min(4, _cdiv(n, 16))
        return GemmPlan("mix", BI_SEG_K, segments, "mix", nt=slices,
                        rs=min(segments, 8 // slices))
    wide = m > 16 and _cdiv(m, 64) * _cdiv(n, 128) * z1 * z2 * z3 >= WIDE_MIN_TILES
    if route == "w8":
        # a round takes at most 12 segments, the rounds as even as they go
        # (one segment where N alone fills the card); below 8 warps, more
        # column tiles
        rs = _cdiv(segments, _cdiv(segments, W8_MAX_WARPS))
        if _cdiv(n, 8) * _cdiv(m, 16) * z1 * z2 * z3 >= W8_WHOLE_COLUMNS:
            rs = 1
        nt = max(1, 8 // rs)
        if wide or w8_skinny_smem(m, k, nt * rs, rs) > W8_SMEM_MAX:
            return GemmPlan(route, BI_SEG_K, segments, "wide")
        return GemmPlan(route, BI_SEG_K, segments, "skinny", nt=nt, rs=rs)
    if wide:
        return GemmPlan(route, BI_SEG_K, segments, "wide")
    nt = max(1, 8 // segments)
    return GemmPlan(route, BI_SEG_K, segments, "skinny", nt=nt, rs=min(segments, 16 // nt))


def w8_skinny_smem(m: int, k: int, warps: int, rs: int) -> int:
    """Shared memory of the int8 product's skinny block (csrc/bi_gemm_w8.cu:
    skinny_smem): each warp's partials and ring, and, where a warp walks
    whole columns (``rs`` 1), A's rows (8 where M <= 8, else 16; k padded
    to whole groups of 64)."""
    rows = 8 if m <= 8 else 16
    staged = rows * (_cdiv(k, 64) * 64 + 8) * 2 if rs == 1 else 0
    return staged + warps * (32 * 16 + W8_STAGES * W8_STAGE_BYTES)


def fma_skinny_smem(m: int, k: int, cw: int) -> int:
    """Shared memory of the CUDA-core route's skinny block (csrc/bi_gemm.cu:
    skinny_smem): A's rows (1, 8 or 16 by M), each segment 68 f32 wide,
    and the partials of a round where a column's segments are split."""
    rows = 1 if m <= 1 else 8 if m <= 8 else 16
    parts = rows * FMA_THREADS * 4 if cw < FMA_THREADS else 0
    return rows * _cdiv(k, FMA_SEG_K) * (FMA_SEG_K + 4) * 4 + parts


@functools.lru_cache(maxsize=4096)
def plan_fma(sizes: tuple) -> GemmPlan:
    """The CUDA-core route's plan for (z1, z2, z3, M, N, K), whatever the
    dtypes: segments of :data:`FMA_SEG_K` (K alone), the wide tiles above 16
    rows where there are enough of them, else the skinny tiles, whose strip
    narrows (more segment slots, more blocks) until the blocks cover the
    card or every segment of a column has a slot of its own."""
    z1, z2, z3, m, n, k = sizes
    segments = _cdiv(k, FMA_SEG_K)
    batch = z1 * z2 * z3
    wide = GemmPlan("fma", FMA_SEG_K, segments, "wide")
    if m > 16 and _cdiv(m, 128) * _cdiv(n, 128) * batch >= FMA_WIDE_MIN_TILES:
        return wide
    rows = 1 if m <= 1 else 8 if m <= 8 else 16
    cw = next(c for c in FMA_STRIPS if c // 2 < n or c == FMA_STRIPS[-1])
    while (cw > FMA_STRIPS[-1] and _cdiv(m, rows) * _cdiv(n, cw) * batch < FMA_SKINNY_BLOCKS
           and FMA_THREADS // cw < segments):
        cw //= 2
    if fma_skinny_smem(m, k, cw) > FMA_SKINNY_SMEM:
        cw = FMA_THREADS  # one slot: no partials in shared memory
    if fma_skinny_smem(m, k, cw) > FMA_SKINNY_SMEM:
        return wide
    return GemmPlan("fma", FMA_SEG_K, segments, "skinny", nt=cw, rs=FMA_THREADS // cw)


def _bi_operands(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor):
    """The sizes (z1, z2, z3, M, N, K) and the five-dim strides of ``a``,
    ``w`` and ``out``; ``a`` and ``w`` broadcast over the output's batch
    dims (stride 0)."""
    (a_shape, a_strides), (w_shape, w_strides), (c_shape, c_strides) = (
        _batch5(a), _batch5(w), _batch5(out))
    batch = c_shape[:3]

    def broadcast(shape, strides, name):
        for i in range(3):
            if shape[i] != batch[i] and shape[i] != 1:
                raise ValueError(f"bi_gemm: {name} {tuple(shape)} does not broadcast to the "
                                 f"batch {batch}")
        return tuple(st if shape[i] == batch[i] else 0 for i, st in enumerate(strides[:3])) \
            + strides[3:]

    a_strides = broadcast(a_shape, a_strides, "a")
    w_strides = broadcast(w_shape, w_strides, "w")
    m, k = a_shape[3:]
    n = w_shape[3]
    if w_shape[4] != k or c_shape[3:] != (m, n):
        raise ValueError(f"bi_gemm: a {tuple(a.shape)}, w {tuple(w.shape)} and out "
                         f"{tuple(out.shape)} do not make out = a . w^T")
    if min(m, n, k) < 1:
        raise ValueError("bi_gemm: empty product")
    return (*batch, m, n, k), a_strides, w_strides, c_strides


def _bi_prepare(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor):
    """``a`` and ``w`` laid out as their route's kernel reads them, the
    sizes and strides of the three, and the plan.  bf16 operands off the
    tensor cores' 16-byte runs (a row stride or a base pointer off them, K
    off a multiple of 8) are copied onto them, whatever M: the copy moves
    the values, the route and its order of summation stay those of the
    dtypes."""
    sizes, a_strides, w_strides, c_strides = _bi_operands(a, w, out)
    transposed = False
    if a.dtype == w.dtype == torch.bfloat16:
        copy_a, copy_w, transposed = _tensor_core_layout(
            sizes[4], sizes[5], a_strides, w_strides)
        copy_a = copy_a or a.data_ptr() % 16 != 0
        if not transposed:
            copy_w = copy_w or w.data_ptr() % 16 != 0
        elif w.data_ptr() % 16 != 0:
            copy_w, transposed = True, False
        if copy_a or copy_w:
            k8 = _cdiv(sizes[5], 8) * 8
            a = _onto_runs(a, k8) if copy_a else a
            w = _onto_runs(w, k8) if copy_w else w
            sizes, a_strides, w_strides, c_strides = _bi_operands(a, w, out)
    plan = plan_bi_gemm(a.dtype, w.dtype, sizes, transposed)
    return a, w, sizes, a_strides + w_strides + c_strides, plan


def bi_gemm_plan(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> GemmPlan:
    """The plan :func:`bi_gemm` takes for these tensors (on any device)."""
    return _bi_prepare(a, w, out)[-1]


_TILE_CODES = {"skinny": 0, "wide": 1}


def bi_gemm(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[..., m, n] = sum_k a[..., m, k] * w[..., n, k]`` with f32
    accumulation in an order fixed by the dtypes and K (``plan_bi_gemm``;
    csrc/bi_mma.cuh, csrc/bi_gemm.cu), written into ``out`` through its
    strides.  Up to three leading batch dims; ``a`` and ``w`` broadcast
    over them (stride 0).  f32 or bf16 each."""
    _bi_check({"a": a, "w": w, "out": out})
    a, w, sizes, strides, plan = _bi_prepare(a, w, out)
    if plan.route == "fma":
        launch_fma(a, w, out, sizes, strides, plan)
        return out
    shape = (ctypes.c_int64 * 6)(*sizes)
    strides = (ctypes.c_int64 * 15)(*strides)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ptrs = (_ptr(a), _ptr(w), _ptr(out))
    if plan.route == "tc":
        BI_GEMM_TC.launch(*ptrs, _BI_DTYPES[out.dtype], shape, strides,
                          _TILE_CODES[plan.tiles], plan.nt, plan.rs, plan.seg_k, stream)
    else:
        BI_GEMM_MIX.launch(*ptrs, _BI_DTYPES[out.dtype], shape, strides, plan.nt, plan.rs,
                           plan.seg_k, stream)
    return out


def launch_fma(a: torch.Tensor, w: torch.Tensor, out: torch.Tensor, sizes: tuple, strides,
               plan: GemmPlan) -> None:
    """One launch of the CUDA-core kernel (csrc/bi_gemm.cu) on operands of
    any dtype pair, as they are: sizes (z1, z2, z3, M, N, K) and the 15
    strides of :func:`_bi_operands`, the plan :func:`plan_fma`'s."""
    BI_GEMM.launch(
        _ptr(a), _ptr(w), _ptr(out), _BI_DTYPES[a.dtype], _BI_DTYPES[w.dtype],
        _BI_DTYPES[out.dtype], (ctypes.c_int64 * 6)(*sizes), (ctypes.c_int64 * 15)(*strides),
        _TILE_CODES[plan.tiles], plan.nt, plan.seg_k,
        torch.cuda.current_stream(a.device).cuda_stream)


def bi_gemm_w8(a: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               out: torch.Tensor) -> torch.Tensor:
    """``out[..., m, n] = sum_k a[..., m, k] * q[..., n, k]`` with the scale
    step of the reference's int8 dense (``bf16(bf16(sum) * scale[n])`` for a
    bf16 ``out``, ``sum * scale[n]`` for f32), the sums those of
    :func:`bi_gemm` on ``q`` widened to bf16, bit for bit (csrc/bi_gemm_w8.cu).
    ``a`` bf16, ``q`` int8 k-contiguous, ``scale`` f32 one value a column
    (already rounded to ``out``'s type by the caller)."""
    _bi_check({"a": a, "out": out})
    if q.device != a.device or q.dtype != torch.int8:
        raise ValueError(f"bi_gemm_w8: q must be int8 on {a.device}, got {q.dtype} on {q.device}")
    if a.dtype != torch.bfloat16:
        raise ValueError(f"bi_gemm_w8: a must be bfloat16, got {a.dtype}")
    if scale.dtype != torch.float32 or scale.device != a.device or scale.shape != (q.shape[-2],):
        raise ValueError(f"bi_gemm_w8: scale must be float32 ({q.shape[-2]},) on {a.device}, "
                         f"got {scale.dtype} {tuple(scale.shape)} on {scale.device}")
    sizes, a_strides, w_strides, c_strides = _bi_operands(a, q, out)
    k = sizes[5]
    a_ok = _runs_aligned(a_strides, 4) and a.data_ptr() % 16 == 0 and k % 8 == 0
    w_ok = w_strides[4] == 1 and all(st % 16 == 0 for st in w_strides[:4]) \
        and q.data_ptr() % 16 == 0
    if not (a_ok and w_ok):
        # both onto 16-byte runs of k padded to 16: the zeros stay inside the
        # last k group, which the kernels pad with zeros anyway (same bits)
        k16 = _cdiv(k, 16) * 16
        a = _onto_runs(a, k16) if not a_ok or k16 != k else a
        q = _onto_runs(q, k16) if not w_ok or k16 != k else q
        sizes, a_strides, w_strides, c_strides = _bi_operands(a, q, out)
    plan = plan_bi_gemm(a.dtype, q.dtype, sizes)
    BI_GEMM_W8.launch(
        _ptr(a), _ptr(q), _ptr(scale.contiguous()), _ptr(out), _BI_DTYPES[out.dtype],
        (ctypes.c_int64 * 6)(*sizes), (ctypes.c_int64 * 15)(*(a_strides + w_strides + c_strides)),
        _TILE_CODES[plan.tiles], plan.nt, plan.rs, plan.seg_k,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    return out


def _norm(x: torch.Tensor, delta: torch.Tensor | None, scale: torch.Tensor,
          out_dtype: torch.dtype, eps: float):
    """Launch csrc/bi_rmsnorm.cu on contiguous rows of ``x`` (and ``delta``
    of x's shape and type): ``(s, y)``, ``s`` None without ``delta``."""
    tensors = {n: t for n, t in (("x", x), ("delta", delta), ("scale", scale)) if t is not None}
    _bi_check(tensors)
    if out_dtype not in _BI_DTYPES:
        raise ValueError(f"unsupported output dtype {out_dtype}")
    cols = x.shape[-1]
    if not all(t.is_contiguous() for t in tensors.values()) or scale.shape != (cols,):
        raise ValueError(f"bi_rmsnorm: x {tuple(x.shape)} and scale {tuple(scale.shape)} "
                         "must be contiguous, scale one value a column")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype):
        raise ValueError(f"bi_rmsnorm: delta {tuple(delta.shape)} {delta.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.numel() == 0:
        raise ValueError("bi_rmsnorm: empty input")
    s = None if delta is None else torch.empty_like(x)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    BI_RMSNORM.launch(
        _ptr(x), _ptr(delta), _ptr(scale), _ptr(s), _ptr(y), _BI_DTYPES[x.dtype],
        _BI_DTYPES[scale.dtype], _BI_DTYPES[out_dtype], x.numel() // cols, cols, eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return s, y


def bi_rmsnorm(x: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype,
               eps: float) -> torch.Tensor:
    """RMSNorm of each row of ``x`` (contiguous, rows along the last dim)
    in f32 with one warp a row, in an order fixed by the width
    (csrc/bi_rmsnorm.cu), times ``scale``, in ``out_dtype``."""
    return _norm(x, None, scale, out_dtype, eps)[1]


def bi_add_rmsnorm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                   out_dtype: torch.dtype, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add and the norm after it in one launch: ``s = x +
    delta`` in x's type (torch's add, bit for bit) and :func:`bi_rmsnorm`
    of ``s``, which is the same bits as the norm alone on ``s``."""
    return _norm(x, delta, scale, out_dtype, eps)
