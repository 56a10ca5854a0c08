"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc + ctypes.

Counterpart of the JAX package's planner loader (flashattn_tpu/utils/native.py):
at first use each ``csrc/*.cu`` is compiled with nvcc into an object file, all
of them at once in parallel, and the objects are linked into one shared
library with a plain C interface under ``flashattn_tpu_torch/build/`` (rebuilt
when a source is newer than the library), loaded with ``ctypes``. Every pointer and the
CUDA stream cross the boundary as ``ctypes.c_void_p``; each C entry returns
``cudaGetLastError()`` after its launch and the Python wrapper raises if that
is not 0. A failed build raises with nvcc's stderr -- there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libfa_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels are built from csrc/ at first use on a machine with "
        "the CUDA toolkit")


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all of them, and return their
    output; raise RuntimeError with the stderr of each one that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    failed = [(c, p.returncode, err + out)
              for c, p, (out, err) in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed with exit code {rc}: {' '.join(c)}\n{msg}" for c, rc, msg in failed))
    return "".join(err + out for out, err in outs)


def build(extra_flags: tuple[str, ...] = ()) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/*.cu`` into ``build/libfa_kernels.so`` if it is missing or
    older than a source: one nvcc per source, all started together, then one
    link. Returns (library path, nvcc's output -- registers and spills with
    ``("-Xptxas", "-v")``; empty when the library was up to date). Raises
    RuntimeError with nvcc's stderr on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    deps = sources + sorted(CSRC.glob("*.cuh"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib = BUILD_DIR / LIB_NAME
    newest = max(p.stat().st_mtime for p in deps)
    if lib.exists() and lib.stat().st_mtime >= newest and not extra_flags:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build under a private name and rename, so a concurrent loader never
    # maps a half-written library.
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [BUILD_DIR / f"{s.stem}.{os.getpid()}.o" for s in sources]
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(o), str(s)]
                        for s, o in zip(sources, objs)])
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]])
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return lib, log


@functools.lru_cache(maxsize=1)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fa_fwd.restype = i32
    lib.fa_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,            # q, k, v, o, lse
        ptr, ptr,                           # seg_q, seg_kv (int32 ids, or None)
        ptr, ptr, ptr,                      # bias, k_scale, v_scale (f32, or None)
        i32,                                # K/V dtype code (ops/flash_fwd.KV_DTYPE_CODE)
        i32, i32, i32, i32, i32, i32,       # B, Hq, Hkv, Nq, D, kv_valid_len
        i32, i32, i32,                      # causal, window left, window right (-1: none)
        ctypes.c_float, ctypes.c_float,     # scale, softcap (0: none)
        i64, i64, i64, i64, i64, i64,       # q, k (batch, head, seq) strides
        i64, i64, i64, i64, i64, i64,       # v, o (batch, head, seq) strides
        i64, i64,                           # seg_q, seg_kv batch strides
        i64, i64, i64,                      # bias (batch, head, row) strides
        i64, i64, i64, i64, i64, i64,       # k_scale, v_scale (batch, head, seq) strides
        ptr,                                # cudaStream_t
    ]
    bwd_head = [ptr, ptr, ptr, ptr, ptr, ptr]  # q, k, v, dO, lse, delta
    bwd_dims = [
        i32, i32, i32, i32, i32, i32, i32,  # B, Hq, Hkv, Nq, Nk, D, kv_valid_len
        i32, i32, i32,                      # causal, window left, window right (-1: none)
    ]
    bwd_strides = [
        i64, i64, i64, i64, i64, i64,       # q, k (batch, head, seq) strides
        i64, i64, i64, i64, i64, i64,       # v, dO (batch, head, seq) strides
    ]
    # scale, softcap (0: none) for K5 and K6; K3 takes the scale only.
    bwd_tail = [*bwd_dims, ctypes.c_float, ctypes.c_float, *bwd_strides]
    lib.fa_bwd_bf16.restype = i32
    lib.fa_bwd_bf16.argtypes = [
        *bwd_head, ptr, ptr, ptr,           # dq (f32, zeroed), dk, dv (f32)
        *bwd_dims, ctypes.c_float, *bwd_strides,
        ptr,                                # cudaStream_t
    ]
    lib.fa_bwd_dkv_bf16.restype = i32
    split_tail = [
        *bwd_tail, i64, i64,                # seg_q, seg_kv batch strides
        i64, i64, i64,                      # bias (batch, head, row) strides
        ptr,                                # cudaStream_t
    ]
    lib.fa_bwd_dkv_bf16.argtypes = [
        *bwd_head, ptr, ptr,                # seg_q, seg_kv (int32 ids, or None)
        ptr,                                # bias (f32, or None)
        ptr, ptr,                           # dk, dv (f32)
        *split_tail,
    ]
    lib.fa_bwd_dq_bf16.restype = i32
    lib.fa_bwd_dq_bf16.argtypes = [
        *bwd_head, ptr, ptr,                # seg_q, seg_kv (int32 ids, or None)
        ptr,                                # bias (f32, or None)
        ptr, ptr,                           # dq, dbias (f32; dbias None: not wanted)
        *split_tail,
    ]
    lib.fa_gemm_bf16.restype = i32
    lib.fa_gemm_bf16.argtypes = [
        ptr, ptr, ptr,                      # a [M, K], b [K, N] (bf16), out [M, N]
        i32, i32, i32, i32,                 # M, N, K, out is f32 (else bf16)
        ptr,                                # cudaStream_t
    ]
    lib.fa_roofline_bf16.restype = i32
    lib.fa_roofline_bf16.argtypes = [
        ptr, ptr, ptr,                      # a, b, out [size, size] bf16
        i32, i32,                           # size, iters
        ptr,                                # cudaStream_t
    ]
    lib.fa_error_string.restype = ctypes.c_char_p
    lib.fa_error_string.argtypes = [i32]
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = kernels().fa_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
