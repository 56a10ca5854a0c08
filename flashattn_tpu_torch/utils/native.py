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
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# The C entry of K1 on fwd_tile.cuh (csrc/flash_fwd.cu).
FWD_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR, _PTR,        # q, k, v, o, lse
    _PTR, _PTR, _PTR,                    # bias, k_scale, v_scale (f32, or None)
    _I32,                                # K/V dtype code (ops/flash_fwd.KV_DTYPE_CODE)
    _I32, _I32, _I32, _I32, _I32, _I32,  # B, Hq, Hkv, Nq, D, kv_valid_len
    _I32,                                # causal
    ctypes.c_float, ctypes.c_float,      # scale, softcap (0: none)
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k (batch, head, seq) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # v, o (batch, head, seq) strides
    _I64, _I64, _I64,                    # bias (batch, head, row) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # k_scale, v_scale (batch, head, seq) strides
    _PTR,                                # cudaStream_t
]
# The C entry of K1's bias route (csrc/flash_fwd_bias_sm90.cu): the dense
# route's arguments with the bias and its strides.
FWD_BIAS_SM90_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,  # q, k, v, o, lse, bias (f32)
    _PTR, _PTR, _PTR, _PTR,              # seg_q, seg_kv (padded), q_range, kv_range (or None)
    _I32, _I32, _I32, _I32, _I32,        # B, Hq, Hkv, Nq, D
    _I32, _I32, _I32, _I32,              # kv_valid_len, causal, window left, right (-1: none)
    _I32, _I32,                          # q_offset, kv_offset (absolute positions)
    ctypes.c_float, ctypes.c_float,      # scale, softcap (0: none)
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k (batch, head, seq) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # v, o (batch, head, seq) strides
    _I64, _I64, _I64,                    # bias (batch, head, row) strides
    _I64,                                # seg_q batch stride
    _PTR,                                # cudaStream_t
]

# The C entry of K1's dense route (csrc/flash_fwd_sm90.cu).
FWD_SM90_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR, _PTR,        # q, k, v, o, lse
    _PTR, _PTR, _PTR, _PTR,              # seg_q, seg_kv (padded), q_range, kv_range (or None)
    _I32, _I32, _I32, _I32, _I32,        # B, Hq, Hkv, Nq, D
    _I32, _I32, _I32, _I32,              # kv_valid_len, causal, window left, right (-1: none)
    _I32, _I32,                          # q_offset, kv_offset (absolute positions)
    ctypes.c_float, ctypes.c_float,      # scale, softcap (0: none)
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k (batch, head, seq) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # v, o (batch, head, seq) strides
    _I64,                                # seg_q batch stride
    _PTR,                                # cudaStream_t
]

# The C entry of K3 (csrc/flash_bwd_sm90.cu).
BWD_SM90_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR,              # q, k, v, dO
    _PTR, _PTR,                          # lse, delta (f32 rows padded to nq_pad)
    _PTR, _PTR, _PTR,                    # dq (f32, zeroed), dk, dv (f32)
    _I32, _I32, _I32, _I32, _I32, _I32,  # B, Hq, Hkv, Nq, Nk, D
    _I32, _I32, _I32, _I32,              # kv_valid_len, causal, window left, right (-1: none)
    _I32, _I32,                          # q_offset, kv_offset (absolute positions)
    _I32,                                # nq_pad
    ctypes.c_float,                      # scale
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k (batch, head, seq) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # v, dO (batch, head, seq) strides
    _PTR,                                # cudaStream_t
]

# The C entry of K5 + K6 without a bias (csrc/flash_bwd_split_sm90.cu).
BWD_SPLIT_SM90_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR,              # q, k, v, dO
    _PTR, _PTR,                          # lse, delta (f32 rows padded to nq_pad)
    _PTR, _PTR, _PTR,                    # dq (f32, zeroed), dk, dv (f32)
    _PTR, _PTR, _PTR, _PTR,              # seg_q, seg_kv (padded), q_range, kv_range (or None)
    _I32, _I32, _I32, _I32, _I32, _I32,  # B, Hq, Hkv, Nq, Nk, D
    _I32, _I32, _I32, _I32,              # kv_valid_len, causal, window left, right (-1: none)
    _I32, _I32,                          # q_offset, kv_offset (absolute positions)
    _I32,                                # nq_pad
    ctypes.c_float, ctypes.c_float,      # scale, softcap (0: none)
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k (batch, head, seq) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # v, dO (batch, head, seq) strides
    _PTR,                                # cudaStream_t
]

# The C entry of K5 + K6's bias route (csrc/bwd_bias_sm90.cu).
BWD_BIAS_SM90_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR,              # q, k, v, dO
    _PTR, _PTR,                          # lse, delta (f32 rows padded to nq_pad)
    _PTR,                                # bias (f32)
    _PTR, _PTR, _PTR, _PTR,              # dq (f32, zeroed), dk, dv (f32), dbias (f32, or None)
    _PTR, _PTR, _PTR, _PTR,              # seg_q, seg_kv (padded), q_range, kv_range (or None)
    _I32, _I32, _I32, _I32, _I32, _I32,  # B, Hq, Hkv, Nq, Nk, D
    _I32, _I32, _I32, _I32,              # kv_valid_len, causal, window left, right (-1: none)
    _I32, _I32,                          # q_offset, kv_offset (absolute positions)
    _I32,                                # nq_pad
    ctypes.c_float, ctypes.c_float,      # scale, softcap (0: none)
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k (batch, head, seq) strides
    _I64, _I64, _I64, _I64, _I64, _I64,  # v, dO (batch, head, seq) strides
    _I64, _I64, _I64,                    # bias (batch, head, row) strides
    _PTR,                                # cudaStream_t
]

# The C entries of the f32 routes: K1's (csrc/flash_fwd_f32.cu) takes the
# arguments of K1's dense route, the f32 backward's (csrc/flash_bwd_f32.cu,
# K3 and K5 + K6 with or without a bias) those of the split route, segment
# ids and the softcap optional, each with the bf16 scratch into which it
# splits its f32 operands first (ops/f32_split.py, csrc/split_bf16x3.cu), and
# before the stream the optional f32 bias with its strides (and the
# backward's dbias, or None).
FWD_F32_ARGTYPES = (FWD_SM90_ARGTYPES[:5] + [_PTR] + FWD_SM90_ARGTYPES[5:-1]  # + pieces
                    + [_PTR, _I64, _I64, _I64]  # bias (f32, or None), (batch, head, row) strides
                    + FWD_SM90_ARGTYPES[-1:])
BWD_F32_ARGTYPES = (BWD_SPLIT_SM90_ARGTYPES[:9] + [_PTR] + BWD_SPLIT_SM90_ARGTYPES[9:-1]
                    + [_PTR, _PTR, _I64, _I64, _I64]  # bias, dbias (f32, or None), bias strides
                    + BWD_SPLIT_SM90_ARGTYPES[-1:])

_RING_DIMS = [
    _I32, _I32, _I32, _I32, _I32, _I32,  # B, Hq, Hkv, nq, nk, D
    _I32, _I32,                          # q_base, kv_off (global positions)
    _I32, _I32, _I32,                    # causal, window left, window right (-1: none)
]
# The C entries of the ring kernels K7 (csrc/ring_fwd.cu) and K8 (csrc/ring_bwd.cu).
RING_FWD_ARGTYPES = [
    _PTR, _PTR, _PTR,                    # q (x scale x log2 e), k, v
    _PTR, _PTR, _PTR,                    # acc, m, l: the running state (f32)
    _PTR, _PTR,                          # o, lse (written on the last step)
    *_RING_DIMS, _I32, _I32,             # first, last
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k/v (batch, head, seq) strides
    _I64, _I64, _I64,                    # o (batch, head, seq) strides
    _PTR,                                # cudaStream_t
]
RING_BWD_ARGTYPES = [
    _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,  # q (x scale x log2 e), k, v, dO, lse, delta
    _PTR, _PTR, _PTR,                    # dq (f32, zeroed), dk, dv (f32 accumulators)
    *_RING_DIMS,
    _I64, _I64, _I64, _I64, _I64, _I64,  # q, k/v (batch, head, seq) strides
    _I64, _I64, _I64,                    # dO (batch, head, seq) strides
    _PTR,                                # cudaStream_t
]


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
    lib.fa_fwd.argtypes = FWD_ARGTYPES
    lib.fa_fwd_bias_sm90.restype = i32
    lib.fa_fwd_bias_sm90.argtypes = FWD_BIAS_SM90_ARGTYPES
    lib.fa_fwd_sm90.restype = i32
    lib.fa_fwd_sm90.argtypes = FWD_SM90_ARGTYPES
    lib.fa_decode.restype = i32
    lib.fa_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr,            # q, k, v, o, lse
        ptr, ptr, ptr,                      # bias, k_scale, v_scale (f32, or None)
        ptr, ptr,                           # part_acc, part_ml (f32 scratch, or None)
        i32,                                # K/V dtype code (ops/flash_fwd.KV_DTYPE_CODE)
        i32, i32, i32, i32, i32, i32,       # B, Hq, Hkv, Nq, D, kv_valid_len
        i32, i32,                           # splits, split_len
        ctypes.c_float, ctypes.c_float,     # scale, softcap (0: none)
        i64, i64, i64, i64, i64, i64,       # q, k (batch, head, seq) strides
        i64, i64, i64, i64, i64, i64,       # v, o (batch, head, seq) strides
        i64, i64, i64,                      # bias (batch, head, row) strides
        i64, i64, i64, i64, i64, i64,       # k_scale, v_scale (batch, head, seq) strides
        ptr,                                # cudaStream_t
    ]
    lib.fa_bwd_sm90.restype = i32
    lib.fa_bwd_sm90.argtypes = BWD_SM90_ARGTYPES
    lib.fa_bwd_split_sm90.restype = i32
    lib.fa_bwd_split_sm90.argtypes = BWD_SPLIT_SM90_ARGTYPES
    lib.fa_fwd_f32.restype = i32
    lib.fa_fwd_f32.argtypes = FWD_F32_ARGTYPES
    lib.fa_bwd_f32.restype = i32
    lib.fa_bwd_f32.argtypes = BWD_F32_ARGTYPES
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
    lib.fa_bwd_bias_sm90.restype = i32
    lib.fa_bwd_bias_sm90.argtypes = BWD_BIAS_SM90_ARGTYPES
    lib.fa_ring_fwd_bf16.restype = i32
    lib.fa_ring_fwd_bf16.argtypes = RING_FWD_ARGTYPES
    lib.fa_ring_bwd_bf16.restype = i32
    lib.fa_ring_bwd_bf16.argtypes = RING_BWD_ARGTYPES
    lib.fa_error_string.restype = ctypes.c_char_p
    lib.fa_error_string.argtypes = [i32]
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = kernels().fa_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
