"""Tiled-matmul probe: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/gemm.py: kernel K9 (``_matmul_kernel``), a
production-shaped tiled matmul with f32 accumulation, kept as the GEMM
cross-check for the attention kernels. The kernel is ``csrc/gemm.cu`` (TMA
loads into a 4-stage shared-memory ring, wgmma warpgroups); its header says
how it is tiled and what bounds it. On f32 inputs it runs its f32 form (the
JAX probe's f32 dot at ``Precision.HIGHEST``): the C entry splits a and b
into three bf16 pieces each (``ops/f32_split.py``) and each f32 product is
six bf16 products, as K1's f32 route takes them. :func:`matmul` launches it
for CUDA tensors and computes the plain :func:`matmul_reference` for CPU
tensors -- the device of the input decides, and a CUDA tensor never reaches
the plain version.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.oracle import _full_f32_matmul
from flashattn_tpu_torch.utils import native

OUT_DTYPES = (torch.bfloat16, torch.float32)


def matmul_reference(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch K9: ``a @ b`` in full f32, cast to ``out_dtype``
    (default ``a.dtype``)."""
    with _full_f32_matmul():
        return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def _check_device(a: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise NotImplementedError(f"no K9 kernel for device {a.device}")


def _launch(lib, a, b, out, stream, pieces: torch.Tensor | None = None) -> int:
    """Call ``lib.fa_gemm_bf16`` -- or, given ``pieces`` (the bf16 scratch of
    f32 a's and b's three pieces), ``lib.fa_gemm_f32``, whose arguments are
    the same with ``pieces`` after out -- with one launch's arguments
    (``native.GEMM_ARGTYPES`` / ``GEMM_F32_ARGTYPES``); returns its
    cudaError_t."""
    (M, K), N = a.shape, b.shape[1]
    out_f32 = int(out.dtype == torch.float32)
    if pieces is None:
        return lib.fa_gemm_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, out_f32,
                                stream)
    return lib.fa_gemm_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), pieces.data_ptr(), M, N,
                           K, out_f32, stream)


def matmul(
    a: torch.Tensor,  # [M, K]
    b: torch.Tensor,  # [K, N]
    *,
    block_m: int = 512,
    block_n: int = 512,
    block_k: int = 512,
    out_dtype=None,
) -> torch.Tensor:
    """Tiled matmul ``[M, K] @ [K, N]`` with f32 accumulation, in
    ``out_dtype`` (default ``a.dtype``).

    The blocks are validated as the JAX probe validates them: each, clipped
    to its dim, must be a multiple of 128 that divides the dim, else
    ``ValueError``. The CUDA kernel's tile is its own (``csrc/gemm.cu``).
    CPU tensors take :func:`matmul_reference`. CUDA tensors launch the
    kernel, which takes bf16 or f32 inputs (both of one dtype; f32 in its
    f32 form, after one launch of the split of a and b) and a bf16 or f32
    output; other dtypes raise ``NotImplementedError``. ``matmul.launches``
    counts kernel launches, ``matmul.launches_f32`` those of the f32 form
    and ``matmul.launches_split`` the splits before them.
    """
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"matmul takes [M, K] and [K, N], got {tuple(a.shape)} x {tuple(b.shape)}")
    out_dtype = a.dtype if out_dtype is None else out_dtype
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} x {tuple(b.shape)}")
    bm, bn, bk = min(block_m, M), min(block_n, N), min(block_k, K)
    if M % bm or N % bn or K % bk or bm % 128 or bn % 128 or bk % 128:
        raise ValueError(
            f"probe kernel needs 128-aligned shapes divisible by blocks: "
            f"({M},{K})x({K},{N}) blocks ({bm},{bn},{bk})")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return matmul_reference(a, b, out_dtype)
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the CUDA K9 takes bfloat16 or float32 inputs of one dtype, got {a.dtype}, "
            f"{b.dtype}")
    _check_device(a)
    if out_dtype not in OUT_DTYPES:
        raise NotImplementedError(f"the CUDA K9 writes bf16 or f32, not {out_dtype}")
    # TMA reads from 16-byte-aligned bases.
    a, b = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
            else x.clone(memory_format=torch.contiguous_format) for x in (a, b))
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    f32 = a.dtype == torch.float32
    # f32: a's and b's three bf16 pieces, [3, M, K] then [3, K, N].
    pieces = (torch.empty(3 * (M * K + K * N), dtype=torch.bfloat16, device=a.device) if f32
              else None)
    with torch.cuda.device(a.device):
        rc = _launch(native.kernels(), a, b, out,
                     torch.cuda.current_stream(a.device).cuda_stream, pieces)
    native.check(rc, "gemm kernel launch")
    matmul.launches += 1
    matmul.launches_f32 += int(f32)
    matmul.launches_split += int(f32)
    return out


matmul.launches = 0
matmul.launches_f32 = 0
matmul.launches_split = 0
