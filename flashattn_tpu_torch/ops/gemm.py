"""Tiled-matmul probe: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/gemm.py: kernel K9 (``_matmul_kernel``), a
production-shaped tiled matmul with f32 accumulation, kept as the GEMM
cross-check for the attention kernels. The kernel is ``csrc/gemm.cu`` (TMA
loads into a 4-stage shared-memory ring, wgmma warpgroups); its header says
how it is tiled and what bounds it. :func:`matmul` launches it
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
    kernel, which takes bf16 inputs and a bf16 or f32 output; f32 inputs
    raise ``NotImplementedError``. ``matmul.launches`` counts kernel
    launches.
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
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA K9 takes bfloat16 inputs, got {a.dtype}, {b.dtype} (an f32 "
            "instantiation is a ROADMAP queue 2 item, as for K1)")
    if a.device.type != "cuda":
        raise NotImplementedError(f"no K9 kernel for device {a.device}")
    if out_dtype not in OUT_DTYPES:
        raise NotImplementedError(f"the CUDA K9 writes bf16 or f32, not {out_dtype}")
    # TMA reads from 16-byte-aligned bases.
    a, b = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
            else x.clone(memory_format=torch.contiguous_format) for x in (a, b))
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = native.kernels().fa_gemm_bf16(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
            int(out_dtype == torch.float32), torch.cuda.current_stream(a.device).cuda_stream)
    native.check(rc, "gemm kernel launch")
    matmul.launches += 1
    return out


matmul.launches = 0
