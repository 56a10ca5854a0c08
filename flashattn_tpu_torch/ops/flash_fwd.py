"""FlashAttention-2 forward: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/flash_fwd.py: kernel K1 (``_fwd_kernel``) without
bias, with KV tail, GQA, an optional causal mask and optional segment ids
(packed sequences), which also covers K2 (``_fwd_causal_resident_kernel``,
the whole-sequence causal route). The kernel is
``csrc/flash_fwd.cu``; its header says what bounds it and what it leaves for
later. :func:`fwd` launches it for CUDA tensors and computes the plain
:func:`fwd_reference` for CPU tensors -- the device of the input decides, and
a CUDA tensor never reaches the plain version.

Strides: the kernel takes (batch, head, seq) strides, so the ``[B, N, H, D]``
projections of the U-Net arrive as transposed views without a copy; the
output is allocated with the query's strides. Only a tensor whose head-dim
stride is not 1, or whose strides or address break 16-byte loads, is made
contiguous first.
"""

from __future__ import annotations

import math

import torch

from flashattn_tpu_torch.ops.oracle import (
    DEFAULT_MASK_VALUE,
    _expand_kv,
    _full_f32_matmul,
    attention_reference_with_lse,
)
from flashattn_tpu_torch.utils import native

MAX_HEAD_DIM = 256


def pair_mask(Nq: int, Nk: int, *, kv_valid_len: int, causal: bool, segment_ids,
              device) -> torch.Tensor:
    """The (query, key) pairs that attend, ``[B or 1, 1, Nq, Nk]`` bool: keys
    below ``kv_valid_len``; with ``causal``, ``kv_pos <= q_pos`` (top-left,
    zero offsets); with ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])``,
    equal ids. The masks AND-compose, as in the kernels."""
    cols = torch.arange(Nk, device=device)
    keep = (cols < kv_valid_len)[None, :].expand(Nq, Nk)
    if causal:
        keep = keep & (cols[None, :] <= torch.arange(Nq, device=device)[:, None])
    keep = keep[None, None]
    if segment_ids is not None:
        seg_q, seg_kv = segment_ids
        keep = keep & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return keep


def fwd_reference(q, k, v, *, scale: float, kv_valid_len: int | None = None,
                  causal: bool = False, segment_ids=None):
    """Plain PyTorch K1: ``(O, LSE)`` for ``q [B,Hq,Nq,D]``, ``k/v [B,Hkv,Nk,D]``.

    The exact f32 oracle over the first ``kv_valid_len`` keys (the kernel's
    finite mask value gives those past it a weight of exactly 0); ``causal``
    masks ``kv_pos > q_pos``, top-left aligned (zero offsets);
    ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])`` lets a pair attend only
    when its ids are equal. LSE is the natural-log row log-sum-exp in f32, O
    is in ``q.dtype``. A row with no key to attend (``kv_valid_len == 0``, or
    none of its segment) is dead: O = 0 and LSE = ln2 * mask value, the
    kernel's convention.
    """
    kv_valid_len = k.shape[2] if kv_valid_len is None else kv_valid_len
    if segment_ids is not None:
        return _masked_reference(q, k, v, scale=scale, keep=pair_mask(
            q.shape[2], k.shape[2], kv_valid_len=kv_valid_len, causal=causal,
            segment_ids=segment_ids, device=q.device))
    if kv_valid_len == 0:
        lse = torch.full(q.shape[:3], math.log(2.0) * DEFAULT_MASK_VALUE,
                         dtype=torch.float32, device=q.device)
        return torch.zeros_like(q), lse
    return attention_reference_with_lse(
        q, k[:, :, :kv_valid_len], v[:, :, :kv_valid_len], scale=scale, causal=causal)


def _masked_reference(q, k, v, *, scale, keep):
    """The exact f32 ``(O, LSE)`` over the pairs of ``keep``, dead rows as the
    kernel stores them."""
    kf, vf = _expand_kv(k, v, q.shape[1])
    with _full_f32_matmul():
        s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
        s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        lse = torch.logsumexp(s, dim=-1)
        o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    alive = keep.any(dim=-1)
    lse = torch.where(alive, lse, torch.full_like(lse, math.log(2.0) * DEFAULT_MASK_VALUE))
    o = torch.where(alive[..., None], o, torch.zeros_like(o))
    return o.to(q.dtype), lse


def check_segment_ids(segment_ids, B: int, Nq: int, Nk: int, device):
    """Validate kernel-level ``segment_ids``: None, or ``(seg_q, seg_kv)``
    integer tensors of shapes ``(B, Nq)`` / ``(B, Nk)`` on ``device``."""
    if segment_ids is None:
        return
    for ids, n in zip(segment_ids, (Nq, Nk)):
        if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise ValueError(f"segment ids must be integers, got {ids.dtype}")
        if tuple(ids.shape) != (B, n) or ids.device != device:
            raise ValueError(f"segment ids {tuple(ids.shape)} on {ids.device} must be "
                             f"({B}, {n}) on {device}")


def kernel_segment_ids(segment_ids):
    """``(seg_q, seg_kv)`` as the kernels read them -- int32 with unit stride
    along the sequence -- and the C arguments for them: ``(ids, (seg_q ptr,
    seg_kv ptr), (seg_q batch stride, seg_kv batch stride))``; null pointers
    without segments. Keep ``ids`` alive until the launch is enqueued."""
    if segment_ids is None:
        return None, (None, None), (0, 0)
    ids = tuple(s.to(torch.int32).contiguous() for s in segment_ids)
    return ids, tuple(s.data_ptr() for s in ids), tuple(s.stride(0) for s in ids)


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the kernel can address it (unit head-dim stride, other
    strides multiples of 8 elements, 16-byte aligned), else a contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1))
    return x if ok else x.contiguous()


def fwd(q, k, v, *, scale: float, kv_valid_len: int | None = None, causal: bool = False,
        segment_ids=None):
    """K1: ``(O [B,Hq,Nq,D] in q.dtype, LSE [B,Hq,Nq] f32)``.

    ``causal`` masks ``kv_pos > q_pos``, top-left aligned (zero offsets);
    ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])`` (integers) lets a pair
    attend only when its ids are equal. CPU tensors take :func:`fwd_reference`. CUDA tensors launch the kernel,
    which takes bf16 with ``D % 8 == 0`` and ``D <= 256``; anything else
    raises. ``fwd.launches`` counts kernel launches.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4, got {q.shape}, {k.shape}, {v.shape}")
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} incompatible with q {tuple(q.shape)}")
    if Hq % k.shape[1] != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={k.shape[1]}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    Nk = k.shape[2]
    kv_valid_len = Nk if kv_valid_len is None else int(kv_valid_len)
    if not 0 <= kv_valid_len <= Nk:
        raise ValueError(f"kv_valid_len={kv_valid_len} outside [0, {Nk}]")
    check_segment_ids(segment_ids, B, Nq, Nk, q.device)

    if q.device.type == "cpu":
        return fwd_reference(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                             segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no K1 kernel for device {q.device}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA K1 takes bfloat16, got {q.dtype} (an f32 FMA instantiation "
            "is a ROADMAP queue 2 K1 item)")
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA K1 takes head dims that are multiples of 8 up to "
            f"{MAX_HEAD_DIM}, got D={D} (ROADMAP queue 2 K1 item)")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")

    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    o = torch.empty_like(q)  # preserve_format: keeps q's (e.g. BNHD) strides
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:  # an empty grid is not a valid launch
        return o, lse
    _seg_ids, seg_ptrs, seg_strides = kernel_segment_ids(segment_ids)
    with torch.cuda.device(q.device):
        rc = native.kernels().fa_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *seg_ptrs,
            B, Hq, k.shape[1], Nq, D, kv_valid_len, int(bool(causal)), float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *seg_strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    native.check(rc, "flash_fwd kernel launch")
    fwd.launches += 1
    return o, lse


fwd.launches = 0
