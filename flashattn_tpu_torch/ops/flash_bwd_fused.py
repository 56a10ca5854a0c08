"""Single-pass FlashAttention-2 backward: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/flash_bwd_fused.py: kernel K3 (``_bwd_fused_kernel``)
and, with ``causal``, K4 (``_bwd_causal_resident_kernel``, the banded
whole-sequence route), for no bias, KV tail, GQA. The kernel is
``csrc/flash_bwd.cu``; its header says what bounds it and what it leaves for
later. :func:`bwd` launches it for CUDA tensors and computes the plain
:func:`bwd_reference` for CPU tensors -- the device of the input decides, and
a CUDA tensor never reaches the plain version.

Both return f32 gradients with dK/dV per *query* head (``[B, Hq, Nk, D]``);
``ops/flash.py`` reduces them over the query heads of each KV head and casts,
as the JAX package's ``_flash_core_bwd`` does.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.flash_fwd import _kernel_ready
from flashattn_tpu_torch.ops.oracle import _expand_kv, _full_f32_matmul
from flashattn_tpu_torch.utils import native

MAX_HEAD_DIM = 128


def bwd_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                  kv_valid_len: int | None = None):
    """Plain PyTorch K3: ``(dQ [B,Hq,Nq,D], dK, dV [B,Hq,Nk,D])``, all f32.

    The formulas of the JAX package's ``_bwd_xla_quadrant``
    (P = exp(S·scale − LSE), dS = P (dP − Δ) scale, dV = Pᵀ dO, dK = dSᵀ Q,
    dQ = dS K) over K/V expanded to the query heads, with P = 0 for pairs
    that the forward masked: ``kv_pos > q_pos`` when ``causal`` (top-left,
    zero offsets) and keys at or past ``kv_valid_len``, whose dK/dV are 0.
    """
    H, Nk = q.shape[1], k.shape[2]
    kv_valid_len = Nk if kv_valid_len is None else kv_valid_len
    kf, vf = _expand_kv(k, v, H)
    qf, dof = q.float(), do.float()
    with _full_f32_matmul():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        keep = torch.arange(Nk, device=q.device)[None, :] < kv_valid_len
        if causal:
            keep = keep & (torch.arange(Nk, device=q.device)[None, :]
                           <= torch.arange(q.shape[2], device=q.device)[:, None])
        p = torch.where(keep, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - delta.float()[..., None]) * scale
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
        dq = torch.matmul(ds, kf)
    return dq, dk, dv


def bwd(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
        kv_valid_len: int | None = None):
    """K3/K4: ``(dQ [B,Hq,Nq,D], dK, dV [B,Hq,Nk,D])`` in f32.

    ``q``/``do`` ``[B,Hq,Nq,D]``, ``k``/``v`` ``[B,Hkv,Nk,D]`` in one dtype;
    ``lse`` (natural log, from the forward) and ``delta`` = rowsum(dO·O),
    ``[B,Hq,Nq]`` f32. CPU tensors take :func:`bwd_reference`. CUDA tensors
    launch the kernel, which takes bf16 with ``D % 8 == 0`` and ``D <= 128``;
    anything else raises. ``bwd.launches`` counts kernel launches.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or do.shape != q.shape:
        raise ValueError(f"q/k/v/do must be rank-4 with do like q, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(do.shape)}")
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} incompatible with q {tuple(q.shape)}")
    if Hq % k.shape[1] != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={k.shape[1]}")
    if lse.shape != (B, Hq, Nq) or delta.shape != (B, Hq, Nq):
        raise ValueError(f"lse {tuple(lse.shape)} / delta {tuple(delta.shape)} must be {(B, Hq, Nq)}")
    if len({x.dtype for x in (q, k, v, do)}) != 1:
        raise ValueError(f"q/k/v/do dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    if len({x.device for x in (q, k, v, do, lse, delta)}) != 1:
        raise ValueError("q/k/v/do/lse/delta must be on one device")
    Nk = k.shape[2]
    kv_valid_len = Nk if kv_valid_len is None else int(kv_valid_len)
    if not 0 <= kv_valid_len <= Nk:
        raise ValueError(f"kv_valid_len={kv_valid_len} outside [0, {Nk}]")

    if q.device.type == "cpu":
        return bwd_reference(q, k, v, do, lse, delta, scale=scale, causal=causal,
                             kv_valid_len=kv_valid_len)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no K3 kernel for device {q.device}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA K3 takes bfloat16, got {q.dtype} (an f32 instantiation is a "
            "ROADMAP queue 2 K3 item)")
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA K3 takes head dims that are multiples of 8 up to {MAX_HEAD_DIM}, "
            f"got D={D} (ROADMAP queue 2, K3 head dims above 128)")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")

    q, k, v, do = (_kernel_ready(x) for x in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((B, Hq, Nq, D), **f32)  # accumulated with atomics
    dk = torch.empty((B, Hq, Nk, D), **f32)
    dv = torch.empty((B, Hq, Nk, D), **f32)
    if Nq == 0 or Nk == 0 or B == 0 or Hq == 0:  # an empty grid is not a valid launch
        return dq, dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        rc = native.kernels().fa_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, k.shape[1], Nq, Nk, D, kv_valid_len, int(bool(causal)), float(scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    native.check(rc, "flash_bwd kernel launch")
    bwd.launches += 1
    return dq, dk, dv


bwd.launches = 0
