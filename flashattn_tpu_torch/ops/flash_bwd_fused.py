"""Single-pass FlashAttention-2 backward: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/flash_bwd_fused.py: kernel K3 (``_bwd_fused_kernel``)
and, with ``causal`` or a ``window``, K4 (``_bwd_causal_resident_kernel`` and
``_bwd_macro_windowed``, the banded whole-sequence routes), for no bias, KV
tail, GQA. Soft-capped gradients, segment ids and a bias take K5 + K6 (or,
after K1's bias route, its backward), as in the JAX package. The kernel is the Hopper TMA + wgmma
backward of ``csrc/flash_bwd_sm90.cu`` (body ``csrc/bwd_sm90_tile.cuh``);
its header says what bounds it; on f32 inputs K3 is the f32 body
``csrc/flash_bwd_f32.cu`` (``flash_bwd._f32_bwd_launch``, shared with the
split route). :func:`bwd` launches it for CUDA tensors and
computes the plain :func:`bwd_reference` for CPU tensors -- the device of the
input decides, and a CUDA tensor never reaches the plain version.

Both return f32 gradients with dK/dV per *query* head (``[B, Hq, Nk, D]``);
``ops/flash.py`` reduces them over the query heads of each KV head and casts,
as the JAX package's ``_flash_core_bwd`` does.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.flash_bwd import (
    SM90_BWD_Q_TILE,
    _f32_bwd_launch,
    _padded_rows,
    check_args,
    check_kernel_args,
    recompute_p_ds,
)
from flashattn_tpu_torch.ops.flash_fwd import (
    _kernel_ready,
    band_offsets,
    check_window,
    kernel_window,
)
from flashattn_tpu_torch.ops.oracle import _full_f32_matmul
from flashattn_tpu_torch.utils import native


def bwd_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                  kv_valid_len: int | None = None, window=None, q_offset: int = 0,
                  kv_offset: int = 0):
    """Plain PyTorch K3: ``(dQ [B,Hq,Nq,D], dK, dV [B,Hq,Nk,D])``, all f32.

    The formulas of the JAX package's ``_bwd_xla_quadrant``
    (P = exp(S·scale − LSE), dS = P (dP − Δ) scale, dV = Pᵀ dO, dK = dSᵀ Q,
    dQ = dS K) over K/V expanded to the query heads, with P = 0 for pairs
    that the forward masked: ``kv_pos > q_pos`` when ``causal`` and pairs
    outside ``window``, in absolute positions ``q_offset + i`` and
    ``kv_offset + j``, and keys at or past ``kv_valid_len``, whose dK/dV are
    0 (``flash_bwd.recompute_p_ds``).
    """
    p, ds, qf, kf, _, dof, _ = recompute_p_ds(q, k, v, do, lse, delta, scale=scale,
                                              causal=causal, kv_valid_len=kv_valid_len,
                                              window=window, q_offset=q_offset,
                                              kv_offset=kv_offset)
    with _full_f32_matmul():
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dk = torch.matmul(ds.transpose(-1, -2), qf)
        dq = torch.matmul(ds, kf)
    return dq, dk, dv


def _launch(lib, q, k, v, do, lse, delta, dq, dk, dv, *, scale, causal, kv_valid_len, window,
            nq_pad, stream, q_offset: int = 0, kv_offset: int = 0) -> int:
    """Call ``lib.fa_bwd_sm90`` with the arguments of one launch (the C
    entry's order, ``native.BWD_SM90_ARGTYPES``); returns its cudaError_t."""
    B, Hq, Nq, D = q.shape
    return lib.fa_bwd_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hq, k.shape[1], Nq,
        k.shape[2], D, kv_valid_len, int(bool(causal)), *kernel_window(window), q_offset,
        kv_offset, nq_pad, float(scale), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], stream)


def bwd(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
        kv_valid_len: int | None = None, window=None, q_offset: int = 0, kv_offset: int = 0):
    """K3/K4: ``(dQ [B,Hq,Nq,D], dK, dV [B,Hq,Nk,D])`` in f32.

    ``q``/``do`` ``[B,Hq,Nq,D]``, ``k``/``v`` ``[B,Hkv,Nk,D]`` in one dtype;
    ``lse`` (natural log, from the forward) and ``delta`` = rowsum(dO·O),
    ``[B,Hq,Nq]`` f32; ``window`` and the offsets as in ``flash_fwd.fwd`` (a
    KV tile that no row reaches writes zero dK / dV). CPU tensors take
    :func:`bwd_reference`. CUDA tensors launch the Hopper kernel, which takes
    bf16 with ``D % 8 == 0`` and ``D <= 128``, or on f32 the f32 body
    (``flash_bwd._f32_bwd_launch``); anything else raises. ``bwd.launches`` counts
    K3 launches on either kernel, ``bwd.launches_sm90`` those of the Hopper
    kernel (every bf16 one).
    """
    kv_valid_len = check_args(q, k, v, do, lse, delta, kv_valid_len)
    window = check_window(window)
    q_offset, kv_offset = band_offsets(causal, window, q_offset, kv_offset)
    if q.device.type == "cpu":
        return bwd_reference(q, k, v, do, lse, delta, scale=scale, causal=causal,
                             kv_valid_len=kv_valid_len, window=window, q_offset=q_offset,
                             kv_offset=kv_offset)
    check_kernel_args(q, "K3")
    if q.dtype == torch.float32:
        out = _f32_bwd_launch(q, k, v, do, lse, delta, scale=scale, causal=causal,
                              kv_valid_len=kv_valid_len, segment_ids=None, window=window,
                              softcap=None, q_offset=q_offset, kv_offset=kv_offset)
        bwd.launches += 1
        return out
    B, Hq, Nq, D = q.shape
    Nk = k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros((B, Hq, Nq, D), **f32)  # added to by one bulk reduction a tile
    dk = torch.empty((B, Hq, Nk, D), **f32)
    dv = torch.empty((B, Hq, Nk, D), **f32)
    if Nq == 0 or Nk == 0 or B == 0 or Hq == 0:  # an empty grid is not a valid launch
        return dq, dk.zero_(), dv.zero_()
    q, k, v, do = (_kernel_ready(x, tma=True) for x in (q, k, v, do))
    nq_pad = -(-Nq // SM90_BWD_Q_TILE) * SM90_BWD_Q_TILE
    lse, delta = _padded_rows(lse, nq_pad), _padded_rows(delta, nq_pad)
    with torch.cuda.device(q.device):
        rc = _launch(native.kernels(), q, k, v, do, lse, delta, dq, dk, dv, scale=scale,
                     causal=causal, kv_valid_len=kv_valid_len, window=window, nq_pad=nq_pad,
                     stream=torch.cuda.current_stream(q.device).cuda_stream, q_offset=q_offset,
                     kv_offset=kv_offset)
    native.check(rc, "flash_bwd_sm90 kernel launch")
    bwd.launches += 1
    bwd.launches_sm90 += 1
    return dq, dk, dv


bwd.launches = 0
bwd.launches_sm90 = 0
