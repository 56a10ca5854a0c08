"""FlashAttention-2 forward: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/flash_fwd.py: kernel K1 (``_fwd_kernel``) with KV
tail, GQA, an optional causal mask, an optional sliding window, optional
segment ids (packed sequences), an optional additive bias, optional logit
soft-capping, and int8 / fp8 e4m3 K/V with per-token f32 scales dequantized
in the kernel (the serving path of ops/quant.py); the causal mask and the
window also cover K2 (``_fwd_causal_resident_kernel`` and
``fwd_macro_padded``, the whole-sequence banded routes). The kernel body is
``csrc/fwd_tile.cuh`` (its header says what bounds it and what it leaves for
later), instantiated per option family in ``csrc/flash_fwd*.cu``. :func:`fwd` launches it for CUDA tensors and
computes the plain :func:`fwd_reference` for CPU tensors -- the device of the
input decides, and a CUDA tensor never reaches the plain version.

Strides: the kernel takes (batch, head, seq) strides, so the ``[B, N, H, D]``
projections of the models and their KV caches arrive as transposed views
without a copy; the output is allocated with the query's strides. Only a
tensor whose head-dim stride is not 1, or whose strides or address break the
kernel's 8-element loads, is made contiguous first. The bias is read with
stride 0 on its broadcast dims and the scales through their own strides, so
neither is ever expanded.
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
# K/V element types of the kernel: the kv_dtype code of the C entry fa_fwd.
KV_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_LOG2E = 1.0 / math.log(2.0)
_ROADMAP_K1 = "ROADMAP queue 2, K1 options"


def check_window(window):
    """A kernel-level ``window``: None, or ``(left, right)`` as two ints
    (a negative bound is no bound on that side), as the JAX function
    normalises it; raises ValueError otherwise."""
    if window is None:
        return None
    window = tuple(window)
    if len(window) != 2:
        raise ValueError(f"window must be (left, right), got {window!r}")
    return tuple(int(w) for w in window)


def check_softcap(softcap):
    """A kernel-level ``softcap``: None, or a positive float; raises
    ValueError otherwise."""
    if softcap is None:
        return None
    if not float(softcap) > 0:
        raise ValueError(f"logit_softcap must be positive, got {softcap!r}")
    return float(softcap)


def kernel_window(window) -> tuple[int, int]:
    """``(wl, wr)`` as the kernels' C entries take them: -1 for no bound."""
    if window is None:
        return -1, -1
    return tuple(w if w >= 0 else -1 for w in window)


def pair_mask(Nq: int, Nk: int, *, kv_valid_len: int, causal: bool, segment_ids,
              device, window=None) -> torch.Tensor:
    """The (query, key) pairs that attend, ``[B or 1, 1, Nq, Nk]`` bool: keys
    below ``kv_valid_len``; with ``causal``, ``kv_pos <= q_pos`` (top-left,
    zero offsets); with ``window = (left, right)``, ``q_pos - left <= kv_pos
    <= q_pos + right`` (absolute positions, a negative bound being none);
    with ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])``, equal ids. The
    masks AND-compose, as in the kernels."""
    cols = torch.arange(Nk, device=device)[None, :]
    rows = torch.arange(Nq, device=device)[:, None]
    keep = (cols < kv_valid_len).expand(Nq, Nk)
    if causal:
        keep = keep & (cols <= rows)
    wl, wr = kernel_window(window)
    if wl >= 0:
        keep = keep & (cols >= rows - wl)
    if wr >= 0:
        keep = keep & (cols <= rows + wr)
    keep = keep[None, None]
    if segment_ids is not None:
        seg_q, seg_kv = segment_ids
        keep = keep & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return keep


def fwd_reference(q, k, v, *, scale: float, kv_valid_len: int | None = None,
                  causal: bool = False, segment_ids=None, bias=None, k_scale=None,
                  v_scale=None, window=None, softcap=None):
    """Plain PyTorch K1: ``(O, LSE)`` for ``q [B,Hq,Nq,D]``, ``k/v [B,Hkv,Nk,D]``.

    The exact f32 oracle over the first ``kv_valid_len`` keys (the kernel's
    finite mask value gives those past it a weight of exactly 0); ``causal``
    masks ``kv_pos > q_pos``, top-left aligned (zero offsets); ``window =
    (left, right)`` keeps ``q_pos - left <= kv_pos <= q_pos + right``
    (absolute positions, a negative bound being none);
    ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])`` lets a pair attend only
    when its ids are equal; ``softcap`` caps the scaled scores at
    ``softcap · tanh(s / softcap)``; ``bias`` (broadcastable to
    ``[B,Hq,Nq,Nk]``) is added to the scaled (and capped) scores in f32
    before the masks; int8 / fp8 ``k``/``v`` with ``k_scale``/``v_scale``
    ``[B,Hkv,Nk]`` are dequantized to f32 first (``x · scale``). LSE is the
    natural-log row log-sum-exp in f32, O is in ``q.dtype``. A row with no key
    to attend (``kv_valid_len == 0``, none of its segment, or none in its
    window) is dead: O = 0 and LSE = ln2 * mask value, the kernel's
    convention.
    """
    if k_scale is not None:
        k = k.float() * k_scale.float()[..., None]
        v = v.float() * v_scale.float()[..., None]
    kv_valid_len = k.shape[2] if kv_valid_len is None else kv_valid_len
    if (segment_ids is not None or bias is not None or window is not None
            or softcap is not None):
        return _masked_reference(q, k, v, scale=scale, bias=bias, softcap=softcap,
                                 keep=pair_mask(q.shape[2], k.shape[2],
                                                kv_valid_len=kv_valid_len, causal=causal,
                                                segment_ids=segment_ids, device=q.device,
                                                window=window))
    if kv_valid_len == 0:
        lse = torch.full(q.shape[:3], math.log(2.0) * DEFAULT_MASK_VALUE,
                         dtype=torch.float32, device=q.device)
        return torch.zeros_like(q), lse
    return attention_reference_with_lse(
        q, k[:, :, :kv_valid_len], v[:, :, :kv_valid_len], scale=scale, causal=causal)


def _masked_reference(q, k, v, *, scale, keep, bias=None, softcap=None):
    """The exact f32 ``(O, LSE)`` over the pairs of ``keep``, with the scores
    capped by ``softcap`` and then ``bias`` added before the mask, dead rows
    as the kernel stores them. A row is dead when it keeps no pair or, as in
    the kernel (csrc/fwd_tile.cuh), when its largest score is at or below
    half the mask value in the log2 domain: a padding mask turned additive
    (``DEFAULT_MASK_VALUE`` on every key of the row) leaves nothing to
    attend."""
    kf, vf = _expand_kv(k, v, q.shape[1])
    with _full_f32_matmul():
        s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if bias is not None:
            s = s + bias.float()
        s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        lse = torch.logsumexp(s, dim=-1)
        o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    alive = keep.any(dim=-1)
    if bias is not None:
        alive = alive & (s.amax(dim=-1) * _LOG2E > 0.5 * DEFAULT_MASK_VALUE)
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


def check_bias(bias, B: int, Hq: int, Nq: int, Nk: int, device):
    """Validate a kernel-level ``bias``: None, or a floating tensor of shape
    ``(B|1, Hq|1, Nq|1, Nk)`` on ``device``."""
    if bias is None:
        return
    if bias.ndim != 4 or not bias.dtype.is_floating_point:
        raise ValueError(f"bias must be a rank-4 floating tensor, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    Bb, Hb, Nqb, Nkb = bias.shape
    if Bb not in (1, B) or Hb not in (1, Hq) or Nqb not in (1, Nq) or Nkb != Nk:
        raise ValueError(f"bias {tuple(bias.shape)} must be (1|{B}, 1|{Hq}, 1|{Nq}, {Nk})")
    if bias.device != device:
        raise ValueError(f"bias on {bias.device}, q on {device}")


def kernel_bias(bias):
    """``bias`` as the kernel reads it -- f32 (cast once, as the TPU kernel's
    ``.astype(jnp.float32)``), unit column stride -- and its (batch, head,
    row) strides, 0 on broadcast dims, so a ``[1, 1, 1, Nk]`` bias is never
    expanded. ``(None, (0, 0, 0))`` without bias."""
    if bias is None:
        return None, (0, 0, 0)
    bias = bias.to(torch.float32)
    if bias.stride(-1) != 1:
        bias = bias.contiguous()
    return bias, tuple(0 if n == 1 else s for s, n in zip(bias.stride()[:3], bias.shape[:3]))


def _check_quant(k, v, k_scale, v_scale, B: int, Hkv: int, Nk: int):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        if k.dtype in QUANT_DTYPES or v.dtype in QUANT_DTYPES:
            raise ValueError(f"{k.dtype} K/V need k_scale and v_scale")
        return
    if k.dtype not in QUANT_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"k_scale/v_scale take int8 or float8_e4m3fn K/V, got {k.dtype}, "
                         f"{v.dtype}")
    for s in (k_scale, v_scale):
        if tuple(s.shape) != (B, Hkv, Nk) or s.device != k.device:
            raise ValueError(f"K/V scales {tuple(s.shape)} on {s.device} must be "
                             f"({B}, {Hkv}, {Nk}) on {k.device}")


def _kernel_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself if the kernel can address it -- unit head-dim stride,
    other strides multiples of 8 elements, an address aligned to 8 elements
    (16 bytes for bf16, 8 for int8 / fp8: the width of one load) -- else a
    contiguous copy."""
    ok = (x.stride(-1) == 1 and x.data_ptr() % (8 * x.element_size()) == 0
          and all(s % 8 == 0 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1))
    return x if ok else x.contiguous()


def fwd(q, k, v, *, scale: float, kv_valid_len: int | None = None, causal: bool = False,
        segment_ids=None, bias=None, k_scale=None, v_scale=None, window=None, softcap=None):
    """K1: ``(O [B,Hq,Nq,D] in q.dtype, LSE [B,Hq,Nq] f32)``.

    ``causal`` masks ``kv_pos > q_pos``, top-left aligned (zero offsets);
    ``window = (left, right)`` keeps ``q_pos - left <= kv_pos <= q_pos +
    right`` (a negative bound is none; with ``causal`` the right bound is 0);
    ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])`` (integers) lets a pair
    attend only when its ids are equal; ``softcap`` (a positive float) caps
    the scaled scores at ``softcap · tanh(s / softcap)``; ``bias``
    ``[B|1, Hq|1, Nq|1, Nk]`` is added to the (capped) scores; int8 /
    float8_e4m3fn ``k``/``v`` take per-token ``k_scale``/``v_scale``
    ``[B, Hkv, Nk]`` and are dequantized in the kernel (not with a softcap).
    CPU tensors take :func:`fwd_reference`. CUDA tensors launch the kernel,
    which takes a bf16 ``q`` (and bf16, int8 or fp8 K/V) with ``D % 8 == 0``
    and ``D <= 256``, and segment ids or a window only without bias or
    quantized K/V; anything else raises. ``fwd.launches`` counts every kernel launch;
    ``fwd.launches_bias`` those of bf16 K/V with a bias,
    ``fwd.launches_int8`` / ``fwd.launches_fp8`` those of quantized K/V (with
    or without a bias), ``fwd.launches_window`` those with a window and
    ``fwd.launches_softcap`` those with a softcap.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4, got {q.shape}, {k.shape}, {v.shape}")
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} incompatible with q {tuple(q.shape)}")
    Hkv, Nk = k.shape[1], k.shape[2]
    if Hq % Hkv != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={Hkv}")
    _check_quant(k, v, k_scale, v_scale, B, Hkv, Nk)
    if k_scale is None and (q.dtype != k.dtype or q.dtype != v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    kv_valid_len = Nk if kv_valid_len is None else int(kv_valid_len)
    if not 0 <= kv_valid_len <= Nk:
        raise ValueError(f"kv_valid_len={kv_valid_len} outside [0, {Nk}]")
    check_segment_ids(segment_ids, B, Nq, Nk, q.device)
    check_bias(bias, B, Hq, Nq, Nk, q.device)
    window, softcap = check_window(window), check_softcap(softcap)
    if softcap is not None and k_scale is not None:
        raise ValueError("logit_softcap is not supported with quantized K/V (the JAX "
                         "flash_attention_quantized has no softcap path)")

    if q.device.type == "cpu":
        return fwd_reference(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                             segment_ids=segment_ids, bias=bias, k_scale=k_scale,
                             v_scale=v_scale, window=window, softcap=softcap)
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
    if segment_ids is not None and (bias is not None or k_scale is not None):
        raise NotImplementedError(
            f"the CUDA K1 takes segment ids without bias or quantized K/V ({_ROADMAP_K1})")
    windowed = kernel_window(window) != (-1, -1)
    if windowed and (bias is not None or k_scale is not None):
        raise NotImplementedError(
            f"the CUDA K1 takes a window without bias or quantized K/V ({_ROADMAP_K1})")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")

    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    o = torch.empty_like(q)  # preserve_format: keeps q's (e.g. BNHD) strides
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:  # an empty grid is not a valid launch
        return o, lse
    _seg_ids, seg_ptrs, seg_strides = kernel_segment_ids(segment_ids)
    bias, bias_strides = kernel_bias(bias)
    scales = (None, None) if k_scale is None else (k_scale.float(), v_scale.float())
    scale_strides = [x for s in scales for x in (s.stride() if s is not None else (0, 0, 0))]
    ptrs = [None if x is None else x.data_ptr() for x in (bias, *scales)]
    with torch.cuda.device(q.device):
        rc = native.kernels().fa_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *seg_ptrs,
            *ptrs, KV_DTYPE_CODE[k.dtype], B, Hq, Hkv, Nq, D, kv_valid_len,
            int(bool(causal)), *kernel_window(window), float(scale), softcap or 0.0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *seg_strides, *bias_strides, *scale_strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    native.check(rc, "flash_fwd kernel launch")
    fwd.launches += 1
    if k.dtype == torch.int8:
        fwd.launches_int8 += 1
    elif k.dtype == torch.float8_e4m3fn:
        fwd.launches_fp8 += 1
    elif bias is not None:
        fwd.launches_bias += 1
    if windowed:
        fwd.launches_window += 1
    if softcap is not None:
        fwd.launches_softcap += 1
    return o, lse


fwd.launches = 0
fwd.launches_bias = 0
fwd.launches_int8 = 0
fwd.launches_fp8 = 0
fwd.launches_window = 0
fwd.launches_softcap = 0
