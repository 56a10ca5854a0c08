"""Two-kernel FlashAttention-2 backward: the CUDA kernels' wrappers and their plain versions.

Port of flashattn_tpu/ops/flash_bwd.py: kernels K5 (``_dkv_kernel``, dK and
dV) and K6 (``_dq_kernel``, dQ and dbias), for KV tail, GQA, causal, a sliding
window, segment ids (packed sequences), logit soft-capping and an additive
bias (not with a window or segment ids, as K1 takes it). Both kernels' C
entries are in ``csrc/flash_bwd_split.cu``; its header says what bounds them
and what they leave for later. :func:`dkv` and :func:`dq` launch them for CUDA tensors and
compute the plain :func:`dkv_reference` / :func:`dq_reference` for CPU
tensors -- the device of the input decides, and a CUDA tensor never reaches
the plain version.

Both recompute P and dS from the forward's LSE and Δ (:func:`recompute_p_ds`,
the JAX ``_recompute_p_ds``) and return f32 gradients: dK/dV per *query* head
(``[B, Hq, Nk, D]``), which ``ops/flash.py`` reduces over the query heads of
each KV head and casts, dQ ``[B, Hq, Nq, D]``, written once and so
deterministic (K3's dQ is summed by atomics), and on request the full f32
dbias ``[B, Hq, Nq, Nk]``, which ``ops/flash.py`` reduces over the bias's
broadcast dims.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.flash_fwd import (
    _kernel_ready,
    check_bias,
    check_segment_ids,
    check_softcap,
    check_window,
    kernel_bias,
    kernel_segment_ids,
    kernel_window,
    pair_mask,
)
from flashattn_tpu_torch.ops.oracle import _expand_kv, _full_f32_matmul
from flashattn_tpu_torch.utils import native

MAX_HEAD_DIM = 128


def recompute_p_ds(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                   kv_valid_len: int | None = None, segment_ids=None, window=None,
                   softcap=None, bias=None):
    """``(P, dS, Q, K, V, dO, dL)`` in f32, K/V expanded to the query heads.

    P = exp(S·scale + bias − LSE), dL = P (dP − Δ) and dS = dL · scale,
    ``[B, Hq, Nq, Nk]``, with P = 0 exactly for pairs that the forward
    masked (:func:`pair_mask`: keys at or past ``kv_valid_len``, ``kv_pos >
    q_pos`` when ``causal``, pairs outside ``window``, unequal segment ids),
    so a dead row contributes nothing. ``bias`` (broadcastable to
    ``[B, Hq, Nq, Nk]``) is added to the scaled, capped logits, as the JAX
    ``_recompute_p_ds`` adds it (flash_bwd.py:97-98). With ``softcap``:
    t = tanh(S·scale / softcap), P = exp(softcap·t + bias − LSE) and dS gains
    the cap's Jacobian, dS = dL (1 − t²) scale. dL, the gradient of the
    capped logits, is the JAX kernel's dbias (flash_bwd.py:135, 300-302):
    the bias adds after the cap, so it carries neither the scale nor the
    Jacobian.
    """
    H, Nq, Nk = q.shape[1], q.shape[2], k.shape[2]
    kv_valid_len = Nk if kv_valid_len is None else kv_valid_len
    kf, vf = _expand_kv(k, v, H)
    qf, dof = q.float(), do.float()
    keep = pair_mask(Nq, Nk, kv_valid_len=kv_valid_len, causal=causal,
                     segment_ids=segment_ids, device=q.device, window=window)
    with _full_f32_matmul():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        jac = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            jac = 1.0 - t * t
            s = softcap * t
        if bias is not None:
            s = s + bias.float()
        p = torch.where(keep, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
        dp = torch.matmul(dof, vf.transpose(-1, -2))
    dl = p * (dp - delta.float()[..., None])
    ds = dl * scale if jac is None else dl * jac * scale
    return p, ds, qf, kf, vf, dof, dl


def dkv_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                  kv_valid_len: int | None = None, segment_ids=None, window=None,
                  softcap=None, bias=None):
    """Plain PyTorch K5: ``(dK, dV)`` ``[B, Hq, Nk, D]`` f32, per query head:
    dV = Pᵀ dO, dK = dSᵀ Q (:func:`recompute_p_ds`)."""
    p, ds, qf, _, _, dof, _ = recompute_p_ds(
        q, k, v, do, lse, delta, scale=scale, causal=causal, kv_valid_len=kv_valid_len,
        segment_ids=segment_ids, window=window, softcap=softcap, bias=bias)
    with _full_f32_matmul():
        return torch.matmul(ds.transpose(-1, -2), qf), torch.matmul(p.transpose(-1, -2), dof)


def dq_reference(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
                 kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
                 bias=None, want_dbias: bool = False):
    """Plain PyTorch K6: dQ = dS K, ``[B, Hq, Nq, D]`` f32; with
    ``want_dbias``, ``(dQ, dbias)`` where dbias = P (dP − Δ) is the full f32
    ``[B, Hq, Nq, Nk]``, 0 on masked pairs (:func:`recompute_p_ds`)."""
    _, ds, _, kf, _, _, dl = recompute_p_ds(
        q, k, v, do, lse, delta, scale=scale, causal=causal, kv_valid_len=kv_valid_len,
        segment_ids=segment_ids, window=window, softcap=softcap, bias=bias)
    with _full_f32_matmul():
        dq_ = torch.matmul(ds, kf)
    return (dq_, dl) if want_dbias else dq_


def check_args(q, k, v, do, lse, delta, kv_valid_len, segment_ids=None) -> int:
    """Validate a backward call's arguments (shared by K3, K5 and K6); returns
    ``kv_valid_len`` with None resolved to Nk."""
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
    check_segment_ids(segment_ids, B, Nq, Nk, q.device)
    return kv_valid_len


def check_kernel_args(q, name: str) -> None:
    """Raise for what the CUDA backward kernels (K3, K5, K6) do not take."""
    B, Hq, _, D = q.shape
    if q.device.type != "cuda":
        raise NotImplementedError(f"no {name} kernel for device {q.device}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"the CUDA {name} takes bfloat16, got {q.dtype} (an f32 instantiation is a "
            "ROADMAP queue 2 item)")
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA {name} takes head dims that are multiples of 8 up to {MAX_HEAD_DIM}, "
            f"got D={D} (ROADMAP queue 2, backward head dims above 128)")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")


def _split_kwargs(q, k, v, do, lse, delta, *, scale, causal, kv_valid_len, segment_ids,
                  window, softcap, bias) -> dict:
    """Validate a :func:`dkv` / :func:`dq` call and return the keyword
    arguments of its kernel or plain version, ``kv_valid_len`` resolved."""
    kv_valid_len = check_args(q, k, v, do, lse, delta, kv_valid_len, segment_ids)
    check_bias(bias, q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.device)
    return dict(scale=scale, causal=causal, kv_valid_len=kv_valid_len, segment_ids=segment_ids,
                window=check_window(window), softcap=check_softcap(softcap), bias=bias)


def _check_split_kernel_args(q, name: str, *, bias, segment_ids, window) -> None:
    check_kernel_args(q, name)
    if bias is not None and (segment_ids is not None or kernel_window(window) != (-1, -1)):
        raise NotImplementedError(
            f"the CUDA {name} takes a bias without segment ids or a window, as K1 does "
            "(ROADMAP queue 2, K1 options)")


def _launch(entry: str, q, k, v, do, lse, delta, outs, *, scale, causal, kv_valid_len,
            segment_ids, window, softcap, bias) -> None:
    """Launch K5 or K6 (``entry``) writing ``outs`` (None: a null pointer),
    on q's current stream."""
    B, Hq, Nq, D = q.shape
    q, k, v, do = (_kernel_ready(x) for x in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _seg_ids, seg_ptrs, seg_strides = kernel_segment_ids(segment_ids)
    bias, bias_strides = kernel_bias(bias)
    with torch.cuda.device(q.device):
        rc = getattr(native.kernels(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *seg_ptrs, None if bias is None else bias.data_ptr(),
            *(None if o is None else o.data_ptr() for o in outs),
            B, Hq, k.shape[1], Nq, k.shape[2], D, kv_valid_len, int(bool(causal)),
            *kernel_window(window), float(scale), softcap or 0.0,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], *seg_strides,
            *bias_strides, torch.cuda.current_stream(q.device).cuda_stream,
        )
    native.check(rc, f"{entry} kernel launch")


def dkv(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
        kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
        bias=None):
    """K5: ``(dK, dV)`` ``[B, Hq, Nk, D]`` in f32, per query head.

    ``q``/``do`` ``[B,Hq,Nq,D]``, ``k``/``v`` ``[B,Hkv,Nk,D]`` in one dtype;
    ``lse`` (natural log, from the forward) and ``delta`` = rowsum(dO·O),
    ``[B,Hq,Nq]`` f32; ``segment_ids``, ``window``, ``softcap`` and ``bias``
    (``[B|1, Hq|1, Nq|1, Nk]``) as in ``flash_fwd.fwd``. CPU tensors take
    :func:`dkv_reference`. CUDA tensors launch the kernel, which takes bf16
    with ``D % 8 == 0`` and ``D <= 128``, and a bias without segment ids or a
    window; anything else raises. ``dkv.launches`` counts kernel launches,
    ``dkv.launches_bias`` those with a bias.
    """
    kw = _split_kwargs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       kv_valid_len=kv_valid_len, segment_ids=segment_ids, window=window,
                       softcap=softcap, bias=bias)
    if q.device.type == "cpu":
        return dkv_reference(q, k, v, do, lse, delta, **kw)
    _check_split_kernel_args(q, "K5", bias=bias, segment_ids=segment_ids, window=window)
    B, Hq, Nq, D = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dk = torch.empty((B, Hq, k.shape[2], D), **f32)
    dv = torch.empty((B, Hq, k.shape[2], D), **f32)
    if Nq == 0 or k.shape[2] == 0 or B == 0 or Hq == 0:  # an empty grid is not a valid launch
        return dk.zero_(), dv.zero_()
    _launch("fa_bwd_dkv_bf16", q, k, v, do, lse, delta, (dk, dv), **kw)
    dkv.launches += 1
    if bias is not None:
        dkv.launches_bias += 1
    return dk, dv


def dq(q, k, v, do, lse, delta, *, scale: float, causal: bool = False,
       kv_valid_len: int | None = None, segment_ids=None, window=None, softcap=None,
       bias=None, want_dbias: bool = False):
    """K6: dQ ``[B, Hq, Nq, D]`` in f32, written once (deterministic); with
    ``want_dbias`` (which needs ``bias``), ``(dQ, dbias)``, dbias the full
    f32 ``[B, Hq, Nq, Nk]`` gradient of the bias, P (dP − Δ).

    Arguments as :func:`dkv`. CPU tensors take :func:`dq_reference`; CUDA
    tensors launch the kernel or raise. Without ``want_dbias`` the kernel
    gets a null dbias pointer and writes none. ``dq.launches`` counts kernel
    launches, ``dq.launches_bias`` those with a bias (with or without dbias),
    ``dq.launches_dbias`` those that wrote dbias.
    """
    if want_dbias and bias is None:
        raise ValueError("want_dbias needs a bias")
    kw = _split_kwargs(q, k, v, do, lse, delta, scale=scale, causal=causal,
                       kv_valid_len=kv_valid_len, segment_ids=segment_ids, window=window,
                       softcap=softcap, bias=bias)
    if q.device.type == "cpu":
        return dq_reference(q, k, v, do, lse, delta, want_dbias=want_dbias, **kw)
    _check_split_kernel_args(q, "K6", bias=bias, segment_ids=segment_ids, window=window)
    B, Hq, Nq, D = q.shape
    Nk = k.shape[2]
    out = torch.empty((B, Hq, Nq, D), dtype=torch.float32, device=q.device)
    dbias = None
    if want_dbias:
        # K6 writes the tiles it visits; causal and the KV tail leave others.
        skipped = causal or kw["kv_valid_len"] < Nk
        dbias = (torch.zeros if skipped else torch.empty)(
            (B, Hq, Nq, Nk), dtype=torch.float32, device=q.device)
    if Nq == 0 or Nk == 0 or B == 0 or Hq == 0:  # an empty grid is not a valid launch
        out.zero_()
        return (out, dbias.zero_()) if want_dbias else out
    _launch("fa_bwd_dq_bf16", q, k, v, do, lse, delta, (out, dbias), **kw)
    dq.launches += 1
    if bias is not None:
        dq.launches_bias += 1
    if want_dbias:
        dq.launches_dbias += 1
    return (out, dbias) if want_dbias else out


dkv.launches = 0
dkv.launches_bias = 0
dq.launches = 0
dq.launches_bias = 0
dq.launches_dbias = 0
