"""Exact-softmax attention oracle (port of flashattn_tpu/ops/oracle.py).

A direct, unfused softmax(QK^T·s + bias)V, the ground truth every kernel and
test is held against. It computes in float32 on the inputs' device, with TF32
matrix products switched off for the duration of the call (and restored
after), so on a GPU the "f32" reference really is f32.

Layout convention throughout the package: canonical ``[B, H, N, D]`` ("BHND").
"""

from __future__ import annotations

import contextlib

import torch

# Finite large-negative mask value. -inf produces NaN via exp(-inf - (-inf)) in
# fully-masked rows; a fraction of float32 max stays finite in every step.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _expand_kv(k, v, H):
    kf, vf = k.float(), v.float()
    Hkv = k.shape[1]
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"GQA requires Hkv | H, got H={H} Hkv={Hkv}")
        kf = kf.repeat_interleave(H // Hkv, dim=1)
        vf = vf.repeat_interleave(H // Hkv, dim=1)
    return kf, vf


def position_mask(Nq: int, Nk: int, *, q_offset: int = 0, kv_offset: int = 0,
                  causal: bool = False, window: tuple[int, int] | None = None,
                  device=None) -> torch.Tensor:
    """The (query, key) pairs that attend by position, ``[1, 1, Nq, Nk]``
    bool: query ``i`` sits at ``q_offset + i`` and key ``j`` at ``kv_offset +
    j``; ``causal`` keeps ``kv_pos <= q_pos``, ``window = (left, right)``
    keeps ``q_pos - left <= kv_pos <= q_pos + right`` (-1: no bound)."""
    q_pos = torch.arange(Nq, device=device)[:, None] + q_offset
    kv_pos = torch.arange(Nk, device=device)[None, :] + kv_offset
    keep = torch.ones((1, 1, Nq, Nk), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (kv_pos <= q_pos)
    if window is not None:
        wl, wr = window
        if wl >= 0:
            keep = keep & (kv_pos >= q_pos - wl)
        if wr >= 0:
            keep = keep & (kv_pos <= q_pos + wr)
    return keep


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    scale: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: tuple[int, int] | None = None,
    segment_ids: tuple[torch.Tensor, torch.Tensor] | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Unfused exact attention in float32, `[B, H, N, D]` layout.

    Args:
      q: ``[B, H, Nq, D]``.
      k: ``[B, Hkv, Nk, D]`` — ``Hkv`` may divide ``H`` (GQA).
      v: ``[B, Hkv, Nk, D]``.
      bias: optional additive logits bias broadcastable to ``[B, H, Nq, Nk]``.
      causal: mask position pairs where ``kv_pos > q_pos`` (absolute positions,
        i.e. after adding the offsets).
      scale: softmax scale; default ``D ** -0.5``.
      q_offset / kv_offset: absolute-position offsets of the local q/kv chunks.
      window: optional sliding window ``(left, right)``: position pair (i, j)
        may attend iff ``i - left <= j <= i + right`` (absolute positions);
        -1 disables that side. Composes with ``causal``.
      segment_ids: packed-sequence masking, ``(q_ids [B, Nq], kv_ids
        [B, Nk])``: (i, j) attends iff ``q_ids[i] == kv_ids[j]``. A
        fully-masked row outputs exact zeros (the package-wide dead-row
        convention).
      logit_softcap: cap the scaled logits as ``cap·tanh(s/cap)`` before the
        bias and masks (Gemma-2 convention).
    Returns:
      ``[B, H, Nq, D]`` in ``q.dtype``.
    """
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if scale is None:
        scale = float(D) ** -0.5
    kf, vf = _expand_kv(k, v, H)
    with _full_f32_matmul():
        s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
        if logit_softcap is not None:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        if bias is not None:
            s = s + bias.float()
        row_alive = None
        if causal or window is not None or segment_ids is not None:
            keep = position_mask(Nq, Nk, q_offset=q_offset, kv_offset=kv_offset,
                                 causal=causal, window=window, device=q.device)
            if segment_ids is not None:
                seg_q, seg_kv = segment_ids
                keep = keep & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
            row_alive = keep.any(dim=-1, keepdim=True)
            s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        p = torch.softmax(s, dim=-1)
        o = torch.matmul(p, vf)
    if row_alive is not None:
        o = torch.where(row_alive, o, torch.zeros_like(o))
    return o.to(q.dtype)


def attention_reference_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    scale: float | None = None,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`attention_reference` but also returns the row log-sum-exp
    ``[B, H, Nq]`` (f32, natural log) -- the merge primitive for partial
    attention results: ``L = logaddexp(L1, L2); O = e^{L1-L} O1 + e^{L2-L} O2``.
    """
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    if scale is None:
        scale = float(D) ** -0.5
    kf, vf = _expand_kv(k, v, H)
    with _full_f32_matmul():
        s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias.float()
        if causal:
            q_pos = torch.arange(Nq, device=q.device)[:, None] + q_offset
            kv_pos = torch.arange(Nk, device=q.device)[None, :] + kv_offset
            s = torch.where(kv_pos <= q_pos, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        lse = torch.logsumexp(s, dim=-1)
        o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    return o.to(q.dtype), lse
