"""Golden model: tiled FlashAttention-2 forward / backward in plain PyTorch.

Port of flashattn_tpu/ops/reference.py, the "mathematically clean spec" that
the kernels are validated against: the forward walks Q tiles and, inside
each, KV tiles with the online softmax's running (m, l) statistics and ``L =
m + log(l)``; the backward recomputes P from the forward's LSE and scales dQ
and dK symmetrically. Masked scores take ``DEFAULT_MASK_VALUE`` (finite, so a
fully masked tile never computes -inf - (-inf)); tails are zero-padded to
whole tiles and cut off again. Everything computes in f32 (TF32 off) on the
inputs' device; nothing on the port's main path calls it.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE, _full_f32_matmul


def _pad_to(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    pad = -x.shape[dim] % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _fwd_tiled(q, k, v, bias, *, causal, scale, block_q, block_k, window=None):
    """``(O in q's dtype, LSE f32)`` of one head-matched [B, H, N, D] call,
    Q tile by Q tile and, inside, KV tile by KV tile."""
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    Tq, Tk = -(-Nq // block_q), -(-Nk // block_k)
    qf = _pad_to(q.float(), 2, block_q) * scale
    kf = _pad_to(k.float(), 2, block_k)
    vf = _pad_to(v.float(), 2, block_k)
    bf = None
    if bias is not None:
        bf = _pad_to(_pad_to(bias.float().expand(B, H, Nq, Nk), 2, block_q), 3, block_k)
    kv_valid = torch.arange(Tk * block_k, device=q.device) < Nk  # padded KV columns
    o = qf.new_empty((B, H, Tq * block_q, D))
    lse = qf.new_empty((B, H, Tq * block_q))
    for qi in range(Tq):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        m = qf.new_full((B, H, block_q), float("-inf"))
        l = qf.new_zeros((B, H, block_q))
        acc = qf.new_zeros((B, H, block_q, D))
        q_pos = qi * block_q + torch.arange(block_q, device=q.device)[:, None]
        for ki in range(Tk):
            cols = slice(ki * block_k, (ki + 1) * block_k)
            with _full_f32_matmul():
                s = torch.matmul(qf[:, :, rows], kf[:, :, cols].transpose(-1, -2))
            if bf is not None:
                s = s + bf[:, :, rows, cols]
            mask = kv_valid[cols][None, :].expand(block_q, block_k)
            if causal or window is not None:
                kv_pos = ki * block_k + torch.arange(block_k, device=q.device)[None, :]
                if causal:
                    mask = mask & (kv_pos <= q_pos)
                if window is not None:
                    wl, wr = window
                    if wl >= 0:
                        mask = mask & (kv_pos >= q_pos - wl)
                    if wr >= 0:
                        mask = mask & (kv_pos <= q_pos + wr)
            s = torch.where(mask, s, torch.full_like(s, DEFAULT_MASK_VALUE))
            # The online softmax update.
            m_next = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next[..., None])
            l = alpha * l + p.sum(-1)
            with _full_f32_matmul():
                acc = acc * alpha[..., None] + torch.matmul(p, vf[:, :, cols])
            m = m_next
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        o[:, :, rows] = acc / l_safe[..., None]
        lse[:, :, rows] = m + torch.log(l_safe)  # L = m + log(l), natural log
    return o[:, :, :Nq].to(q.dtype), lse[:, :, :Nq]


def flash_attention_reference(q, k, v, *, bias=None, causal: bool = False,
                              scale: float | None = None, block_q: int = 128,
                              block_k: int = 128, return_lse: bool = False,
                              window: tuple[int, int] | None = None):
    """Tiled online-softmax forward (golden model), ``[B, H, N, D]`` layout.

    The function of ``ops.oracle.attention_reference``, computed tile by tile
    with running (m, l) statistics -- the algorithm the kernels implement, so
    a difference between the two isolates a kernel fault from an algorithm
    fault. K / V with fewer heads (GQA) are repeated to q's; ``bias``
    broadcasts to ``[B, H, Nq, Nk]``; ``causal`` is top-left aligned;
    ``window = (left, right)`` keeps ``i - left <= j <= i + right`` (-1: no
    bound). Tiles are ``min(block, N)`` rows. Returns O in q's dtype, and
    with ``return_lse`` also the f32 LSE ``[B, H, Nq]``.
    """
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    H, Hkv = q.shape[1], k.shape[1]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    o, lse = _fwd_tiled(q, k, v, bias, causal=causal, scale=float(scale),
                        block_q=min(block_q, max(q.shape[2], 1)),
                        block_k=min(block_k, max(k.shape[2], 1)), window=window)
    return (o, lse) if return_lse else o


def flash_attention_reference_bwd(q, k, v, o, lse, do, *, bias=None, causal: bool = False,
                                  scale: float | None = None):
    """Recompute-based backward (golden model) with symmetric scaling: Δ =
    rowsum(dO ∘ O); P = exp(S − L); dV = Pᵀ dO; dP = dO Vᵀ; dS = P ∘ (dP −
    Δ); dQ = scale · dS K; dK = scale · dSᵀ Q. Unfused (it materialises S): a
    spec for small shapes, head-matched q / k / v. Returns ``(dQ, dK, dV)``
    in the inputs' dtypes, and with a bias also dbias = dS, the full f32
    ``[B, H, Nq, Nk]``."""
    Nq, Dh = q.shape[2], q.shape[3]
    Nk = k.shape[2]
    if scale is None:
        scale = float(Dh) ** -0.5
    qf, kf, vf, dof, of = (x.float() for x in (q, k, v, do, o))
    with _full_f32_matmul():
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias.float()
        if causal:
            keep = torch.arange(Nk, device=q.device)[None, :] <= torch.arange(
                Nq, device=q.device)[:, None]
            s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        p = torch.exp(s - lse.float()[..., None])
        d = (dof * of).sum(-1)  # [B, H, Nq], the one-shot preprocess
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - d[..., None])
        dq = torch.matmul(ds, kf) * scale
        dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    out = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    return out + (ds,) if bias is not None else out
