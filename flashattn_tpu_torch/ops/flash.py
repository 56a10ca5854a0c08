"""Public fused-attention API: validation, layouts, dtype dispatch, autograd.

Port of the forward half of flashattn_tpu/ops/flash.py. The arguments keep
the JAX signature; those the port's K1 does not take yet raise
``NotImplementedError`` naming their ROADMAP item, on every device. The TPU
routing tiers (unaligned/causal decompositions, macro/resident routing, the
GQA decode fold) are not ported: the CUDA kernel masks the KV tail and Q tail
itself, so one launch covers every shape the JAX tiers split up.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import flash_fwd

_ROADMAP_K1 = "ROADMAP queue 2, K1 options"


def _dispatch_dtype(dtype: torch.dtype) -> torch.dtype:
    """Kernel dtype per input dtype (the JAX package's policy): bf16 and f32
    run as they are; fp16 and anything else cast to bf16."""
    if dtype in (torch.bfloat16, torch.float32):
        return dtype
    return torch.bfloat16


def _to_bhnd(x, layout):
    if layout == "BHND":
        return x
    if layout == "BNHD":
        return x.transpose(1, 2)
    raise ValueError(f"unknown layout {layout!r} (expected 'BHND' or 'BNHD')")


def _from_bhnd(x, layout):
    return x if layout == "BHND" else x.transpose(1, 2)


def _validate(q, k, v, bias):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q/k/v must be rank-4, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k and v shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} incompatible with q {tuple(q.shape)}")
    if Hq % k.shape[1] != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={k.shape[1]}")
    if bias is not None:
        if bias.ndim != 4:
            raise ValueError(f"bias must be rank-4, got {tuple(bias.shape)}")
        Bb, Hb, Nqb, Nkb = bias.shape
        if Bb not in (1, B) or Hb not in (1, Hq):
            raise ValueError(f"bias batch/head {tuple(bias.shape)} not broadcastable")
        if Nqb not in (1, Nq) or Nkb != k.shape[2]:
            raise ValueError(f"bias seq dims {tuple(bias.shape)} must be (1|{Nq}, {k.shape[2]})")


def _reject_unported(*, bias, causal, block_sizes, q_offset, kv_offset, window,
                     segment_ids, logit_softcap, compute_dtype):
    unported = {
        "causal=True": bool(causal),
        "bias": bias is not None,
        "window": window is not None,
        "segment_ids": segment_ids is not None,
        "logit_softcap": logit_softcap is not None,
        "nonzero q_offset/kv_offset": int(q_offset) != 0 or int(kv_offset) != 0,
        "block_sizes": block_sizes is not None,
        "compute_dtype": compute_dtype is not None,
    }
    for name, given in unported.items():
        if given:
            raise NotImplementedError(
                f"flash_attention: {name} is not ported to the CUDA K1 yet "
                f"({_ROADMAP_K1})")


class _FlashCore(torch.autograd.Function):
    """K1 forward saving ``(q, k, v, o, lse)`` for the backward kernel K3."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_valid_len):
        o, lse = flash_fwd.fwd(q, k, v, scale=scale, kv_valid_len=kv_valid_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash_attention backward is not ported yet: it needs kernel K3 "
            "(flash_bwd_fused.py::_bwd_fused_kernel), ROADMAP queue 2")


def _forward(q, k, v, *, scale, layout, **unported):
    q, k, v = _to_bhnd(q, layout), _to_bhnd(k, layout), _to_bhnd(v, layout)
    _validate(q, k, v, unported["bias"])
    _reject_unported(**unported)
    in_dtype = q.dtype
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    kdt = _dispatch_dtype(in_dtype)
    q, k, v = q.to(kdt), k.to(kdt), v.to(kdt)
    o, lse = _FlashCore.apply(q, k, v, float(scale), k.shape[2])
    return _from_bhnd(o.to(in_dtype), layout), lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    scale: float | None = None,
    layout: str = "BHND",
    block_sizes=None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: tuple[int, int] | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Fused FlashAttention-2 forward, arbitrary Nq/Nk, GQA.

    Args:
      q/k/v: ``[B, H, N, D]`` (layout="BHND") or ``[B, N, H, D]``
        (layout="BNHD"). K/V may have fewer heads (GQA) as long as they divide
        Q's head count. ``Nk`` may differ from ``Nq``.
      scale: softmax scale, default ``D ** -0.5``.
      bias, causal, block_sizes, q_offset, kv_offset, window, segment_ids,
      logit_softcap, compute_dtype: the JAX package's options; not ported
        yet, each raises ``NotImplementedError`` when given.
    Returns:
      Attention output, same shape/layout/dtype as ``q``. CPU tensors run the
      plain PyTorch version, CUDA tensors the kernel (bf16; fp16 is cast to
      bf16 and back). The backward raises ``NotImplementedError`` until K3 is
      ported.
    """
    o, _ = _forward(
        q, k, v, scale=scale, layout=layout, bias=bias, causal=causal,
        block_sizes=block_sizes, q_offset=q_offset, kv_offset=kv_offset,
        window=window, segment_ids=segment_ids, logit_softcap=logit_softcap,
        compute_dtype=compute_dtype)
    return o


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: torch.Tensor | None = None,
    causal: bool = False,
    scale: float | None = None,
    layout: str = "BHND",
    block_sizes=None,
    q_offset: int = 0,
    kv_offset: int = 0,
    window: tuple[int, int] | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    compute_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-only fused attention returning ``(O, L)`` with
    ``L = logsumexp`` per row ``[B, H, Nq]`` in f32 -- the merge primitive
    for partial attention results. Same arguments as :func:`flash_attention`.
    """
    return _forward(
        q, k, v, scale=scale, layout=layout, bias=bias, causal=causal,
        block_sizes=block_sizes, q_offset=q_offset, kv_offset=kv_offset,
        window=window, segment_ids=segment_ids, logit_softcap=logit_softcap,
        compute_dtype=compute_dtype)
