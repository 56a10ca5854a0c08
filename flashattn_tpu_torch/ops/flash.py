"""Public fused-attention API: validation, layouts, dtype dispatch, autograd.

Port of flashattn_tpu/ops/flash.py for no bias, with the causal mask: the
forward runs K1 (``ops/flash_fwd.py``), the gradient runs the single-pass
backward K3 (``ops/flash_bwd_fused.py``) behind a ``torch.autograd.Function``.
The arguments keep the JAX signature; those the port's kernels do not take yet
raise ``NotImplementedError`` naming their ROADMAP item, on every device. The
TPU routing tiers (unaligned/causal decompositions, macro/resident routing,
the GQA decode fold) are not ported: the CUDA kernels mask the KV tail, the Q
tail and the causal band themselves, so one launch covers every shape the JAX
tiers split up.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops import flash_bwd_fused, flash_fwd

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


def _reject_unported(*, bias, block_sizes, q_offset, kv_offset, window,
                     segment_ids, logit_softcap, compute_dtype):
    unported = {
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
    """K1 forward saving ``(q, k, v, o, lse)``; K3 backward (``_flash_core_bwd``
    of the JAX package on its fused branch)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_valid_len, causal):
        o, lse = flash_fwd.fwd(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.kv_valid_len, ctx.causal = scale, kv_valid_len, causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        B, Hq, _, D = q.shape
        Hkv, Nk = k.shape[1], k.shape[2]
        do = do.to(q.dtype)
        # Δ = rowsum(dO ⊙ O) in f32, outside the kernel (XLA's job in the JAX package).
        delta = (do.float() * o.float()).sum(-1)
        dq, dk, dv = flash_bwd_fused.bwd(
            q, k, v, do, lse, delta, scale=ctx.scale, causal=ctx.causal,
            kv_valid_len=ctx.kv_valid_len)
        if Hq != Hkv:  # GQA: dK/dV come per query head; sum each KV head's group
            dk = dk.view(B, Hkv, Hq // Hkv, Nk, D).sum(2)
            dv = dv.view(B, Hkv, Hq // Hkv, Nk, D).sum(2)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


class _FlashForwardOnly(torch.autograd.Function):
    """K1 forward with no gradient: ``flash_attention_with_lse`` is forward-only
    in the JAX package too (it calls the forward implementation, not the
    custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_valid_len, causal):
        o, lse = flash_fwd.fwd(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash_attention_with_lse is forward-only, as in the JAX package; "
            "differentiate flash_attention instead")


def _forward(q, k, v, *, scale, layout, causal, core, **unported):
    q, k, v = _to_bhnd(q, layout), _to_bhnd(k, layout), _to_bhnd(v, layout)
    _validate(q, k, v, unported["bias"])
    _reject_unported(**unported)
    in_dtype = q.dtype
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    kdt = _dispatch_dtype(in_dtype)
    q, k, v = q.to(kdt), k.to(kdt), v.to(kdt)
    o, lse = core.apply(q, k, v, float(scale), k.shape[2], bool(causal))
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
    """Fused FlashAttention-2, arbitrary Nq/Nk, GQA, differentiable.

    Args:
      q/k/v: ``[B, H, N, D]`` (layout="BHND") or ``[B, N, H, D]``
        (layout="BNHD"). K/V may have fewer heads (GQA) as long as they divide
        Q's head count. ``Nk`` may differ from ``Nq``.
      causal: mask ``kv_pos > q_pos``, top-left aligned (position 0 of Q
        and of K/V coincide, also when ``Nq != Nk``).
      scale: softmax scale, default ``D ** -0.5``.
      bias, block_sizes, q_offset, kv_offset, window, segment_ids,
      logit_softcap, compute_dtype: the JAX package's options; not ported
        yet, each raises ``NotImplementedError`` when given.
    Returns:
      Attention output, same shape/layout/dtype as ``q``. CPU tensors run the
      plain PyTorch versions, CUDA tensors the kernels (bf16; fp16 is cast to
      bf16 and back): K1 forward, K3 backward (head dims up to 128).
    """
    o, _ = _forward(
        q, k, v, scale=scale, layout=layout, causal=causal, core=_FlashCore, bias=bias,
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
    for partial attention results. Same arguments as :func:`flash_attention`;
    its backward raises ``NotImplementedError``, as the JAX function has none.
    """
    return _forward(
        q, k, v, scale=scale, layout=layout, causal=causal, core=_FlashForwardOnly, bias=bias,
        block_sizes=block_sizes, q_offset=q_offset, kv_offset=kv_offset,
        window=window, segment_ids=segment_ids, logit_softcap=logit_softcap,
        compute_dtype=compute_dtype)
