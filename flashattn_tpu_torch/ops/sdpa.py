"""Drop-in scaled_dot_product_attention adapter (port of flashattn_tpu/ops/sdpa.py).

``impl="auto"`` picks the exact oracle or the fused kernel per shape with the
JAX package's rule, kept unchanged for parity: it was fitted to TPU v5e
timings, and refitting it on the H100 is a ROADMAP item. ``"fused"`` and
``"exact"`` force a path.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.flash import flash_attention
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE, attention_reference


def _exact_is_faster(nq: int, nk: int) -> bool:
    """Shape rule fitted to the TPU v5e sweep: tiny KV (cross-attention) or a
    small N×N square → exact; everything else → fused."""
    return nk <= 128 or (nq <= 1536 and nk <= 1536)


def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    attn_mask: torch.Tensor | None = None,
    is_causal: bool = False,
    scale: float | None = None,
    *,
    layout: str = "BHND",
    impl: str = "auto",
) -> torch.Tensor:
    """torch.nn.functional.scaled_dot_product_attention semantics.

    ``attn_mask``: boolean (True = attend) or additive float, broadcastable to
    ``[B, H, Nq, Nk]``; ranks < 4 are left-padded with size-1 dims. A
    float mask that requires grad gets its gradient (on the fused path K6's
    dbias, reduced to the mask's shape); a boolean mask gets none.
    ``impl``: "auto" (shape-based fused/exact dispatch), "fused", or "exact".
    The exact path materializes the full f32 [Nq, Nk] score matrix.
    """
    if impl not in ("auto", "fused", "exact"):
        raise ValueError(f"unknown impl {impl!r} (expected 'auto', 'fused' or 'exact')")
    bias = None
    if attn_mask is not None:
        mask = attn_mask
        while mask.ndim < 4:
            mask = mask[None]
        if mask.dtype == torch.bool:
            bias = torch.where(mask, 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
        else:
            bias = mask

    n_axis = 2 if layout == "BHND" else 1
    nq, nk = query.shape[n_axis], key.shape[n_axis]
    use_exact = impl == "exact" or (impl == "auto" and _exact_is_faster(nq, nk))

    if use_exact:
        q, k, v = query, key, value
        if layout == "BNHD":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        o = attention_reference(q, k, v, bias=bias, causal=is_causal, scale=scale)
        return o.transpose(1, 2) if layout == "BNHD" else o

    return flash_attention(query, key, value, bias=bias, causal=is_causal,
                           scale=scale, layout=layout)
