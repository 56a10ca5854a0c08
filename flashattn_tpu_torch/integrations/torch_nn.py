"""torch.nn counterpart of flashattn_tpu/integrations/flax_linen.py.

:func:`flash_attention_fn` keeps ``flax.linen.dot_product_attention``'s
semantics on ``[batch..., L, H, D]`` tensors and runs the fused kernels: a
boolean ``mask`` becomes a ``DEFAULT_MASK_VALUE`` bias, added to ``bias``;
extra batch dims are collapsed; ``causal`` and ``window`` reach the kernel as
band parameters (tile skipping, no N² mask). The layout ``[B, L, H, D]`` is the
kernels' BNHD, so nothing is transposed.

:class:`FlashMultiHeadDotProductAttention` is flax's
``MultiHeadDotProductAttention`` as a ``torch.nn.Module``: the same q/k/v/out
projections with biases and the same parameter tree (``query.kernel`` ``[F,
H, Dh]``, ..., ``out.kernel`` ``[H, Dh, F_out]``), so
``models.convert.mhdpa_from_flax`` carries a flax module's weights across.
torch has no flax parent to inherit the projections from, so they are
written out here. A float bias that requires grad gets its gradient through
the fused path (K6's dbias); a mask gets none.

Example::

    attn = FlashMultiHeadDotProductAttention(16, 2048, causal=True)
    y = attn(x)                                   # x [B, L, 2048]
    y = attn(x, mask=make_attention_mask(valid, valid, dtype=torch.bool))
    y = attn(x, bias=rel)                         # rel [1, H, L, L], requires grad
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from flashattn_tpu_torch.ops.flash import flash_attention
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.ops.sdpa import scaled_dot_product_attention


def flash_attention_fn(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    dropout_rng=None,
    dropout_rate: float = 0.0,
    deterministic: bool = False,
    dtype: torch.dtype | None = None,
    *,
    causal: bool = False,
    window: tuple[int, int] | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """``flax.linen.dot_product_attention`` semantics on the fused kernels.

    ``query``/``key``/``value``: ``[batch..., length, heads, head_dim]``.
    ``mask`` (nonzero = attend) and the additive ``bias`` broadcast to
    ``[batch..., heads, Nq, Nk]``. A row that the mask leaves no key follows
    the package's dead-row convention (zeros), not flax's uniform average.
    Attention dropout is not implemented: a nonzero ``dropout_rate`` with
    ``deterministic=False`` raises. ``causal``/``window`` are the
    keyword-only extensions that :func:`make_flash_attention_fn` binds.
    """
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "flash_attention_fn does not implement attention dropout; use "
            "deterministic=True / dropout_rate=0.0 (dropout on activations "
            "outside the attention core is unaffected).")
    if dtype is not None:
        query, key, value = (x.to(dtype) for x in (query, key, value))

    attn_mask = None
    if mask is not None:
        m = torch.where(mask.bool(), 0.0, DEFAULT_MASK_VALUE).to(torch.float32)
        attn_mask = m if bias is None else m + bias.float()
    elif bias is not None:
        attn_mask = bias

    # Collapse extra leading batch dims to the kernel's rank-4 [B, N, H, D].
    batch_shape = query.shape[:-3]
    if len(batch_shape) != 1:
        def flat(x):
            return x.reshape((-1,) + x.shape[len(batch_shape):])

        query, key, value = flat(query), flat(key), flat(value)
        if attn_mask is not None:
            while attn_mask.ndim < len(batch_shape) + 3:
                attn_mask = attn_mask[None]
            attn_mask = flat(attn_mask.expand(
                batch_shape + attn_mask.shape[len(batch_shape):]))

    if window is not None:
        # window is a flash_attention-only parameter (the adapter's exact arm
        # has none): call it directly.
        if attn_mask is not None:
            while attn_mask.ndim < 4:
                attn_mask = attn_mask[None]
        out = flash_attention(query, key, value, bias=attn_mask, causal=causal,
                              layout="BNHD", window=window)
    else:
        out = scaled_dot_product_attention(query, key, value, attn_mask=attn_mask,
                                           is_causal=causal, layout="BNHD", impl=impl)
    return out.reshape(batch_shape + out.shape[1:])


def make_flash_attention_fn(*, causal: bool = False, window: tuple[int, int] | None = None,
                            impl: str = "auto"):
    """:func:`flash_attention_fn` with ``causal``/``window``/``impl`` bound:
    the structural masks reach the kernel as band parameters, so no N² mask
    is built. Do not also pass a materialised causal mask."""
    return functools.partial(flash_attention_fn, causal=causal, window=window, impl=impl)


def make_attention_mask(query_input: torch.Tensor, key_input: torch.Tensor,
                        pairwise_fn=torch.mul, dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """``flax.linen.make_attention_mask``: ``pairwise_fn(query_input[..., :,
    None], key_input[..., None, :])`` with a head dim inserted, ``[batch...,
    1, Lq, Lk]`` in ``dtype`` (e.g. row validity flags in, a key-padding
    mask out)."""
    mask = pairwise_fn(query_input[..., :, None], key_input[..., None, :])
    return mask.unsqueeze(-3).to(dtype)


class _Projection(nn.Module):
    """flax ``DenseGeneral``'s parameters: ``kernel`` of ``shape`` and a
    ``bias`` of its output dims (none without ``use_bias``)."""

    def __init__(self, shape, out_dims: int, use_bias: bool, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(shape[-out_dims:], dtype=dtype, device=device))
                     if use_bias else None)

    def forward(self, x, in_dims: int):
        y = torch.tensordot(x, self.kernel, dims=in_dims)
        return y if self.bias is None else y + self.bias


class FlashMultiHeadDotProductAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` on the fused kernels.

    ``num_heads`` heads of ``qkv_features // num_heads`` over inputs of
    ``in_features``; output ``out_features`` (default ``in_features``).
    ``causal``/``window`` reach the kernel as band parameters; ``impl`` is
    the SDPA adapter's ("auto", "fused" or "exact"). Parameters are built in
    ``dtype`` on ``device`` (the card by default), kernels ``normal ·
    fan_in^-1/2`` from ``generator`` (on its own device; torch's default
    generator when None), biases 0.
    """

    def __init__(self, num_heads: int, in_features: int, *, qkv_features: int | None = None,
                 out_features: int | None = None, use_bias: bool = True, causal: bool = False,
                 window: tuple[int, int] | None = None, impl: str = "auto",
                 dtype: torch.dtype = torch.float32, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        qkv_features = in_features if qkv_features is None else qkv_features
        out_features = in_features if out_features is None else out_features
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features ({qkv_features}) must be divisible by num_heads "
                             f"({num_heads})")
        head_dim = qkv_features // num_heads
        self.num_heads, self.causal, self.window, self.impl = num_heads, causal, window, impl
        for name in ("query", "key", "value"):
            setattr(self, name, _Projection((in_features, num_heads, head_dim), 2, use_bias,
                                            dtype, device))
        self.out = _Projection((num_heads, head_dim, out_features), 1, use_bias, dtype, device)
        self.attention_fn = make_flash_attention_fn(causal=causal, window=window, impl=impl)
        with torch.no_grad():
            for proj, fan_in in ((self.query, in_features), (self.key, in_features),
                                 (self.value, in_features), (self.out, qkv_features)):
                dev = proj.kernel.device if generator is None else generator.device
                w = torch.randn(proj.kernel.shape, generator=generator, device=dev)
                proj.kernel.copy_(w * fan_in ** -0.5)

    def forward(self, inputs_q: torch.Tensor, inputs_k: torch.Tensor | None = None,
                inputs_v: torch.Tensor | None = None, *, mask: torch.Tensor | None = None,
                bias: torch.Tensor | None = None, deterministic: bool = True) -> torch.Tensor:
        """Attention of ``inputs_q`` ``[batch..., Lq, F]`` over ``inputs_k``
        (default ``inputs_q``) and ``inputs_v`` (default ``inputs_k``);
        ``mask`` broadcast to ``[batch..., H, Lq, Lk]``, nonzero = attend.
        ``bias``, which flax's module does not take, is added to the logits
        with the same broadcast (e.g. a learned relative-position bias
        ``[1, H, Lq, Lk]``); one that requires grad gets its gradient."""
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        q, k, v = (proj(x, 1) for proj, x in ((self.query, inputs_q), (self.key, inputs_k),
                                              (self.value, inputs_v)))
        o = self.attention_fn(q, k, v, bias=bias, mask=mask, deterministic=deterministic)
        return self.out(o, 2)
