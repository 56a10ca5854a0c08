"""Decoder-only transformer LM (GQA + RoPE + RMSNorm + SwiGLU) on the fused
attention engine: the single-device training path and KV-cache decode.

Port of flashattn_tpu/models/transformer.py: :func:`transformer_forward`,
:func:`lm_loss` (also on packed batches, with ``segment_ids``; with a
Mistral-style ``sliding_window`` and Gemma-2-style ``logit_softcap``),
:func:`segment_positions`, the AdamW update, and the serving path
:func:`init_kv_cache` / :func:`decode_step` (bf16, int8 or fp8 cache; a
soft-capped model on a bf16 cache). Activations stay ``[B, N, H, D]`` so
attention runs in its BNHD layout with no rearrange: causal
:func:`flash_attention` (kernels K1 forward and K3 backward on the card, also
with a window; K1 with segments or a softcap and K5 + K6 when packed or
soft-capped) or, with ``attn_impl="xla"``, the exact f32 oracle with the same
window and cap (the baseline arm). A decode step runs K1's decode route once
per layer over views of the live cache slots, with no bias -- through
``flash_attention`` on a bf16 cache (with the cap, if any),
``flash_attention_quantized`` (in-kernel dequantization) on an int8 / fp8
one -- with the GQA decode fold.

The parameters keep the JAX pytree's names and shapes -- ``embed``, ``ln_f``,
``layers.{i}.{ln1,wq,wk,wv,wo,ln2,w_gate,w_up,w_down}``, ``wq`` as
``[d_model, H, d_head]`` -- and the forward keeps the JAX einsums, so
``models.convert.transformer_from_jax`` is a plain copy (and
``kv_cache_from_jax`` carries a cache over). The sharded step is not ported
yet (ROADMAP queue 1, item 1.3). :class:`Transformer`, :func:`init_transformer`
and :func:`init_kv_cache` build on the card unless given ``device=``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from flashattn_tpu_torch.ops.flash import flash_attention
from flashattn_tpu_torch.ops.oracle import attention_reference
from flashattn_tpu_torch.ops.quant import (
    QuantizedKV, flash_attention_quantized, quantize_kv, resolve_quant_dtype,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1408
    rope_theta: float = 10000.0
    # Mistral-style sliding window: each token attends to at most the
    # previous `sliding_window` tokens (None = full causal attention). K1 and
    # the backward skip the tiles outside it; decode masks the cache slots
    # that have left it.
    sliding_window: int | None = None
    # Gemma-2-style logit soft-capping (None = off); training runs K1 with
    # the cap and K5 + K6, decode needs a bf16 cache.
    logit_softcap: float | None = None
    # Recompute each block in the backward (torch.utils.checkpoint) instead
    # of storing its activations, as jax.checkpoint does in the JAX model.
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16


def _rms_norm(x, w, eps=1e-6):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * w


def _rope(x, positions, theta):
    """Rotary embedding over the last dim of ``[B, N, H, D]``, in f32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None, None].float() * freqs  # B N 1 half
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class Layer(nn.Module):
    """One block's parameters, named and shaped as the JAX layer dict."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dm, dh, dt = cfg.d_model, cfg.d_head, cfg.dtype

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.ln1 = param(dm)
        self.wq = param(dm, cfg.n_heads, dh)
        self.wk = param(dm, cfg.n_kv_heads, dh)
        self.wv = param(dm, cfg.n_kv_heads, dh)
        self.wo = param(cfg.n_heads, dh, dm)
        self.ln2 = param(dm)
        self.w_gate = param(dm, cfg.d_ff)
        self.w_up = param(dm, cfg.d_ff)
        self.w_down = param(cfg.d_ff, dm)


class Transformer(nn.Module):
    """The LM's parameters, laid out as the JAX pytree of ``init_transformer``,
    on ``device`` (the card by default). Allocated uninitialised: use
    :func:`init_transformer` or ``models.convert.transformer_from_jax``."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, dtype=cfg.dtype,
                                              device=device))
        self.ln_f = nn.Parameter(torch.empty(cfg.d_model, dtype=cfg.dtype, device=device))
        self.layers = nn.ModuleList(Layer(cfg, device) for _ in range(cfg.n_layers))

    def forward(self, tokens, attn_impl="fused", segment_ids=None):
        return transformer_forward(self, tokens, self.cfg, attn_impl=attn_impl,
                                   segment_ids=segment_ids)


def init_transformer(cfg: TransformerConfig, generator: torch.Generator,
                     device="cuda") -> Transformer:
    """An LM on ``device`` (the card by default) with the JAX package's
    initialisation: projections ``normal · fan_in^-1/2``, the embedding
    ``normal · 0.02``, unit norm scales. Draws come from ``generator`` on its
    own device, in f32, then are cast to ``cfg.dtype``."""
    model = Transformer(cfg, device=device)

    def normal(shape, std):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device) * std

    fan_in = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
              "wo": cfg.n_heads * cfg.d_head, "w_gate": cfg.d_model, "w_up": cfg.d_model,
              "w_down": cfg.d_ff}
    with torch.no_grad():
        for layer in model.layers:
            for name, p in layer.named_parameters():
                if name in fan_in:
                    p.copy_(normal(p.shape, fan_in[name] ** -0.5))
                else:  # ln1, ln2
                    p.fill_(1.0)
        model.embed.copy_(normal(model.embed.shape, 0.02))
        model.ln_f.fill_(1.0)
    return model


def _attention_block(layer: Layer, x, positions, cfg, attn_fn):
    h = _rms_norm(x, layer.ln1)
    q = torch.einsum("bnd,dhe->bnhe", h, layer.wq)
    k = torch.einsum("bnd,dhe->bnhe", h, layer.wk)
    v = torch.einsum("bnd,dhe->bnhe", h, layer.wv)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = attn_fn(q, k, v)  # [B, N, H, D]
    return x + torch.einsum("bnhe,hed->bnd", o, layer.wo).to(x.dtype)


def _mlp_block(layer: Layer, x):
    h = _rms_norm(x, layer.ln2)
    gate = F.silu(torch.einsum("bnd,df->bnf", h, layer.w_gate).float()).to(x.dtype)
    up = torch.einsum("bnd,df->bnf", h, layer.w_up)
    return x + torch.einsum("bnf,fd->bnd", gate * up, layer.w_down)


def segment_positions(segment_ids):
    """Per-segment RoPE positions for a packed batch: each contiguous run of
    equal ids restarts at position 0 (``[0,0,1,1,1] → [0,1,0,1,2]``)."""
    B, N = segment_ids.shape
    idx = torch.arange(N, device=segment_ids.device)[None].expand(B, N)
    is_start = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=segment_ids.device),
                          segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - seg_start


def transformer_forward(model: Transformer, tokens, cfg: TransformerConfig, *,
                        attn_impl="fused", segment_ids=None):
    """tokens ``[B, N]`` (int) → logits ``[B, N, vocab]`` f32 (causal LM).

    ``attn_impl``: "fused" runs causal :func:`flash_attention` (the kernels
    on the card); "xla" computes exact unfused softmax attention in f32, the
    baseline arm (named after the JAX model's arm). Both take
    ``cfg.sliding_window`` as the window ``(sliding_window - 1, -1)`` and
    ``cfg.logit_softcap`` as the cap.

    ``segment_ids`` ``[B, N]``: packed-batch training -- several documents
    packed into one row as contiguous runs of equal ids. Attention is blocked
    across documents and RoPE positions restart per document, so packed
    logits equal the per-document logits."""
    if attn_impl not in ("fused", "xla"):
        raise ValueError(f"unknown attn_impl {attn_impl!r} (expected 'fused' or 'xla')")
    B, N = tokens.shape
    x = model.embed[tokens]
    if segment_ids is not None:
        positions = segment_positions(segment_ids)
    else:
        positions = torch.arange(N, device=tokens.device)[None].expand(B, N)
    window = (cfg.sliding_window - 1, -1) if cfg.sliding_window else None

    def attn(q, k, v):
        if attn_impl == "xla":
            o = attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                window=window,
                segment_ids=None if segment_ids is None else (segment_ids, segment_ids),
                logit_softcap=cfg.logit_softcap)
            return o.transpose(1, 2).to(q.dtype)
        return flash_attention(q, k, v, causal=True, layout="BNHD", window=window,
                               segment_ids=segment_ids, logit_softcap=cfg.logit_softcap)

    def block(layer, x):
        return _mlp_block(layer, _attention_block(layer, x, positions, cfg, attn))

    for layer in model.layers:
        if cfg.remat:
            x = checkpoint(block, layer, x, use_reentrant=False)
        else:
            x = block(layer, x)
    x = _rms_norm(x, model.ln_f)
    return torch.einsum("bnd,vd->bnv", x, model.embed).float()


def lm_loss(model: Transformer, tokens, cfg: TransformerConfig, *, attn_impl="fused",
            segment_ids=None):
    """Next-token cross-entropy, the mean over all ``B·(N−1)`` positions.

    With ``segment_ids`` ``[B, N]`` (packed batches), positions whose next
    token belongs to another document are excluded -- a document's last
    token never predicts the next document's first -- and the mean runs over
    the remaining positions."""
    logits = transformer_forward(
        model, tokens[:, :-1], cfg, attn_impl=attn_impl,
        segment_ids=None if segment_ids is None else segment_ids[:, :-1])
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None])[..., 0]
    if segment_ids is None:
        return -ll.mean()
    valid = (segment_ids[:, :-1] == segment_ids[:, 1:]).float()
    return -(ll * valid).sum() / valid.sum().clamp_min(1.0)


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """AdamW state for a ``{name: parameter}`` dict: f32 moments, count 0."""
    return {"mu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
            "count": 0}


@torch.no_grad()
def adamw_update(grads, state, params, *, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01):
    """One AdamW step with the JAX package's arithmetic: f32 moments, the
    bias-corrected step plus ``weight_decay · p``, the result cast to the
    parameter's dtype. (``torch.optim.AdamW`` keeps bf16 moments for bf16
    parameters and so computes something else.)

    ``grads``, ``params`` and the state's moments are ``{name: tensor}``
    dicts. Unlike the pure JAX function, this one updates ``params`` and the
    moments in place, to hold no second copy of them; it returns
    ``(params, state)`` with the state's count advanced."""
    count = state["count"] + 1
    # The bias corrections in f32, as JAX computes b ** count on an f32 count.
    c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
    c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
    for name, p in params.items():
        gf = grads[name].float()
        m, n = state["mu"][name], state["nu"][name]
        m.mul_(b1).add_((1 - b1) * gf)
        n.mul_(b2).add_((1 - b2) * gf * gf)
        pf = p.float()
        step = (m / c1.item()) / (torch.sqrt(n / c2.item()) + eps) + weight_decay * pf
        p.copy_(pf - lr * step)
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}


# ───────────────────────────── decode path ──────────────────────────────────


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, quant_dtype=None, *,
                  device="cuda") -> dict:
    """The JAX package's KV cache on ``device`` (the card by default),
    zero-filled: ``length`` (a
    Python int, the slot the next step writes) and per layer ``k``/``v``
    ``[B, max_len, Hkv, D]`` lists in ``cfg.dtype``. With ``quant_dtype``
    (``torch.int8`` or ``torch.float8_e4m3fn``, through the fp8 guard of
    ``ops/quant.py``) the cache holds that dtype, quantized per token per
    head, plus ``k_scale``/``v_scale`` ``[B, max_len, Hkv]`` f32 lists: half
    the bytes of bf16, dequantized inside K1."""
    if quant_dtype is not None:
        quant_dtype = resolve_quant_dtype(quant_dtype, device=device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = cfg.dtype if quant_dtype is None else quant_dtype
    cache = {"length": 0,
             "k": [torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.n_layers)],
             "v": [torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.n_layers)]}
    if quant_dtype is not None:
        sshape = shape[:3]
        cache["k_scale"] = [torch.zeros(sshape, dtype=torch.float32, device=device)
                            for _ in range(cfg.n_layers)]
        cache["v_scale"] = [torch.zeros(sshape, dtype=torch.float32, device=device)
                            for _ in range(cfg.n_layers)]
    return cache


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, token, cfg: TransformerConfig):
    """One autoregressive step: token ``[B]`` (int) → ``(logits [B, vocab]
    f32, cache)``, with the arithmetic of the JAX ``decode_step``.

    Attention runs with Nq = 1, non-causal, over the live slots alone: K/V
    and their scales are passed as strided views of slots ``[max(0, pos -
    window + 1), pos]`` (without a window ``[0, pos]``), not copies, and
    with no bias. The JAX step attends every slot with an additive f32 bias
    of ``-1e9`` on the slots not written yet (and, with
    ``cfg.sliding_window``, on those that have left the window); those slots
    add exactly 0 in f32 and the live ones take a bias of 0, so the function
    is the JAX step's. K1's decode kernel runs on a bf16 cache (with
    ``cfg.logit_softcap``, soft-capped) or on int8 / fp8 K/V (the step's K
    and V quantized per token first) on a quantized one, GQA-folded either
    way.

    Unlike the pure JAX function, this one writes the step's K/V (and
    scales) into the cache tensors in place and advances ``cache["length"]``
    (a Python int, so the step needs no host sync); it returns the same
    dict. A quantized cache with ``cfg.logit_softcap`` raises the JAX
    package's ValueError."""
    quantized = "k_scale" in cache
    if quantized and cfg.logit_softcap:
        raise ValueError(
            "logit_softcap is not supported with a quantized KV cache "
            "(flash_attention_quantized has no softcap path) — decode with "
            "an unquantized cache or disable the cap")
    B = token.shape[0]
    pos = int(cache["length"])
    max_len = cache["k"][0].shape[1]
    if pos >= max_len:
        raise ValueError(f"the KV cache is full: length {pos}, max_len {max_len}")
    device = token.device
    x = model.embed[token][:, None]  # [B, 1, D]
    positions = torch.full((B, 1), pos, device=device)
    # the slots written so far (this step's included) that are still inside
    # the sliding window
    lo = max(0, pos - cfg.sliding_window + 1) if cfg.sliding_window else 0
    live_slots = slice(lo, pos + 1)

    for i, layer in enumerate(model.layers):
        h = _rms_norm(x, layer.ln1)
        q = torch.einsum("bnd,dhe->bnhe", h, layer.wq)
        k = torch.einsum("bnd,dhe->bnhe", h, layer.wk)
        v = torch.einsum("bnd,dhe->bnhe", h, layer.wv)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        kc, vc = cache["k"][i], cache["v"][i]
        if quantized:
            qt = quantize_kv(k, v, kc.dtype, allow_slow_fp8=True)
            ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
            kc[:, pos], vc[:, pos] = qt.k_q[:, 0], qt.v_q[:, 0]
            ksc[:, pos], vsc[:, pos] = qt.k_scale[:, 0], qt.v_scale[:, 0]
            live_kv = QuantizedKV(kc[:, live_slots], ksc[:, live_slots], vc[:, live_slots],
                                  vsc[:, live_slots])
            o = flash_attention_quantized(q, live_kv, layout="BNHD")
        else:
            kc[:, pos], vc[:, pos] = k[:, 0], v[:, 0]
            o = flash_attention(q, kc[:, live_slots], vc[:, live_slots], causal=False,
                                layout="BNHD", logit_softcap=cfg.logit_softcap)
        x = x + torch.einsum("bnhe,hed->bnd", o, layer.wo).to(x.dtype)
        x = _mlp_block(layer, x)
    x = _rms_norm(x, model.ln_f)
    logits = torch.einsum("bnd,vd->bnv", x, model.embed)[:, 0]
    cache["length"] = pos + 1
    return logits.float(), cache
