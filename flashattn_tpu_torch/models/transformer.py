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
``kv_cache_from_jax`` carries a cache over). :func:`make_sharded_train_step`
is the dp x tp x sp training step on a mesh (``parallel/mesh.py``): heads and
MLP columns on ``model``, the sequence on ``seq`` through differentiable ring
attention (contiguous or zigzag), the batch on ``data`` (and ``slice``);
:func:`shard_params` cuts the parameters into the ranks' shards.
:class:`Transformer`, :func:`init_transformer` and :func:`init_kv_cache`
build on the card unless given ``device=``.
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
from flashattn_tpu_torch.parallel.ring import ring_attention
from flashattn_tpu_torch.parallel.zigzag import zigzag_order, zigzag_ring_attention


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
    way; under an f32 model on an int8 / fp8 cache in its f32-q form (q
    kept in f32), on an f32 cache K1's f32 route.

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


# ───────────────────────── sharded training step ─────────────────────────────


def shard_params_leaf_rules(cfg: TransformerConfig) -> dict[str, tuple]:
    """The sharding of each layer parameter for tp (the ``model`` axis), as a
    PartitionSpec tuple per dim (``()``: replicated) -- the JAX rules."""
    del cfg
    return {
        "ln1": (), "ln2": (),
        "wq": (None, "model", None), "wk": (None, "model", None),
        "wv": (None, "model", None), "wo": ("model", None, None),
        "w_gate": (None, "model"), "w_up": (None, "model"),
        "w_down": ("model", None),
    }


def _param_specs(cfg: TransformerConfig) -> dict[str, tuple]:
    """The spec of every parameter, by the port's flat names."""
    rules = shard_params_leaf_rules(cfg)
    specs = {"embed": (), "ln_f": ()}
    for i in range(cfg.n_layers):
        specs.update({f"layers.{i}.{k}": spec for k, spec in rules.items()})
    return specs


def shard_params(model: Transformer, mesh) -> list[dict]:
    """Each local rank's parameters: ``model``'s cut by the leaf rules on the
    rank's ``model`` coordinate, one dict per local rank of ``mesh`` (in
    ``mesh.ranks`` order), each leaf a contiguous copy on the mesh's device,
    owned by its rank (AdamW updates it in place)."""
    specs = _param_specs(model.cfg)
    shards = [dict() for _ in mesh.ranks]
    with torch.no_grad():
        for name, p in model.named_parameters():
            for i, x in enumerate(mesh.shard(p.detach(), specs[name])):
                shards[i][name] = x.to(mesh.device).clone(memory_format=torch.contiguous_format)
    return shards


def _zigzag_positions(seq_idx: int, n_local: int, sp: int, device=None):
    """Global positions of a rank's zigzag-layout local rows: natural chunks
    (d, 2·sp−1−d) of length n_local/2 concatenated."""
    c = n_local // 2
    ar = torch.arange(c, device=device)
    return torch.cat([ar + seq_idx * c, ar + (2 * sp - 1 - seq_idx) * c])


def _local_forward_sharded(params, tokens, cfg, mesh, *, zigzag=False, segment_ids=None,
                           positions=None):
    """The per-rank forward over ``mesh``'s local ranks: ``params`` holds each
    rank's tp-sharded heads and MLP columns, ``tokens`` each rank's
    ``[B/dp, N/sp]`` chunk (lists, one entry per local rank). Ring attention
    over ``seq`` -- plain (contiguous layout) or zigzag, RoPE positions
    following the layout -- and a psum over ``model`` after ``wo`` and
    ``w_down``. ``segment_ids`` / ``positions``: each rank's chunks for
    packed batches (contiguous layout; the positions are computed on the
    global ids by the caller, since a document may straddle ranks).
    ``cfg.sliding_window`` is the ring's window ``(sliding_window - 1, -1)``
    in global positions (contiguous layout; :func:`make_sharded_train_step`
    refuses it under zigzag, and refuses ``cfg.logit_softcap``). Returns
    each rank's logits ``[B/dp, N/sp, vocab]`` f32."""
    sp = mesh.shape["seq"]
    seq_idx = mesh.axis_index("seq")
    window = (cfg.sliding_window - 1, -1) if cfg.sliding_window else None
    if positions is None:
        positions = []
        for t, si in zip(tokens, seq_idx):
            B, N = t.shape
            pos = (_zigzag_positions(si, N, sp, t.device) if zigzag
                   else torch.arange(N, device=t.device) + si * N)
            positions.append(pos[None].expand(B, N))
    xs = [p["embed"][t] for p, t in zip(params, tokens)]
    ranks = range(len(xs))
    for li in range(cfg.n_layers):
        layer = [{k: p[f"layers.{li}.{k}"] for k in shard_params_leaf_rules(cfg)}
                 for p in params]
        qs, ks, vs = [], [], []
        for r in ranks:
            h = _rms_norm(xs[r], layer[r]["ln1"])
            q = torch.einsum("bnd,dhe->bnhe", h, layer[r]["wq"])
            k = torch.einsum("bnd,dhe->bnhe", h, layer[r]["wk"])
            v = torch.einsum("bnd,dhe->bnhe", h, layer[r]["wv"])
            # [B, N/sp, Hloc, D] -> BHND views for the ring
            qs.append(_rope(q, positions[r], cfg.rope_theta).transpose(1, 2))
            ks.append(_rope(k, positions[r], cfg.rope_theta).transpose(1, 2))
            vs.append(v.transpose(1, 2))
        if zigzag:
            os = zigzag_ring_attention(qs, ks, vs, mesh=mesh, axis="seq")
        else:
            os = ring_attention(qs, ks, vs, mesh=mesh, axis="seq", causal=True, window=window,
                                segment_ids=segment_ids)
        # wo is row-sharded over heads: partial sums, psum over tp
        attn = mesh.psum([torch.einsum("bnhe,hed->bnd", o.transpose(1, 2), layer[r]["wo"])
                          for r, o in zip(ranks, os)], "model")
        xs = [x + a.to(x.dtype) for x, a in zip(xs, attn)]
        mlp = []
        for r in ranks:
            h2 = _rms_norm(xs[r], layer[r]["ln2"])
            gate = F.silu(torch.einsum("bnd,df->bnf", h2, layer[r]["w_gate"]).float()
                          ).to(xs[r].dtype)
            up = torch.einsum("bnd,df->bnf", h2, layer[r]["w_up"])
            mlp.append(torch.einsum("bnf,fd->bnd", gate * up, layer[r]["w_down"]))
        xs = [x + m.to(x.dtype) for x, m in zip(xs, mesh.psum(mlp, "model"))]
    return [torch.einsum("bnd,vd->bnv", _rms_norm(x, p["ln_f"]), p["embed"]).float()
            for x, p in zip(xs, params)]


def make_sharded_train_step(mesh, cfg: TransformerConfig, *, lr=1e-3,
                            seq_layout="contiguous", with_segment_ids=False):
    """Build ``step(params, opt_state, tokens) -> (params, opt_state, loss)``
    over a (data, model, seq) mesh (``parallel/mesh.make_mesh``), and return
    ``(step, param_specs, opt_specs)`` as the JAX function does.

    Parallelism map:
      * data  -- batch DP (and the ``slice`` axis, outermost, as extra DP);
        gradients psum'd across it;
      * model -- TP: attention heads and MLP columns sharded, activations
        replicated, a psum after ``wo`` and ``w_down``;
      * seq   -- SP: the sequence sharded; differentiable ring attention
        rotates K/V between the ranks; the gradients of replicated
        parameters psum'd across it.

    ``params`` are the ranks' shards (:func:`shard_params`), ``opt_state``
    one :func:`adamw_init` state per local rank; ``tokens`` the global ``[B,
    N]`` batch in natural order (the step shards it; with ``seq_layout=
    "zigzag"`` it permutes it into the causally load-balanced layout first:
    RoPE positions, masks and the next-token loss follow the layout, so the
    loss is the contiguous one). Next-token targets take a one-token halo
    from the next ``seq`` rank (two under zigzag), and the global final
    position is masked out, so the loss equals the single-device
    :func:`lm_loss` of the same tokens -- with ``cfg.sliding_window`` too,
    as the ring's window in global positions (contiguous layout). Neither
    package's ring takes a logit cap and the zigzag ring is causal only, so
    ``cfg.logit_softcap``, and ``cfg.sliding_window`` under zigzag, raise
    ValueError here rather than train another model. ``with_segment_ids``: the step takes
    ``(params, opt_state, tokens, segment_ids)`` for packed batches -- the
    kv ids rotate with K/V, RoPE positions restart per document (computed on
    the global ids), and the loss masks document boundaries, the target's
    id taking the same halo. Contiguous layout only.

    The gradient is the true gradient of that loss (what autograd of the
    single-device :func:`lm_loss` gives): the backward runs once through one
    copy of the loss, and each leaf's per-rank gradients are psum'd over the
    axes its spec replicates it on. The JAX step's gradient comes out
    multiplied by the size of the mesh axes that its loss psum crosses
    (under ``shard_map(check_vma=False)`` the transpose of ``psum`` is
    ``psum``); AdamW almost cancels that factor (ROADMAP queue 3). The step
    updates ``params`` and the moments in place and returns the loss as a
    0-d f32 tensor. ``step.loss_and_grads(params, tokens[, segment_ids])``
    gives the loss and the reduced per-rank gradients without the update."""
    if seq_layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown seq_layout {seq_layout!r}")
    zz = seq_layout == "zigzag"
    if cfg.logit_softcap:
        raise ValueError(
            f"logit_softcap={cfg.logit_softcap}: the sharded step's ring attention takes "
            "no logit cap (nor does the JAX package's), so it cannot compute lm_loss")
    if cfg.sliding_window and zz:
        raise ValueError(
            f"sliding_window={cfg.sliding_window} requires seq_layout='contiguous': the "
            "zigzag ring is causal only")
    if with_segment_ids and zz:
        raise ValueError(
            "packed batches (with_segment_ids) require "
            "seq_layout='contiguous' — the zigzag layout does not thread "
            "segment ids yet")
    batch_axes = ("slice", "data") if "slice" in mesh.shape else ("data",)
    pspecs = _param_specs(cfg)
    opt_specs = {"mu": pspecs, "nu": pspecs, "count": ()}
    tok_spec = (batch_axes, "seq")
    sp = mesh.shape["seq"]
    loss_axes = (*batch_axes, "seq")
    down = [(i, (i - 1) % sp) for i in range(sp)]  # rank i receives rank i + 1's

    def local_losses(params, tokens, seg, positions):
        logits = _local_forward_sharded(params, tokens, cfg, mesh, zigzag=zz, segment_ids=seg,
                                        positions=positions)
        seq_idx = mesh.axis_index("seq")
        nloc = tokens[0].shape[1]
        if zz:
            # Two halos, one per zigzag half: lo (natural chunk d) is followed
            # by chunk d+1 = rank d+1's lo half -- except on the last rank,
            # whose lo chunk sp-1 is followed by its OWN hi half (chunk sp).
            # hi (chunk 2sp-1-d) is followed by chunk 2sp-d = rank d-1's hi
            # half; rank 0's hi is the global tail, masked below.
            c = nloc // 2
            nxt_lo = mesh.ppermute([t[:, :1] for t in tokens], "seq", down)
            nxt_hi = mesh.ppermute([t[:, c:c + 1] for t in tokens], "seq",
                                   [(i, (i + 1) % sp) for i in range(sp)])
            targets, gpos = [], []
            for t, lo, hi, si in zip(tokens, nxt_lo, nxt_hi, seq_idx):
                lo = t[:, c:c + 1] if si == sp - 1 else lo
                targets.append(torch.cat([t[:, 1:c], lo, t[:, c + 1:], hi], dim=1))
                gpos.append(_zigzag_positions(si, nloc, sp, t.device)[None])
        else:
            nxt = mesh.ppermute([t[:, :1] for t in tokens], "seq", down)
            targets = [torch.cat([t[:, 1:], n], dim=1) for t, n in zip(tokens, nxt)]
            gpos = [(si * nloc + torch.arange(nloc, device=t.device))[None]
                    for t, si in zip(tokens, seq_idx)]
        valids = [(g < sp * nloc - 1).expand(t.shape) for g, t in zip(gpos, tokens)]
        if seg is not None:
            # a document's last token must not predict the next document's
            # first: the target's id takes the same one-token halo
            nxt_seg = mesh.ppermute([s[:, :1] for s in seg], "seq", down)
            valids = [vl & (s == torch.cat([s[:, 1:], n], dim=1))
                      for vl, s, n in zip(valids, seg, nxt_seg)]
        counts = mesh.psum([vl.sum() for vl in valids], loss_axes)
        out = []
        for lg, tg, vl, n in zip(logits, targets, valids, counts):
            ll = torch.log_softmax(lg, dim=-1).gather(-1, tg[..., None])[..., 0]
            out.append(torch.where(vl, -ll, 0.0).sum() / n.clamp_min(1))
        return out

    def reduce_axes(spec):
        return loss_axes if "model" in spec else (*batch_axes, "model", "seq")

    def loss_and_grads(params, tokens, segment_ids=None):
        """``(loss, grads)``: the loss as a 0-d f32 tensor and, per local
        rank, ``{name: gradient}`` reduced over the axes that replicate the
        leaf (the true gradient of the rank's shard)."""
        seg = positions = None
        if zz:
            tokens = tokens[:, torch.from_numpy(zigzag_order(tokens.shape[1], sp)).to(
                tokens.device)]
        if segment_ids is not None:
            # RoPE positions restart per packed document; a document may
            # straddle seq ranks, so they come from the GLOBAL ids.
            seg = mesh.shard(segment_ids, tok_spec)
            positions = mesh.shard(segment_positions(segment_ids), tok_spec)
        toks = mesh.shard(tokens, tok_spec)
        names = list(pspecs)
        with torch.enable_grad():
            leaves = [{n: p[n].detach().requires_grad_(True) for n in names} for p in params]
            losses = local_losses(leaves, toks, seg, positions)
            # Every model rank holds the same loss: their mean is the loss,
            # and its backward the true gradient once the per-rank parts are
            # psum'd below.
            total = sum(losses) / mesh.shape["model"]
            flat = torch.autograd.grad(total, [lf[n] for lf in leaves for n in names])
        with torch.no_grad():
            grads = [dict(zip(names, flat[i * len(names):(i + 1) * len(names)]))
                     for i in range(len(params))]
            for n in names:
                for g, x in zip(grads, mesh.psum([g[n] for g in grads], reduce_axes(pspecs[n]))):
                    g[n] = x
            loss = mesh.psum([x.detach() for x in losses], loss_axes)[0]
        return loss, grads

    def step(params, opt_state, tokens, segment_ids=None):
        if with_segment_ids != (segment_ids is not None):
            raise TypeError("segment_ids is required exactly when with_segment_ids=True")
        loss, grads = loss_and_grads(params, tokens, segment_ids)
        for p, st, g in zip(params, opt_state, grads):
            _, new = adamw_update(g, st, p, lr=lr)
            st["count"] = new["count"]
        return params, opt_state, loss

    step.loss_and_grads = loss_and_grads
    return step, pspecs, opt_specs
