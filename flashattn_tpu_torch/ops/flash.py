"""Public fused-attention API: validation, layouts, dtype dispatch, autograd.

Port of flashattn_tpu/ops/flash.py with the causal mask, the sliding window,
segment ids (packed sequences), logit soft-capping and an additive bias: the
forward runs K1 (``ops/flash_fwd.py``); the gradient, behind a
``torch.autograd.Function``, runs the single-pass backward K3
(``ops/flash_bwd_fused.py``) or, with segment ids, a softcap or a bias, the
two-kernel backward K5 + K6 (``ops/flash_bwd.py``) -- the routing of the JAX
``_flash_core_bwd`` -- as one Hopper kernel for both: after K1's bias route
``flash_bwd.bias_bwd`` (with dbias), without a bias ``flash_bwd.split_bwd``;
K5 then K6, whose K6 also gives dbias, for a bias that route refuses. The GQA decode fold is
ported: a tiny-Nq non-causal GQA call without a window folds each KV head's
query heads into the Q rows, so the cache is read once. The arguments keep
the JAX signature; those the port's kernels do not take yet raise
``NotImplementedError`` naming their ROADMAP item: on every device q / kv
offsets that change the result (a causal mask or a window, ``q_offset !=
kv_offset``) with quantized K/V; on the card f32 above head dim 128.
``compute_dtype`` picks the
kernels' dtype as in the JAX package (bf16 or f32; f32 inputs run the f32
kernels on the card, with a bias too, up to head dim 128), and a head dim
that is not a multiple of 8 is zero-padded to one, as the JAX function pads
D. :class:`BlockSizes` and the
``block_sizes`` option keep the JAX package's class and checks; the Hopper
kernels' tiles are their design, so the option leaves the result as it is. The
offsets of sequence-parallel callers (``parallel/``) run on K1's dense route
and, in the backward, K3 or the split route, whose band they shift. The TPU routing tiers
(unaligned/causal decompositions, macro/resident routing) and K3's VMEM bound
on its dQ scratch are not ported: the CUDA kernels mask the KV tail, the Q
tail, the causal and window band and the segments themselves, so one launch
covers every shape the JAX tiers split up.
"""

from __future__ import annotations

import dataclasses

import torch

from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd

NUM_LANES = 128


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """The JAX package's kernel tile sizes (flashattn_tpu/ops/flash.py:36-57),
    with its defaults and checks: each ``block_q*`` a multiple of 16, each
    ``block_k*`` a multiple of 128 (``ValueError`` otherwise).

    The port's Hopper kernels keep their own tiles, which their shared memory
    and registers fix: K1's dense, bias and f32 routes take 128 Q rows a CTA
    (against 64-key KV tiles), its decode route 16-row Q tiles; K3 and the
    split route 128 KV rows a CTA against 64-row Q tiles, their D 256 form 64
    keys against 64-row Q tiles, the f32 backward 64 keys against 32 rows; the
    bias route's backward 128 KV rows against 64 rows. ``flash_attention``
    takes a ``BlockSizes`` and computes the same function with or without
    one."""

    block_q: int = 256
    block_k: int = 256
    block_q_dkv: int = 128
    block_k_dkv: int = 256
    block_q_dq: int = 256
    block_k_dq: int = 128

    def __post_init__(self):
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if f.name.startswith("block_q"):
                if val % 16 != 0:
                    raise ValueError(f"{f.name}={val} must be a multiple of 16")
            elif val % NUM_LANES != 0:
                raise ValueError(f"{f.name}={val} must be a multiple of {NUM_LANES}")



def _dispatch_dtype(dtype: torch.dtype, compute_dtype=None) -> torch.dtype:
    """Kernel dtype per input dtype (the JAX package's policy,
    flashattn_tpu/ops/flash.py:224-247): ``compute_dtype`` when given, which
    must be bf16 or f32 (ValueError otherwise); else bf16 and f32 run as they
    are, fp16 and anything else cast to bf16. ``compute_dtype=torch.float32``
    is the accurate route for fp16 inputs: their 10 mantissa bits survive in
    f32, not in bf16's 7."""
    if compute_dtype is not None:
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, got {compute_dtype}")
        return compute_dtype
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


def _normalize_segment_ids(segment_ids, q, k):
    """Validate/split the public ``segment_ids`` arg into ``(q_ids, kv_ids)``
    (the JAX function of that name, with its checks and messages), as int32 on
    q's device; ``(None, None)`` without segments."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        seg_q, seg_kv = segment_ids
    else:
        if q.shape[2] != k.shape[2]:
            raise ValueError(
                "a single segment_ids array requires Nq == Nk; pass a "
                f"(q_ids, kv_ids) tuple for Nq={q.shape[2]} Nk={k.shape[2]}")
        seg_q = seg_kv = segment_ids
    seg_q, seg_kv = torch.as_tensor(seg_q), torch.as_tensor(seg_kv)
    for ids in (seg_q, seg_kv):
        if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise ValueError(f"segment ids must be integers, got {ids.dtype}")
    B, _, Nq, _ = q.shape
    Nk = k.shape[2]
    if tuple(seg_q.shape) != (B, Nq) or tuple(seg_kv.shape) != (B, Nk):
        raise ValueError(
            f"segment id shapes {tuple(seg_q.shape)}/{tuple(seg_kv.shape)} must be "
            f"({B}, {Nq}) / ({B}, {Nk})")
    return tuple(ids.to(device=q.device, dtype=torch.int32) for ids in (seg_q, seg_kv))


def _reduce_dbias(dbias, bias):
    """The full f32 dbias ``[B, Hq, Nq, Nk]`` summed over every dim where
    ``bias`` has size 1 and cast to its dtype (JAX flash.py:944-954)."""
    dims = tuple(d for d in range(3) if bias.shape[d] == 1 and dbias.shape[d] != 1)
    if dims:
        dbias = dbias.sum(dim=dims, keepdim=True)
    return dbias.to(bias.dtype)


class _FlashCore(torch.autograd.Function):
    """K1 forward saving ``(q, k, v, o, lse)``, the segment ids, the bias, the
    window, the softcap and the offsets; the backward routes as the JAX
    ``_flash_core_bwd``: K3 when there are no segment ids, no softcap and no
    bias (its fused branch, with the window: on the card bf16 at every D up
    to 256, its D 256 form above 128, and f32 up to 128), else its
    two-kernel branch, K5 + K6: with a bias (``flash_bwd.bias_bwd_route``,
    bf16 up to D 256 -- the D 256 form above 128 -- or f32 up to D 128: the
    bias kernel, or the f32 body's BIAS family) one kernel that computes
    both with the bias and, if any, the softcap, the window, the offsets and
    the segment ids; without a bias (``flash_bwd.split_sm90_route``, bf16 up
    to D 256 -- the D 256 form above 128 -- or f32 up to 128) one kernel
    that computes both with the segment ids and / or the softcap; else (what
    no route takes: f32 above D 128 with a bias) K5 then K6, which raise on
    a CUDA tensor naming their ROADMAP item; K3 and the split route raise so
    for f32 above D 128 and for D above 256. dbias is written only
    when the bias needs a gradient; it comes back reduced over the bias's
    broadcast dims, in the bias's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seg_q, seg_kv, scale, kv_valid_len, causal, window,
                softcap, offsets):
        segment_ids = None if seg_q is None else (seg_q, seg_kv)
        o, lse = flash_fwd.fwd(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                               segment_ids=segment_ids, bias=bias, window=window,
                               softcap=softcap, q_offset=offsets[0], kv_offset=offsets[1])
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv, bias)
        ctx.scale, ctx.kv_valid_len, ctx.causal = scale, kv_valid_len, causal
        ctx.window, ctx.softcap, ctx.offsets = window, softcap, offsets
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, seg_q, seg_kv, bias = ctx.saved_tensors
        B, Hq, _, D = q.shape
        Hkv, Nk = k.shape[1], k.shape[2]
        do = do.to(q.dtype)
        # Δ = rowsum(dO ⊙ O) in f32, outside the kernel (XLA's job in the JAX package).
        delta = (do.float() * o.float()).sum(-1)
        kw = dict(scale=ctx.scale, causal=ctx.causal, kv_valid_len=ctx.kv_valid_len,
                  window=ctx.window, q_offset=ctx.offsets[0], kv_offset=ctx.offsets[1])
        dbias = None
        segment_ids = None if seg_q is None else (seg_q, seg_kv)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        if seg_q is None and ctx.softcap is None and bias is None:
            dq, dk, dv = flash_bwd_fused.bwd(q, k, v, do, lse, delta, **kw)
        elif flash_bwd.bias_bwd_route(head_dim=D, bias=bias, dtype=q.dtype):
            # A bias, with or without the softcap, a window, offsets or
            # segment ids: K5 + K6 in one launch, dK/dV per KV head.
            dq, dk, dv, dbias = flash_bwd.bias_bwd(
                q, k, v, do, lse, delta, bias=bias, softcap=ctx.softcap, want_dbias=want_dbias,
                segment_ids=segment_ids, **kw)
        elif flash_bwd.split_sm90_route(head_dim=D, bias=bias, dtype=q.dtype,
                                        segment_ids=segment_ids, softcap=ctx.softcap):
            # Segment ids and / or the softcap without a bias: K5 + K6 in one
            # launch (the Hopper kernel in bf16, the f32 body in f32).
            dq, dk, dv = flash_bwd.split_bwd(q, k, v, do, lse, delta, segment_ids=segment_ids,
                                             softcap=ctx.softcap, **kw)
        else:
            kw.update(segment_ids=segment_ids, softcap=ctx.softcap, bias=bias)
            dk, dv = flash_bwd.dkv(q, k, v, do, lse, delta, **kw)
            if want_dbias:
                dq, dbias = flash_bwd.dq(q, k, v, do, lse, delta, want_dbias=True, **kw)
            else:
                dq = flash_bwd.dq(q, k, v, do, lse, delta, **kw)
        if dbias is not None:
            dbias = _reduce_dbias(dbias, bias)
        if dk.shape[1] != Hkv:  # GQA: dK/dV came per query head; sum each KV head's group
            dk = dk.view(B, Hkv, Hq // Hkv, Nk, D).sum(2)
            dv = dv.view(B, Hkv, Hq // Hkv, Nk, D).sum(2)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, None, None, None, None,
                None, None, None, None)


class _FlashForwardOnly(torch.autograd.Function):
    """K1 forward with no gradient: ``flash_attention_with_lse`` is forward-only
    in the JAX package too (it calls the forward implementation, not the
    custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seg_q, seg_kv, scale, kv_valid_len, causal, window,
                softcap, offsets):
        segment_ids = None if seg_q is None else (seg_q, seg_kv)
        o, lse = flash_fwd.fwd(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                               segment_ids=segment_ids, bias=bias, window=window,
                               softcap=softcap, q_offset=offsets[0], kv_offset=offsets[1])
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        raise NotImplementedError(
            "flash_attention_with_lse is forward-only, as in the JAX package; "
            "differentiate flash_attention instead")


def _forward(q, k, v, *, scale, layout, causal, core, bias, segment_ids, window,
             logit_softcap, q_offset, kv_offset, compute_dtype=None, fold=False,
             block_sizes=None):
    q, k, v = _to_bhnd(q, layout), _to_bhnd(k, layout), _to_bhnd(v, layout)
    _validate(q, k, v, bias)
    # As the JAX function normalises them (flash.py:1083-1095, 1158-1171);
    # offsets that leave the result as it is become (0, 0).
    window = None if window is None else tuple(int(w) for w in window)
    offsets = flash_fwd.band_offsets(causal, window, q_offset, kv_offset)
    if block_sizes is not None and not isinstance(block_sizes, BlockSizes):
        raise TypeError(f"block_sizes must be a BlockSizes, got {type(block_sizes).__name__}")
    softcap = None if logit_softcap is None else float(logit_softcap)
    in_dtype = q.dtype
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    kdt = _dispatch_dtype(in_dtype, compute_dtype)
    q, k, v = q.to(kdt), k.to(kdt), v.to(kdt)
    # GQA decode fold (flash.py:1052-1077): tiny-Nq queries against a GQA
    # cache would read each KV tile rep = Hq/Hkv times (one CTA per q head).
    # Folding one KV head's rep q heads into the Q-tile rows reads the cache
    # once: [B, Hq, Nq, D] -> [B, Hkv, rep·Nq, D], head-major rows, exactly
    # the kernel's h // rep mapping. Sound only when nothing depends on a
    # row's sequence position: non-causal, no window or segments, and a bias
    # without a head dim (e.g. a [1, 1, 1, Nk] key mask), tiled head-major when
    # it has rows. The softcap passes through. Under the JAX condition, less
    # its ``block_sizes is None``: the Hopper kernels take no tile sizes, so
    # a BlockSizes changes nothing here.
    B, Hq, Nq, D = q.shape
    rep = Hq // k.shape[1]
    if (fold and rep > 1 and not causal and window is None
            and (bias is None or bias.shape[1] == 1) and segment_ids is None
            and Nq * rep <= 32):
        if bias is not None and bias.shape[2] > 1:
            bias = bias.repeat(1, 1, rep, 1)
        o, lse = _forward(
            q.reshape(B, k.shape[1], rep * Nq, D), k, v, scale=scale, layout="BHND",
            causal=False, core=core, bias=bias, segment_ids=None, window=None,
            logit_softcap=softcap, q_offset=0, kv_offset=0)
        return _from_bhnd(o.reshape(B, Hq, Nq, D).to(in_dtype), layout), lse
    seg_q, seg_kv = _normalize_segment_ids(segment_ids, q, k)
    # The kernels take head dims that are multiples of 8 (flash.py:151-157
    # pads D too): zero columns of q and k add 0 to every score and zero
    # columns of v give zero columns of O, which are cut off again; dO comes
    # back padded by the slice's autograd, and dQ / dK / dV cut to D by the
    # pad's. The scale above is the true D's.
    pad = -D % 8
    if pad:
        q, k, v = (torch.nn.functional.pad(x, (0, pad)) for x in (q, k, v))
    o, lse = core.apply(q, k, v, bias, seg_q, seg_kv, float(scale), k.shape[2], bool(causal),
                        window, softcap, offsets)
    if pad:
        o = o[..., :D]
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
    q_offset: int | torch.Tensor = 0,
    kv_offset: int | torch.Tensor = 0,
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
      causal: mask ``kv_pos > q_pos``, top-left aligned with zero offsets
        (position 0 of Q and of K/V coincide, also when ``Nq != Nk``).
      q_offset/kv_offset: absolute positions of the first query row and the
        first key (for sequence-parallel callers): ``q_pos = q_offset + i``,
        ``kv_pos = kv_offset + j`` in the causal and window masks (the KV
        tail and the segment ids stay local). Host ints, or 0-d integer
        tensors read once with ``.item()``. Offsets that change the result
        (a causal mask or a window, ``q_offset != kv_offset``) run on the
        Hopper kernels, with or without a bias; on quantized K/V they raise
        ``NotImplementedError`` (ROADMAP queue 2, item 2).
        ``q_offset == kv_offset`` is the call without offsets, bit for bit.
      window: sliding window ``(left, right)``: position pair (i, j) may
        attend iff ``i - left <= j <= i + right`` (absolute positions); -1
        disables that side (Mistral-style local attention is
        ``causal=True, window=(w - 1, -1)``). Tiles outside the band are
        skipped, so cost scales with the window, not N².
      scale: softmax scale, default ``D ** -0.5``.
      bias: additive attention bias ``[B|1, H|1, Nq|1, Nk]`` (dims of size 1
        broadcast, and are read with stride 0 by the kernels), cast to f32
        once, added after the softcap. Differentiable: when it requires grad,
        its gradient ``P (dP − Δ)`` (K6's dbias) comes back summed over its
        size-1 dims, in its dtype. With segment ids, a window and offsets
        too (on the card in bf16 at head dims up to 256, in f32 up to 128).
      segment_ids: packed sequences: integer ids ``[B, N]`` (needs
        ``Nq == Nk``) or a ``(q_ids [B, Nq], kv_ids [B, Nk])`` tuple, ids
        >= 0. Pair (i, j) attends iff ``q_ids[i] == kv_ids[j]`` (AND-composed
        with ``causal`` and ``window``); a row that matches no key gives
        zeros and zero gradients.
      logit_softcap: Gemma-2-style soft-capping: the scaled logits become
        ``cap·tanh(s/cap)`` before the bias and the masks, differentiable
        through the cap's ``1 − tanh²`` Jacobian.
      compute_dtype: the kernels' dtype, ``torch.bfloat16`` or
        ``torch.float32`` (anything else is a ``ValueError``), in place of
        the input dtype's (bf16 and f32 as they are, fp16 cast to bf16). The
        output and the gradients come back in the input dtype.
        ``compute_dtype=torch.float32`` is the accurate route for fp16
        inputs.
      block_sizes: the JAX package's tile option, a :class:`BlockSizes`
        (``TypeError`` otherwise). The Hopper kernels' tiles are their design
        (:class:`BlockSizes` names them per route), so the result is the
        same function, and the call runs as it would without one.
    Returns:
      Attention output, same shape/layout/dtype as ``q``. CPU tensors run the
      plain PyTorch versions, CUDA tensors the kernels in the compute dtype
      (bf16 or f32; fp16 is cast to bf16 and back unless ``compute_dtype``
      says f32): K1 forward; K3 backward, or K5 + K6 (one launch) with
      segment ids, a softcap or a bias (bf16 head dims up to 256, with or
      without a bias; f32 up to 128, with or without a bias). A head
      dim that is not a multiple of 8 runs zero-padded to one. Tiny-Nq
      non-causal GQA calls without a window (``Nq·Hq/Hkv <= 32``) run
      folded, one KV head's query heads as Q rows.
    """
    o, _ = _forward(
        q, k, v, scale=scale, layout=layout, causal=causal, core=_FlashCore, bias=bias,
        block_sizes=block_sizes, q_offset=q_offset, kv_offset=kv_offset,
        window=window, segment_ids=segment_ids, logit_softcap=logit_softcap,
        compute_dtype=compute_dtype, fold=True)
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
    q_offset: int | torch.Tensor = 0,
    kv_offset: int | torch.Tensor = 0,
    window: tuple[int, int] | None = None,
    segment_ids=None,
    logit_softcap: float | None = None,
    compute_dtype=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-only fused attention returning ``(O, L)`` with
    ``L = logsumexp`` per row ``[B, H, Nq]`` in f32 -- the merge primitive
    for partial attention results. Same arguments as :func:`flash_attention`
    (never folded, as in the JAX package); its backward raises
    ``NotImplementedError``, as the JAX function has none.
    """
    return _forward(
        q, k, v, scale=scale, layout=layout, causal=causal, core=_FlashForwardOnly, bias=bias,
        block_sizes=block_sizes, q_offset=q_offset, kv_offset=kv_offset,
        window=window, segment_ids=segment_ids, logit_softcap=logit_softcap,
        compute_dtype=compute_dtype)
