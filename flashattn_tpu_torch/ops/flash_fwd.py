"""FlashAttention-2 forward: the CUDA kernel's wrapper and its plain version.

Port of flashattn_tpu/ops/flash_fwd.py: kernel K1 (``_fwd_kernel``) with KV
tail, GQA, an optional causal mask, an optional sliding window, optional
segment ids (packed sequences), an optional additive bias, optional logit
soft-capping, and int8 / fp8 e4m3 K/V with per-token f32 scales dequantized
in the kernel (the serving path of ops/quant.py); the causal mask and the
window also cover K2 (``_fwd_causal_resident_kernel`` and
``fwd_macro_padded``, the whole-sequence banded routes). The calls that
decoding makes (:func:`decode_route`) go to a kernel of their own, a
split-KV forward with cp.async pipelining (``csrc/decode_tile.cuh`` in
``csrc/flash_decode*.cu``), whose splits are merged in LSE space; its plain
version is :func:`decode_reference`. The other calls on bf16 K/V, with or
without the softcap, go to a Hopper TMA + wgmma forward
(``csrc/fwd_sm90_tile.cuh``) -- causal or not, with a window, segment ids or
q / kv offsets or neither, any tail, at every head dim up to 256 (D 136-256
on the D 256 forms): those with a bias (:func:`bias_route`) to its bias
route, which brings the f32 bias tile through shared memory
(``csrc/flash_fwd_bias_sm90.cu``), and those without (:func:`dense_route`)
to its dense route (``csrc/flash_fwd_sm90.cu``). The calls on int8 / fp8 K/V
that the decode route leaves (:func:`quant_route`) go to the same body's
quantized route (``csrc/flash_fwd_quant_sm90.cu``), which widens the 8-bit
tiles in shared memory and takes the dense route's options and a bias. All
compute K1's function, so their plain version is :func:`fwd_reference`.
Every call on an f32 q over f32 K/V
(:func:`f32_route`) goes to an f32 kernel of its own
(``csrc/flash_fwd_f32.cu``: the dense route's TMA + wgmma scheme and
options on the three bf16 pieces of each f32 operand, ``ops/f32_split.py``,
six bf16 products per f32 product; above D 128 its D 256 form), decode
shapes too; its plain version is
:func:`fwd_reference` as well. An f32 q over int8 / fp8 K/V (the f32 LM
served from an 8-bit cache) takes the f32-q forms of the decode and
quantized routes (``csrc/flash_decode_quant_f32.cu``,
``csrc/flash_fwd_quant_f32.cu``): q as its three bf16 pieces, the 8-bit K/V
widened exactly to one, three bf16 products per f32 product, O in f32.
:func:`fwd` launches a kernel for
CUDA tensors and computes the plain :func:`fwd_reference` for CPU tensors --
the device of the input decides, and a CUDA tensor never reaches a plain
version.

Strides: the kernel takes (batch, head, seq) strides, so the ``[B, N, H, D]``
projections of the models and their KV caches arrive as transposed views
without a copy; the output is allocated with the query's strides. Only a
tensor whose head-dim stride is not 1, or whose strides or address break the
kernel's loads (16 bytes; a TMA map's), is copied first (8-bit K / V rows of
D % 16 == 8 bytes padded to 16). The bias is read with stride 0 on its
broadcast dims and the scales through their own strides, so neither is ever
expanded.
"""

from __future__ import annotations

import functools
import math

import torch

from flashattn_tpu_torch.ops import f32_split
from flashattn_tpu_torch.ops.oracle import (
    DEFAULT_MASK_VALUE,
    _expand_kv,
    _full_f32_matmul,
    attention_reference_with_lse,
)
from flashattn_tpu_torch.utils import native

MAX_HEAD_DIM = 256
# K/V element types of the kernels: the kv_dtype code of the C entries
# fa_fwd_quant_sm90 and fa_decode.
KV_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
_LOG2E = 1.0 / math.log(2.0)
# The decode route (csrc/decode_tile.cuh): at most this many query rows per KV
# head (the JAX fold bound, flashattn_tpu/ops/flash.py:1052-1077), the head
# dims it is instantiated for, the keys of one KV tile (a split holds whole
# tiles), the fewest tiles a split holds, and the CTAs per SM the split count
# fills without passing (two waves of the two CTAs that fit an SM at D 128: a
# third, partly empty wave cost a quarter of the kernel's time).
DECODE_MAX_ROWS = 32
DECODE_HEAD_DIMS = (64, 128)
DECODE_TILE = 64
DECODE_MIN_TILES = 4
DECODE_CTAS_PER_SM = 4
H100_SMS = 132
# The head dims above which K1's dense, bias and f32 routes run their D 256
# forms (every head dim up to MAX_HEAD_DIM, the TMA boxes reading zeros past
# D).
# The f32 elements of one of the bias route's 16-byte bias copies (a bias
# whose strides are not a multiple of it is copied with its rows padded to
# one); the dense route's Q tile (rows per CTA) and KV tile (keys per
# pipeline stage), the tiles of its segment-id ranges: SM90_KV_TILE up to
# DENSE_MAX_HEAD_DIM, SM90_WIDE_KV_TILE in its D 256 form
# (csrc/fwd_sm90_tile.cuh FbSmem::BN, dense_kv_tile); the bias route keeps
# SM90_KV_TILE at every head dim.
DENSE_MAX_HEAD_DIM = 128
BIAS_ROW_ALIGN = 4
SM90_Q_TILE = 128
SM90_KV_TILE = 64
SM90_WIDE_KV_TILE = 80
# The f32 route's Q tile (rows per CTA; its D 256 form's CTA takes half of
# one) and KV tile (keys per slot), the tiles of its segment-id ranges
# (csrc/flash_fwd_f32.cu): the dense route's.
F32_Q_TILE = SM90_Q_TILE
F32_KV_TILE = SM90_KV_TILE


def check_window(window):
    """A kernel-level ``window``: None, or ``(left, right)`` as two ints
    (a negative bound is no bound on that side), as the JAX function
    normalises it; raises ValueError otherwise."""
    if window is None:
        return None
    window = tuple(window)
    if len(window) != 2:
        raise ValueError(f"window must be (left, right), got {window!r}")
    return tuple(int(w) for w in window)


def check_softcap(softcap):
    """A kernel-level ``softcap``: None, or a positive float; raises
    ValueError otherwise."""
    if softcap is None:
        return None
    if not float(softcap) > 0:
        raise ValueError(f"logit_softcap must be positive, got {softcap!r}")
    return float(softcap)


def kernel_window(window) -> tuple[int, int]:
    """``(wl, wr)`` as the kernels' C entries take them: -1 for no bound."""
    if window is None:
        return -1, -1
    return tuple(w if w >= 0 else -1 for w in window)


def band_offsets(causal: bool, window, q_offset, kv_offset) -> tuple[int, int]:
    """``(q_offset, kv_offset)`` as host ints where they change the result --
    a causal mask or a window bound, and ``q_offset != kv_offset`` -- else
    ``(0, 0)``: the masks compare positions only through ``q_offset -
    kv_offset``, so such a call is the call without offsets, bit for bit. A
    0-d integer tensor is read once with ``.item()``."""
    q_offset, kv_offset = (int(x.item()) if isinstance(x, torch.Tensor) else int(x)
                           for x in (q_offset, kv_offset))
    banded = causal or kernel_window(check_window(window)) != (-1, -1)
    return (q_offset, kv_offset) if banded and q_offset != kv_offset else (0, 0)


def pair_mask(Nq: int, Nk: int, *, kv_valid_len: int, causal: bool, segment_ids,
              device, window=None, q_offset: int = 0, kv_offset: int = 0) -> torch.Tensor:
    """The (query, key) pairs that attend, ``[B or 1, 1, Nq, Nk]`` bool: keys
    below ``kv_valid_len``; with ``causal``, ``kv_pos <= q_pos``; with
    ``window = (left, right)``, ``q_pos - left <= kv_pos <= q_pos + right`` (a
    negative bound being none), in absolute positions ``q_pos = q_offset +
    i`` and ``kv_pos = kv_offset + j``; with ``segment_ids = (seg_q [B, Nq],
    seg_kv [B, Nk])``, equal ids. ``kv_valid_len`` and the ids stay local.
    The masks AND-compose, as in the kernels."""
    cols = torch.arange(Nk, device=device)[None, :]
    rows = torch.arange(Nq, device=device)[:, None]
    keep = (cols < kv_valid_len).expand(Nq, Nk)
    rows = rows + (q_offset - kv_offset)  # the band compares q_pos - kv_pos only
    if causal:
        keep = keep & (cols <= rows)
    wl, wr = kernel_window(window)
    if wl >= 0:
        keep = keep & (cols >= rows - wl)
    if wr >= 0:
        keep = keep & (cols <= rows + wr)
    keep = keep[None, None]
    if segment_ids is not None:
        seg_q, seg_kv = segment_ids
        keep = keep & (seg_q[:, None, :, None] == seg_kv[:, None, None, :])
    return keep


def fwd_reference(q, k, v, *, scale: float, kv_valid_len: int | None = None,
                  causal: bool = False, segment_ids=None, bias=None, k_scale=None,
                  v_scale=None, window=None, softcap=None, q_offset: int = 0,
                  kv_offset: int = 0):
    """Plain PyTorch K1: ``(O, LSE)`` for ``q [B,Hq,Nq,D]``, ``k/v [B,Hkv,Nk,D]``.

    The exact f32 oracle over the first ``kv_valid_len`` keys (the kernel's
    finite mask value gives those past it a weight of exactly 0); ``causal``
    masks ``kv_pos > q_pos``; ``window = (left, right)`` keeps ``q_pos - left
    <= kv_pos <= q_pos + right`` (a negative bound being none), in absolute
    positions ``q_pos = q_offset + i``, ``kv_pos = kv_offset + j``;
    ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])`` lets a pair attend only
    when its ids are equal; ``softcap`` caps the scaled scores at
    ``softcap · tanh(s / softcap)``; ``bias`` (broadcastable to
    ``[B,Hq,Nq,Nk]``) is added to the scaled (and capped) scores in f32
    before the masks; int8 / fp8 ``k``/``v`` with ``k_scale``/``v_scale``
    ``[B,Hkv,Nk]`` are dequantized to f32 first (``x · scale``). LSE is the
    natural-log row log-sum-exp in f32, O is in ``q.dtype``. A row with no key
    to attend (``kv_valid_len == 0``, none of its segment, or none in its
    window) is dead: O = 0 and LSE = ln2 * mask value, the kernel's
    convention.
    """
    if k_scale is not None:
        k = k.float() * k_scale.float()[..., None]
        v = v.float() * v_scale.float()[..., None]
    kv_valid_len = k.shape[2] if kv_valid_len is None else kv_valid_len
    if (segment_ids is not None or bias is not None or window is not None
            or softcap is not None or q_offset != kv_offset):
        return _masked_reference(q, k, v, scale=scale, bias=bias, softcap=softcap,
                                 keep=pair_mask(q.shape[2], k.shape[2],
                                                kv_valid_len=kv_valid_len, causal=causal,
                                                segment_ids=segment_ids, device=q.device,
                                                window=window, q_offset=q_offset,
                                                kv_offset=kv_offset))
    if kv_valid_len == 0:
        lse = torch.full(q.shape[:3], math.log(2.0) * DEFAULT_MASK_VALUE,
                         dtype=torch.float32, device=q.device)
        return torch.zeros_like(q), lse
    return attention_reference_with_lse(
        q, k[:, :, :kv_valid_len], v[:, :, :kv_valid_len], scale=scale, causal=causal)


def _masked_reference(q, k, v, *, scale, keep, bias=None, softcap=None):
    """The exact f32 ``(O, LSE)`` over the pairs of ``keep``, with the scores
    capped by ``softcap`` and then ``bias`` added before the mask, dead rows
    as the kernel stores them. A row is dead when it keeps no pair or, as in
    the kernels (csrc/fwd_sm90_tile.cuh), when its largest score is at or below
    half the mask value in the log2 domain: a padding mask turned additive
    (``DEFAULT_MASK_VALUE`` on every key of the row) leaves nothing to
    attend."""
    kf, vf = _expand_kv(k, v, q.shape[1])
    with _full_f32_matmul():
        s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if bias is not None:
            s = s + bias.float()
        s = torch.where(keep, s, torch.full_like(s, DEFAULT_MASK_VALUE))
        lse = torch.logsumexp(s, dim=-1)
        o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    alive = keep.any(dim=-1)
    if bias is not None:
        alive = alive & (s.amax(dim=-1) * _LOG2E > 0.5 * DEFAULT_MASK_VALUE)
    lse = torch.where(alive, lse, torch.full_like(lse, math.log(2.0) * DEFAULT_MASK_VALUE))
    o = torch.where(alive[..., None], o, torch.zeros_like(o))
    return o.to(q.dtype), lse


def check_segment_ids(segment_ids, B: int, Nq: int, Nk: int, device):
    """Validate kernel-level ``segment_ids``: None, or ``(seg_q, seg_kv)``
    integer tensors of shapes ``(B, Nq)`` / ``(B, Nk)`` on ``device``."""
    if segment_ids is None:
        return
    for ids, n in zip(segment_ids, (Nq, Nk)):
        if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise ValueError(f"segment ids must be integers, got {ids.dtype}")
        if tuple(ids.shape) != (B, n) or ids.device != device:
            raise ValueError(f"segment ids {tuple(ids.shape)} on {ids.device} must be "
                             f"({B}, {n}) on {device}")


def check_bias(bias, B: int, Hq: int, Nq: int, Nk: int, device):
    """Validate a kernel-level ``bias``: None, or a floating tensor of shape
    ``(B|1, Hq|1, Nq|1, Nk)`` on ``device``."""
    if bias is None:
        return
    if bias.ndim != 4 or not bias.dtype.is_floating_point:
        raise ValueError(f"bias must be a rank-4 floating tensor, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    Bb, Hb, Nqb, Nkb = bias.shape
    if Bb not in (1, B) or Hb not in (1, Hq) or Nqb not in (1, Nq) or Nkb != Nk:
        raise ValueError(f"bias {tuple(bias.shape)} must be (1|{B}, 1|{Hq}, 1|{Nq}, {Nk})")
    if bias.device != device:
        raise ValueError(f"bias on {bias.device}, q on {device}")


def kernel_bias(bias):
    """``bias`` as the kernel reads it -- f32 (cast once, as the TPU kernel's
    ``.astype(jnp.float32)``), unit column stride -- and its (batch, head,
    row) strides, 0 on broadcast dims, so a ``[1, 1, 1, Nk]`` bias is never
    expanded. ``(None, (0, 0, 0))`` without bias."""
    if bias is None:
        return None, (0, 0, 0)
    bias = bias.to(torch.float32)
    if bias.stride(-1) != 1:
        bias = bias.contiguous()
    return bias, tuple(0 if n == 1 else s for s, n in zip(bias.stride()[:3], bias.shape[:3]))


def _check_quant(k, v, k_scale, v_scale, B: int, Hkv: int, Nk: int):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        if k.dtype in QUANT_DTYPES or v.dtype in QUANT_DTYPES:
            raise ValueError(f"{k.dtype} K/V need k_scale and v_scale")
        return
    if k.dtype not in QUANT_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"k_scale/v_scale take int8 or float8_e4m3fn K/V, got {k.dtype}, "
                         f"{v.dtype}")
    for s in (k_scale, v_scale):
        if tuple(s.shape) != (B, Hkv, Nk) or s.device != k.device:
            raise ValueError(f"K/V scales {tuple(s.shape)} on {s.device} must be "
                             f"({B}, {Hkv}, {Nk}) on {k.device}")


def _kernel_ready(x: torch.Tensor, align: int | None = None, *, tma: bool = False) -> torch.Tensor:
    """``x`` itself if the kernel can address it -- unit head-dim stride, an
    address and other strides aligned to ``align`` bytes (default 8
    elements: 16 bytes for bf16; the decode kernel's 16-byte copies ask for
    16, as a TMA map does) and, for a TMA map's operand (``tma``), no zero
    stride on a dim of extent > 1 (an expanded view) -- else a copy, its rows
    padded to ``align`` bytes where D's are not a multiple of it (an 8-bit
    row of D % 16 == 8 for a TMA map; the padding is never read: the map's
    column extent is D)."""
    esize = x.element_size()
    align = 8 * esize if align is None else align
    ok = (x.stride(-1) == 1 and x.data_ptr() % align == 0
          and all(s * esize % align == 0 and (s or not tma)
                  for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1))
    if ok:
        return x
    D = x.shape[-1]
    pad = -(D * esize) % align // esize
    if not pad:
        return x.contiguous()
    padded = x.new_empty((*x.shape[:-1], D + pad))
    padded[..., :D] = x
    return padded[..., :D]


def decode_route(*, rows: int, causal: bool, segment_ids, window, head_dim: int) -> bool:
    """Whether a CUDA K1 call goes to the decode kernel: at most
    ``DECODE_MAX_ROWS`` query rows per KV head (``rows = Hq / Hkv · Nq``, the
    GQA fold's rows), not causal, no segment ids, no window, and a head dim of
    64 or 128 (the only ones instantiated; other head dims keep the dense
    route). Every call ``decode_step`` makes qualifies, with or without a
    bias, a softcap or int8 / fp8 K/V; on 8-bit K/V an f32 q too (the
    kernel's f32-q form, ``csrc/flash_decode_quant_f32.cu``)."""
    return (rows <= DECODE_MAX_ROWS and not causal and segment_ids is None
            and kernel_window(check_window(window)) == (-1, -1)
            and head_dim in DECODE_HEAD_DIMS)


def bias_route(*, rows: int, causal: bool, segment_ids, window, head_dim: int, bias,
               kv_dtype) -> bool:
    """Whether a CUDA K1 call goes to the Hopper bias kernel
    (``csrc/fwd_sm90_tile.cuh``): a call that :func:`decode_route` does not
    take (it is checked first), with a ``bias``, bf16 K/V and a head dim up
    to ``MAX_HEAD_DIM`` (a multiple of 8, as every CUDA K1 call's; D 136-256
    on its D 256 form) -- causal or not, with or without a window, segment
    ids, q / kv offsets or a softcap. The other calls with a bias on bf16 K/V
    are the decode route's; on int8 / fp8 K/V they go to the quantized route
    (:func:`quant_route`), which takes a bias with every option too."""
    return (bias is not None and kv_dtype == torch.bfloat16
            and head_dim <= MAX_HEAD_DIM
            and not decode_route(rows=rows, causal=causal, segment_ids=segment_ids,
                                 window=window, head_dim=head_dim))


def dense_route(*, head_dim: int, bias, kv_dtype) -> bool:
    """Whether a CUDA K1 call that the decode and bias routes left (:func:`fwd`
    checks them first) goes to the Hopper dense kernel
    (``csrc/flash_fwd_sm90.cu``): bf16 K/V without a bias, at every head dim
    up to ``MAX_HEAD_DIM`` (a multiple of 8, as every CUDA K1 call's; D 136-256
    on its D 256 form) -- causal or not, with or without a window, segment
    ids, q / kv offsets or a softcap, at any Nq (a decode-shaped call at D 256
    too) and kv_valid_len. The calls it refuses with bf16 K/V are the bias
    route's; those on int8 / fp8 K/V the quantized route's."""
    return bias is None and kv_dtype == torch.bfloat16 and head_dim <= MAX_HEAD_DIM


def quant_route(*, head_dim: int, kv_dtype) -> bool:
    """Whether a CUDA K1 call that the decode route left (:func:`fwd` checks
    it first) goes to the Hopper quantized kernel
    (``csrc/flash_fwd_quant_sm90.cu``): int8 / float8_e4m3fn K/V at every
    head dim up to ``MAX_HEAD_DIM`` (a multiple of 8, as every CUDA K1
    call's) -- causal or not, with or without a window, segment ids, q / kv
    offsets or a bias, at any Nq and kv_valid_len (a decode-shaped call at a
    head dim the decode kernel lacks too), under a bf16 q or, in its f32-q
    form (``csrc/flash_fwd_quant_f32.cu``), an f32 one. No softcap:
    quantized K/V with one raise in :func:`fwd`, as in the JAX package."""
    return kv_dtype in QUANT_DTYPES and head_dim <= MAX_HEAD_DIM


def f32_route(*, dtype, kv_dtype=None) -> bool:
    """Whether a CUDA K1 call goes to the f32 kernel (``csrc/flash_fwd_f32.cu``):
    every call on an f32 q over f32 K/V -- causal or not, with or without a
    window, segment ids, a softcap, q / kv offsets or an additive bias (its
    BIAS family), at any Nq (decode shapes too) and every head dim up to
    ``MAX_HEAD_DIM`` (a multiple of 8; D 136-256 on its D 256 form).
    :func:`fwd` checks it before the other routes. An f32 q over int8 / fp8
    K/V (``kv_dtype``) goes to the decode or the quantized route's f32-q
    form; no f32 call reaches a kernel that rounds q to bf16."""
    return dtype == torch.float32 and kv_dtype not in QUANT_DTYPES


def _whole_tiles(ids: torch.Tensor, n_valid: int, tile: int) -> torch.Tensor:
    """``ids[:, :n_valid]`` (``n_valid`` >= 1) as ``[B, tiles, tile]``, the
    last tile padded with its last id (which moves no tile's min or max): a
    view, without a copy, where the ids' layout allows one."""
    x = ids[:, :n_valid]
    pad = -n_valid % tile
    if pad:
        x = torch.cat((x, x[:, -1:].expand(-1, pad)), dim=1)
    return x.reshape(x.shape[0], -1, tile)


def seg_tile_ranges(ids: torch.Tensor, n_valid: int, tile: int) -> torch.Tensor:
    """``[B, ceil(n_valid / tile), 2]`` int32: the (min, max) id of each
    ``tile``-long run of ``ids[:, :n_valid]`` (the last run ragged), by one
    ``aminmax`` over the ids cut to whole tiles. Two tiles hold a pair of
    equal ids only if their ranges meet (exact for sorted, packed ids;
    conservative for any), the test of the JAX package's ``_seg_block_flags``
    (flashattn_tpu/ops/flash.py:312), whose padded rows the port never
    reads."""
    return torch.stack(_whole_tiles(ids.to(torch.int32), n_valid, tile).aminmax(dim=-1), dim=-1)


def dense_kv_tile(head_dim: int) -> int:
    """The keys of K1's dense route's KV tile at ``head_dim``: the width of
    its segment-id tile ranges (:func:`sm90_segments`' ``kv_tile``)."""
    return SM90_KV_TILE if head_dim <= DENSE_MAX_HEAD_DIM else SM90_WIDE_KV_TILE


def sm90_segments(segment_ids, Nq: int, kv_valid_len: int, *, q_tile: int = SM90_Q_TILE,
                  kv_tile: int = SM90_KV_TILE, pad_q: bool = False):
    """A Hopper kernel's segment inputs for ``(seg_q [B, Nq], seg_kv [B,
    Nk])``: seg_q as int32 with a unit row stride (with ``pad_q``, its rows
    contiguous and padded to whole ``q_tile`` tiles, one bulk copy a tile);
    seg_kv's first kv_valid_len ids, contiguous, each row padded to whole
    ``kv_tile`` tiles (one 16-byte-aligned bulk copy a tile); the id ranges
    of each ``q_tile`` rows of seg_q and each ``kv_tile`` keys of seg_kv
    (:func:`seg_tile_ranges`). The defaults are K1's bias route's tiles and
    its dense route's up to D 128 (above, :func:`dense_kv_tile`); the
    backward (``flash_bwd.split_bwd``) asks for its own. None without
    segments or keys. A handful of small launches: the wrapper's host time is
    part of each kernel call."""
    if segment_ids is None or kv_valid_len == 0:
        return None
    seg_q, seg_kv = (x.to(torch.int32) for x in segment_ids)
    if pad_q:
        q = _whole_tiles(seg_q, Nq, q_tile).contiguous()
        seg_q, q_rng = q.view(q.shape[0], -1), torch.stack(q.aminmax(dim=-1), dim=-1)
    else:
        if seg_q.stride(-1) != 1:
            seg_q = seg_q.contiguous()
        q_rng = seg_tile_ranges(seg_q, Nq, q_tile)
    kv = _whole_tiles(seg_kv, kv_valid_len, kv_tile).contiguous()
    return seg_q, kv.view(kv.shape[0], -1), q_rng, torch.stack(kv.aminmax(dim=-1), dim=-1)


def decode_splits(B: int, Hkv: int, Nk: int, sms: int = H100_SMS) -> tuple[int, int]:
    """``(splits, split_len)`` of the decode kernel's grid (split, KV head,
    batch) over ``Nk`` keys: as many splits as keep the grid within
    ``DECODE_CTAS_PER_SM`` CTAs per SM (at least one), but no split under
    ``DECODE_MIN_TILES`` KV tiles; each split a whole number of
    ``DECODE_TILE``-key tiles, and none empty (split s holds keys [s ·
    split_len, min((s + 1) · split_len, Nk))). ``Nk == 0`` gives one empty
    split."""
    if Nk <= 0:
        return 1, DECODE_TILE
    want = DECODE_CTAS_PER_SM * sms // (B * Hkv)
    splits = max(1, min(want, Nk // (DECODE_TILE * DECODE_MIN_TILES)))
    split_len = -(-Nk // (DECODE_TILE * splits)) * DECODE_TILE
    return -(-Nk // split_len), split_len


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def decode_reference(q, k, v, *, scale: float, kv_valid_len: int | None = None, bias=None,
                     k_scale=None, v_scale=None, softcap=None, splits: int | None = None):
    """Plain PyTorch of the decode kernel: ``(O, LSE)`` as :func:`fwd` gives
    them, through the kernel's split / merge algebra in f32.

    The keys below ``kv_valid_len`` are cut as :func:`decode_splits` cuts
    them on an H100's 132 SMs, or, given ``splits``, into runs of
    ``ceil(kv_valid_len / splits)`` keys (the algebra holds for any cut; on
    another card pass ``splits=decode_splits(..., sms)[0]``). Per split:
    scores ``x = s · scale · log2 e`` (the column's ``k_scale`` first for
    int8 / fp8 K; with ``softcap``, ``cap · log2 e · tanh(s · scale /
    cap)``), plus ``bias · log2 e`` floored at the mask value; the split's
    unnormalized partial ``m = max x``, ``l = Σ 2^(x − m)``, ``acc = Σ
    2^(x − m) · v_scale · v``. The merge drops a partial whose ``m`` is at or
    below half the mask value and combines the rest in LSE space: ``O = Σ
    2^(m_s − M) acc_s / Σ 2^(m_s − M) l_s``, ``LSE = M ln 2 + log L``; a row
    with no live partial is dead (O = 0, LSE = ln2 · mask value)."""
    B, Hq, Nq, D = q.shape
    Hkv, Nk = k.shape[1], k.shape[2]
    nkv = Nk if kv_valid_len is None else int(kv_valid_len)
    dead_lse = math.log(2.0) * DEFAULT_MASK_VALUE
    if nkv == 0:
        return (torch.zeros_like(q),
                torch.full((B, Hq, Nq), dead_lse, dtype=torch.float32, device=q.device))
    kf, vf = k[:, :, :nkv].float(), v[:, :, :nkv].float()
    if k_scale is not None:
        kf = kf * k_scale[:, :, :nkv].float()[..., None]
        vf = vf * v_scale[:, :, :nkv].float()[..., None]
    kf, vf = _expand_kv(kf, vf, Hq)
    mask = torch.tensor(DEFAULT_MASK_VALUE, dtype=torch.float32, device=q.device)
    with _full_f32_matmul():
        s = torch.matmul(q.float(), kf.transpose(-1, -2))
        if softcap is not None:
            x = softcap * _LOG2E * torch.tanh(s * (scale / softcap))
        else:
            x = s * (scale * _LOG2E)
        if bias is not None:
            x = torch.maximum(x + bias[..., :nkv].float() * _LOG2E, mask)
        if splits is None:
            splits, split_len = decode_splits(B, Hkv, nkv)
        else:
            split_len = -(-nkv // splits)
        ms, ls, accs = [], [], []
        for lo in range(0, nkv, split_len):
            xs = x[..., lo:lo + split_len]
            m = xs.amax(dim=-1)
            p = torch.exp2(xs - m[..., None])
            ms.append(m)
            ls.append(p.sum(dim=-1))
            accs.append(torch.matmul(p, vf[:, :, lo:lo + split_len]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    live = m > 0.5 * DEFAULT_MASK_VALUE
    m_max = torch.where(live, m, torch.full_like(m, -math.inf)).amax(dim=0)
    alive = live.any(dim=0)
    w = torch.where(live, torch.exp2(m - torch.where(alive, m_max, 0.0)), 0.0)
    l_sum = (w * l).sum(dim=0)
    o = (w[..., None] * acc).sum(dim=0) / torch.where(alive, l_sum, 1.0)[..., None]
    lse = torch.where(alive, m_max * math.log(2.0) + torch.log(torch.where(alive, l_sum, 1.0)),
                      dead_lse)
    o = torch.where(alive[..., None], o, 0.0)
    return o.to(q.dtype), lse


def _decode(q, k, v, *, scale, kv_valid_len, bias, k_scale, v_scale, softcap):
    """Launch the decode kernel (and, with more than one split, its merge)
    and count the launch: ``fa_decode`` on a bf16 q, ``fa_decode_f32`` (the
    f32-q form, over int8 / fp8 K/V; O in f32) on an f32 one."""
    B, Hq, Nq, D = q.shape
    Hkv = k.shape[1]
    f32 = q.dtype == torch.float32
    q = _kernel_ready(q, 8) if f32 else _kernel_ready(q)
    k, v = _kernel_ready(k, 16), _kernel_ready(v, 16)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    splits, split_len = decode_splits(B, Hkv, kv_valid_len, _sm_count(q.device.index or 0))
    part_acc = part_ml = None
    if splits > 1:
        rows = Hq // Hkv * Nq
        part_acc = torch.empty((B, Hkv, splits, rows, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, Hkv, splits, rows, 2), dtype=torch.float32, device=q.device)
    bias, bias_strides = kernel_bias(bias)
    scales = (None, None) if k_scale is None else (k_scale.float(), v_scale.float())
    scale_strides = [x for s in scales for x in (s.stride() if s is not None else (0, 0, 0))]
    ptrs = [None if x is None else x.data_ptr() for x in (bias, *scales, part_acc, part_ml)]
    with torch.cuda.device(q.device):
        lib = native.kernels()
        rc = (lib.fa_decode_f32 if f32 else lib.fa_decode)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *ptrs,
            KV_DTYPE_CODE[k.dtype], B, Hq, Hkv, Nq, D, kv_valid_len, splits, split_len,
            float(scale), softcap or 0.0, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *bias_strides, *scale_strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    native.check(rc, "flash_decode kernel launch")
    _count_variants(k.dtype, bias, False, softcap)
    if f32:
        fwd.launches_decode_f32 += 1
    else:
        fwd.launches_decode += 1
    if splits > 1:
        fwd.launches_merge += 1
    return o, lse


def sm90_bias(bias) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """``bias`` as the bias kernel's 16-byte copies read it: :func:`kernel_bias`
    if its address and strides allow them, else a copy whose rows are padded
    with zeros to a multiple of ``BIAS_ROW_ALIGN`` columns (the kernel reads
    no column at or past ``kv_valid_len``, so none of the padding)."""
    bias, strides = kernel_bias(bias)
    if bias.data_ptr() % 16 or any(s % BIAS_ROW_ALIGN for s in strides):
        nk = bias.shape[-1]
        padded = bias.new_zeros((*bias.shape[:-1], nk + -nk % BIAS_ROW_ALIGN))
        padded[..., :nk] = bias
        bias, strides = kernel_bias(padded[..., :nk])
    return bias, strides


def _launch_bias_sm90(lib, q, k, v, o, lse, bias, bias_strides, seg, *, scale, kv_valid_len,
                      causal, window, softcap, stream, q_offset: int = 0,
                      kv_offset: int = 0) -> int:
    """Call ``lib.fa_fwd_bias_sm90`` with the arguments of one launch (the
    C entry's order, ``native.FWD_BIAS_SM90_ARGTYPES``: the dense route's
    with the bias after lse and its strides before seg_q's), ``seg`` being
    :func:`sm90_segments`' tensors or None; returns its cudaError_t."""
    B, Hq, Nq, D = q.shape
    seg_ptrs = (None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg)
    return lib.fa_fwd_bias_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bias.data_ptr(),
        *seg_ptrs, B, Hq, k.shape[1], Nq, D, kv_valid_len, int(bool(causal)),
        *kernel_window(window), q_offset, kv_offset, float(scale), softcap or 0.0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *bias_strides,
        0 if seg is None else seg[0].stride(0), stream)


def _bias_sm90(q, k, v, *, scale, kv_valid_len, causal, window, segment_ids, bias, softcap,
               q_offset, kv_offset):
    """Launch the Hopper bias kernel (its D 256 form above
    ``DENSE_MAX_HEAD_DIM``) and count the launch."""
    B, Hq, Nq, D = q.shape
    q, k, v = (_kernel_ready(x, tma=True) for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    bias, bias_strides = sm90_bias(bias)
    seg = sm90_segments(segment_ids, Nq, kv_valid_len)
    with torch.cuda.device(q.device):
        rc = _launch_bias_sm90(native.kernels(), q, k, v, o, lse, bias, bias_strides, seg,
                               scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                               window=window, softcap=softcap,
                               stream=torch.cuda.current_stream(q.device).cuda_stream,
                               q_offset=q_offset, kv_offset=kv_offset)
    native.check(rc, "flash_fwd_bias_sm90 kernel launch")
    _count_variants(k.dtype, bias, kernel_window(window) != (-1, -1), softcap)
    fwd.launches_bias_sm90 += 1
    if D > DENSE_MAX_HEAD_DIM:
        fwd.launches_bias_d256 += 1
    return o, lse


def _launch_dense_sm90(lib, q, k, v, o, lse, seg, *, scale, kv_valid_len, causal, window,
                      softcap, stream, q_offset: int = 0, kv_offset: int = 0,
                      pieces: torch.Tensor | None = None, bias: torch.Tensor | None = None,
                      bias_strides: tuple[int, int, int] = (0, 0, 0)) -> int:
    """Call ``lib.fa_fwd_sm90`` -- or, given ``pieces`` (the bf16 scratch of
    ``f32_split.scratch``), ``lib.fa_fwd_f32``, whose arguments are the same
    with ``pieces`` after lse and the f32 ``bias`` (:func:`sm90_bias`' tensor,
    or None) with its ``bias_strides`` before the stream -- with the
    arguments of one launch (the C entry's order,
    ``native.FWD_SM90_ARGTYPES`` / ``FWD_F32_ARGTYPES``), ``seg`` being
    :func:`sm90_segments`' tensors or None; returns its cudaError_t."""
    B, Hq, Nq, D = q.shape
    seg_ptrs = (None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg)
    if pieces is None:
        entry, scratch, tail = lib.fa_fwd_sm90, (), ()
    else:
        entry, scratch = lib.fa_fwd_f32, (pieces.data_ptr(),)
        tail = (None if bias is None else bias.data_ptr(), *bias_strides)
    return entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *scratch,
        *seg_ptrs, B, Hq, k.shape[1], Nq, D, kv_valid_len, int(bool(causal)),
        *kernel_window(window), q_offset, kv_offset, float(scale), softcap or 0.0,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        0 if seg is None else seg[0].stride(0), *tail, stream)


def _dense_sm90(q, k, v, *, scale, kv_valid_len, causal, window, segment_ids, softcap,
                q_offset, kv_offset):
    """Launch the Hopper dense kernel and count the launch."""
    B, Hq, Nq, D = q.shape
    q, k, v = (_kernel_ready(x, tma=True) for x in (q, k, v))
    o = torch.empty_like(q)  # preserve_format: keeps q's (e.g. BNHD) strides
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:  # an empty grid is not a valid launch
        return o, lse
    seg = sm90_segments(segment_ids, Nq, kv_valid_len, kv_tile=dense_kv_tile(D))
    with torch.cuda.device(q.device):
        rc = _launch_dense_sm90(native.kernels(), q, k, v, o, lse, seg, scale=scale,
                                kv_valid_len=kv_valid_len, causal=causal, window=window,
                                softcap=softcap,
                                stream=torch.cuda.current_stream(q.device).cuda_stream,
                                q_offset=q_offset, kv_offset=kv_offset)
    native.check(rc, "flash_fwd_sm90 kernel launch")
    _count_variants(k.dtype, None, kernel_window(window) != (-1, -1), softcap)
    fwd.launches_dense_sm90 += 1
    if D > DENSE_MAX_HEAD_DIM:
        fwd.launches_dense_d256 += 1
    return o, lse


def _launch_quant_sm90(lib, q, k, v, o, lse, k_scale, v_scale, bias, bias_strides, seg, *,
                       scale, kv_valid_len, causal, window, stream, q_offset: int = 0,
                       kv_offset: int = 0, pieces: torch.Tensor | None = None) -> int:
    """Call ``lib.fa_fwd_quant_sm90`` -- or, given ``pieces`` (the bf16
    scratch of an f32 q's three pieces, ``f32_split.scratch``),
    ``lib.fa_fwd_quant_f32``, whose arguments are the same with ``pieces``
    after lse -- with the arguments of one launch (the C entry's order,
    ``native.FWD_QUANT_SM90_ARGTYPES`` / ``FWD_QUANT_F32_ARGTYPES``),
    ``k_scale`` / ``v_scale`` being f32 ``[B, Hkv, Nk]`` views (any strides),
    ``bias`` :func:`sm90_bias`' tensor or None and ``seg``
    :func:`sm90_segments`' tensors or None; returns its cudaError_t."""
    B, Hq, Nq, D = q.shape
    seg_ptrs = (None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg)
    entry, scratch = ((lib.fa_fwd_quant_sm90, ()) if pieces is None
                      else (lib.fa_fwd_quant_f32, (pieces.data_ptr(),)))
    return entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), *scratch,
        k_scale.data_ptr(), v_scale.data_ptr(), None if bias is None else bias.data_ptr(),
        *seg_ptrs, KV_DTYPE_CODE[k.dtype], B, Hq, k.shape[1], Nq, D, kv_valid_len,
        int(bool(causal)), *kernel_window(window), q_offset, kv_offset, float(scale),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *bias_strides,
        *k_scale.stride(), *v_scale.stride(), 0 if seg is None else seg[0].stride(0), stream)


def _quant_sm90(q, k, v, *, scale, kv_valid_len, causal, window, segment_ids, bias, k_scale,
                v_scale, q_offset, kv_offset):
    """Launch the Hopper quantized kernel and count the launch: K / V as
    their TMA maps read them (:func:`_kernel_ready` with 16-byte rows), the
    scales in f32 as they are (BNHD's transposed views too), a bias as
    :func:`sm90_bias` gives it. An f32 q takes the kernel's f32-q form, its
    C entry splitting q alone into the pieces' scratch first (both launches
    counted; O in f32)."""
    B, Hq, Nq, D = q.shape
    f32 = q.dtype == torch.float32
    if f32:
        q = q if q.stride(-1) == 1 else q.contiguous()
    else:
        q = _kernel_ready(q, tma=True)
    k, v = (_kernel_ready(x, 16, tma=True) for x in (k, v))
    o = torch.empty_like(q)  # preserve_format: keeps q's (e.g. BNHD) strides
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:  # an empty grid is not a valid launch
        return o, lse
    bias, bias_strides = (None, (0, 0, 0)) if bias is None else sm90_bias(bias)
    seg = sm90_segments(segment_ids, Nq, kv_valid_len)
    pieces = f32_split.scratch(B * Hq * Nq, 0, D, q.device) if f32 else None
    with torch.cuda.device(q.device):
        rc = _launch_quant_sm90(native.kernels(), q, k, v, o, lse, k_scale.float(),
                                v_scale.float(), bias, bias_strides, seg, scale=scale,
                                kv_valid_len=kv_valid_len, causal=causal, window=window,
                                stream=torch.cuda.current_stream(q.device).cuda_stream,
                                q_offset=q_offset, kv_offset=kv_offset, pieces=pieces)
    native.check(rc, "flash_fwd_quant_sm90 kernel launch")
    _count_variants(k.dtype, bias, kernel_window(window) != (-1, -1), None)
    if f32:
        fwd.launches_quant_f32 += 1
        fwd.launches_split += 1
    else:
        fwd.launches_quant_sm90 += 1
    return o, lse


def _dense_f32(q, k, v, *, scale, kv_valid_len, causal, window, segment_ids, softcap,
               q_offset, kv_offset, bias=None):
    """Launch the f32 kernel's C entry -- the split of q, k and v into their
    bf16 pieces, then the kernel (its BIAS family with a ``bias``, read as
    :func:`sm90_bias` gives it) -- and count both launches."""
    B, Hq, Nq, D = q.shape
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    o = torch.empty_like(q)  # preserve_format: keeps q's (e.g. BNHD) strides
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:  # an empty grid is not a valid launch
        return o, lse
    pieces = f32_split.scratch(B * Hq * Nq, B * k.shape[1] * kv_valid_len, D, q.device)
    seg = sm90_segments(segment_ids, Nq, kv_valid_len, q_tile=F32_Q_TILE, kv_tile=F32_KV_TILE)
    bias, bias_strides = (None, (0, 0, 0)) if bias is None else sm90_bias(bias)
    with torch.cuda.device(q.device):
        rc = _launch_dense_sm90(native.kernels(), q, k, v, o, lse, seg, scale=scale,
                                kv_valid_len=kv_valid_len, causal=causal, window=window,
                                softcap=softcap,
                                stream=torch.cuda.current_stream(q.device).cuda_stream,
                                q_offset=q_offset, kv_offset=kv_offset, pieces=pieces,
                                bias=bias, bias_strides=bias_strides)
    native.check(rc, "flash_fwd_f32 kernel launch")
    _count_variants(k.dtype, bias, kernel_window(window) != (-1, -1), softcap)
    fwd.launches_f32 += 1
    fwd.launches_f32_bias += int(bias is not None)
    fwd.launches_f32_d256 += int(D > DENSE_MAX_HEAD_DIM)
    fwd.launches_split += 1
    return o, lse


def _check_kernel_args(q, *, segment_ids, bias, k_scale, windowed: bool,
                       offsets: bool = False) -> None:
    """Raise for what no CUDA K1 kernel takes: another device, a q that is
    neither bf16 nor f32, D not a multiple of 8 or above ``MAX_HEAD_DIM``, a
    grid past the CUDA limits. Segment ids, a window, ``offsets`` (that
    change the result) and a ``bias`` pass in every combination at every head
    dim, under a bf16 or an f32 q, on its own dtype's K/V or quantized K/V:
    K1's routes take them all."""
    B, Hq, _, D = q.shape
    if q.device.type != "cuda":
        raise NotImplementedError(f"no K1 kernel for device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"the CUDA K1 takes bfloat16 or float32, got {q.dtype} (flash_attention casts "
            "other dtypes to bfloat16)")
    if D % 8 or D > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the CUDA K1 takes head dims that are multiples of 8 up to "
            f"{MAX_HEAD_DIM}, got D={D} (ROADMAP queue 2, K1 options: head dims above 256)")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must each be at most 65535 (CUDA grid limit)")


def fwd(q, k, v, *, scale: float, kv_valid_len: int | None = None, causal: bool = False,
        segment_ids=None, bias=None, k_scale=None, v_scale=None, window=None, softcap=None,
        q_offset: int = 0, kv_offset: int = 0):
    """K1: ``(O [B,Hq,Nq,D] in q.dtype, LSE [B,Hq,Nq] f32)``.

    ``causal`` masks ``kv_pos > q_pos``; ``window = (left, right)`` keeps
    ``q_pos - left <= kv_pos <= q_pos + right`` (a negative bound is none;
    with ``causal`` the right bound is 0), in absolute positions ``q_pos =
    q_offset + i`` and ``kv_pos = kv_offset + j`` (host ints or 0-d tensors; 0
    and 0: the top-left alignment, also when Nq != Nk);
    ``segment_ids = (seg_q [B, Nq], seg_kv [B, Nk])`` (integers) lets a pair
    attend only when its ids are equal; ``softcap`` (a positive float) caps
    the scaled scores at ``softcap · tanh(s / softcap)``; ``bias``
    ``[B|1, Hq|1, Nq|1, Nk]`` is added to the (capped) scores; int8 /
    float8_e4m3fn ``k``/``v`` take per-token ``k_scale``/``v_scale``
    ``[B, Hkv, Nk]`` and are dequantized in the kernel (not with a softcap).
    CPU tensors take :func:`fwd_reference`. CUDA tensors launch the kernel,
    which takes a bf16 or f32 ``q`` (and K/V of its dtype, int8 or fp8) with
    ``D % 8 == 0`` and ``D <= 256`` with every option above; anything else
    raises. An f32 call on f32 K/V
    (:func:`f32_route`) launches the f32 kernel (with a bias, its BIAS
    family); a CUDA call that :func:`decode_route` accepts launches the
    split-KV decode kernel (and its merge), one that :func:`bias_route`
    accepts (every other bf16 call with a bias) the Hopper bias kernel, one
    that :func:`dense_route` accepts (every bf16 call without a bias) the
    Hopper dense kernel, one that :func:`quant_route` accepts (every other
    call on int8 / fp8 K/V) the Hopper quantized kernel -- under an f32 q
    the decode and quantized kernels' f32-q forms. ``fwd.launches``
    counts every K1 launch, on any kernel;
    ``fwd.launches_bias`` those of bf16 or f32 K/V with a bias (on any
    kernel), ``fwd.launches_bias_sm90`` those of the bias kernel
    (``fwd.launches_bias_d256`` those of its D 256 form, D 136-256),
    ``fwd.launches_dense_sm90`` those of the Hopper dense kernel
    (``fwd.launches_dense_d256`` those of its D 256 form, D 136-256),
    ``fwd.launches_quant_sm90`` those of the Hopper quantized kernel
    (``fwd.launches_quant_f32`` those of its f32-q form, which count a
    split of q each in ``fwd.launches_split``),
    ``fwd.launches_f32`` those of the f32 kernel (``fwd.launches_f32_bias``
    those with a bias, also counted in ``fwd.launches_bias``;
    ``fwd.launches_f32_d256`` those of its D 256 form, D 136-256), ``fwd.launches_split``
    those of the split of its operands (``f32_split``, one before each),
    ``fwd.launches_int8`` / ``fwd.launches_fp8`` those of quantized K/V (with
    or without a bias), ``fwd.launches_window`` those with a window,
    ``fwd.launches_softcap`` those with a softcap, ``fwd.launches_decode``
    those of the decode kernel (``fwd.launches_decode_f32`` those of its
    f32-q form) and ``fwd.launches_merge`` those of its merge kernel (a call
    with more than one split, on either form).
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4, got {q.shape}, {k.shape}, {v.shape}")
    B, Hq, Nq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} incompatible with q {tuple(q.shape)}")
    Hkv, Nk = k.shape[1], k.shape[2]
    if Hq % Hkv != 0:
        raise ValueError(f"GQA requires Hkv | Hq: Hq={Hq}, Hkv={Hkv}")
    _check_quant(k, v, k_scale, v_scale, B, Hkv, Nk)
    if k_scale is None and (q.dtype != k.dtype or q.dtype != v.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    kv_valid_len = Nk if kv_valid_len is None else int(kv_valid_len)
    if not 0 <= kv_valid_len <= Nk:
        raise ValueError(f"kv_valid_len={kv_valid_len} outside [0, {Nk}]")
    check_segment_ids(segment_ids, B, Nq, Nk, q.device)
    check_bias(bias, B, Hq, Nq, Nk, q.device)
    window, softcap = check_window(window), check_softcap(softcap)
    if softcap is not None and k_scale is not None:
        raise ValueError("logit_softcap is not supported with quantized K/V (the JAX "
                         "flash_attention_quantized has no softcap path)")
    q_offset, kv_offset = band_offsets(causal, window, q_offset, kv_offset)

    if q.device.type == "cpu":
        return fwd_reference(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                             segment_ids=segment_ids, bias=bias, k_scale=k_scale,
                             v_scale=v_scale, window=window, softcap=softcap,
                             q_offset=q_offset, kv_offset=kv_offset)
    windowed = kernel_window(window) != (-1, -1)
    _check_kernel_args(q, segment_ids=segment_ids, bias=bias, k_scale=k_scale,
                       windowed=windowed, offsets=q_offset != kv_offset)

    if f32_route(dtype=q.dtype, kv_dtype=k.dtype):
        return _dense_f32(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                          window=window, segment_ids=segment_ids, softcap=softcap,
                          q_offset=q_offset, kv_offset=kv_offset, bias=bias)

    if decode_route(rows=Hq // Hkv * Nq, causal=causal, segment_ids=segment_ids, window=window,
                    head_dim=D):
        return _decode(q, k, v, scale=scale, kv_valid_len=kv_valid_len, bias=bias,
                       k_scale=k_scale, v_scale=v_scale, softcap=softcap)
    if bias_route(rows=Hq // Hkv * Nq, causal=causal, segment_ids=segment_ids, window=window,
                  head_dim=D, bias=bias, kv_dtype=k.dtype):
        return _bias_sm90(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                          window=window, segment_ids=segment_ids, bias=bias, softcap=softcap,
                          q_offset=q_offset, kv_offset=kv_offset)
    if dense_route(head_dim=D, bias=bias, kv_dtype=k.dtype):
        return _dense_sm90(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                           window=window, segment_ids=segment_ids, softcap=softcap,
                           q_offset=q_offset, kv_offset=kv_offset)

    if quant_route(head_dim=D, kv_dtype=k.dtype):
        return _quant_sm90(q, k, v, scale=scale, kv_valid_len=kv_valid_len, causal=causal,
                           window=window, segment_ids=segment_ids, bias=bias, k_scale=k_scale,
                           v_scale=v_scale, q_offset=q_offset, kv_offset=kv_offset)
    raise NotImplementedError(f"no K1 kernel takes {k.dtype} K/V at D={D}")


def _count_variants(kv_dtype, bias, windowed: bool, softcap) -> None:
    """Count one K1 launch and its variant (after a launch that succeeded)."""
    fwd.launches += 1
    if kv_dtype == torch.int8:
        fwd.launches_int8 += 1
    elif kv_dtype == torch.float8_e4m3fn:
        fwd.launches_fp8 += 1
    elif bias is not None:
        fwd.launches_bias += 1
    if windowed:
        fwd.launches_window += 1
    if softcap is not None:
        fwd.launches_softcap += 1


fwd.launches = 0
fwd.launches_bias = 0
fwd.launches_bias_sm90 = 0
fwd.launches_bias_d256 = 0
fwd.launches_dense_sm90 = 0
fwd.launches_dense_d256 = 0
fwd.launches_quant_sm90 = 0
fwd.launches_quant_f32 = 0
fwd.launches_f32 = 0
fwd.launches_f32_bias = 0
fwd.launches_f32_d256 = 0
fwd.launches_split = 0
fwd.launches_int8 = 0
fwd.launches_fp8 = 0
fwd.launches_window = 0
fwd.launches_softcap = 0
fwd.launches_decode = 0
fwd.launches_decode_f32 = 0
fwd.launches_merge = 0
