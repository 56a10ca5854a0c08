"""Ring attention: sequence-parallel fused attention over a ring of ranks
(port of flashattn_tpu/parallel/ring.py).

Each rank of a ring of P holds one contiguous sequence chunk of Q and of K/V.
The K/V chunks rotate one rank to the right per step; at each step a rank
computes the partial of the chunk it holds with the single-device K1 (its
dense route, with the chunks' global q / kv offsets, so the causal mask and
the window stay globally consistent) and merges it into its running result by
the LSE rule ``L = logaddexp(L1, L2); O = e^{L1-L} O1 + e^{L2-L} O2``. The
backward rotates (K, V) with their f32 (dK, dV) accumulators; after a final
hop every accumulator is home again.

Here rank and step are host ints, so :func:`_chunk_needed` is a Python bool
and a chunk pair outside the band is never launched (JAX traces it into
``lax.cond``). A chunk pair's gradients (:func:`_chunk_grads`) come from the
global LSE and Δ through K3 without segment ids and through K5 + K6's split
route with them: the port computes what the JAX ``_chunk_grads`` computes (K5
then K6), not how. K/V stay at Hkv heads through the ring, and each pair's dK
/ dV are reduced back to Hkv.

The rotation goes through a mesh's ring transport (``parallel/mesh.py``):
``ring_kernel.VirtualRanks`` for the ranks of one process (a side stream on
the card), ``ring_kernel.ProcessGroupRing`` for one rank per process. The
ring engine (:class:`_RingCore`) also runs the zigzag layout
(``parallel/zigzag.py``), whose ranks hold two sub-chunks each: a rank's Q
and a chunk's K/V are lists of parts at their own offsets, and every live
(Q part, K/V part) pair is one partial.
"""

from __future__ import annotations

import math

import torch

from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused
from flashattn_tpu_torch.ops.flash import _dispatch_dtype, flash_attention_with_lse
from flashattn_tpu_torch.ops.flash_fwd import check_window


def _perm(n: int) -> list[tuple[int, int]]:
    """The (source, destination) pairs of one rotation: rank i sends to i + 1."""
    return [(i, (i + 1) % n) for i in range(n)]


def _merge(o, lse, o_p, lse_p):
    """LSE-weighted merge of two normalized partials (f32): ``(O, LSE)``."""
    lse_new = torch.logaddexp(lse, lse_p)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_p - lse_new)[..., None]
    return o * w_old + o_p * w_new, lse_new


def _chunk_needed(q_off: int, kv_off: int, nq: int, nk: int, causal: bool, window) -> bool:
    """Whether a KV chunk at global columns ``[kv_off, kv_off + nk)`` holds a
    pair that a Q chunk at rows ``[q_off, q_off + nq)`` attends under
    ``causal`` and ``window = (left, right)`` (conservative: the JAX
    predicate, ring.py:190-200)."""
    wl, wr = window if window is not None else (-1, -1)
    needed = True
    if causal or wr >= 0:
        bound = q_off + nq - 1 + (wr if (wr >= 0 and not causal) else 0)
        needed = kv_off <= bound
    if wl >= 0:
        needed = needed and kv_off + nk - 1 >= q_off - wl
    return bool(needed)


def _partial_fwd(q, k_blk, v_blk, q_off: int, kv_off: int, *, causal, scale, window=None,
                 seg_q=None, seg_kv=None):
    """One chunk pair's normalized partial ``(O f32, LSE)`` by K1 with the
    pair's global offsets; a row that sees no key of the chunk gives O = 0
    and LSE = ln2 · mask value, which the merge weighs 0."""
    o_p, lse_p = flash_attention_with_lse(
        q, k_blk, v_blk, causal=causal, scale=scale, window=window, q_offset=q_off,
        kv_offset=kv_off, segment_ids=None if seg_q is None else (seg_q, seg_kv))
    return o_p.float(), lse_p


def _chunk_grads(q, k_blk, v_blk, do, lse, delta, q_off: int, kv_off: int, *, causal, scale,
                 window=None, seg_q=None, seg_kv=None):
    """One chunk pair's ``(dQ, dK, dV)`` in f32 from the GLOBAL LSE and Δ, so
    the partial gradients sum exactly: K3 without segment ids, K5 + K6's
    split route with them, each with the pair's offsets. dK / dV come back at
    the chunk's Hkv heads."""
    kw = dict(scale=scale, causal=causal, window=window, q_offset=q_off, kv_offset=kv_off)
    if seg_q is None:
        dq, dk, dv = flash_bwd_fused.bwd(q, k_blk, v_blk, do, lse, delta, **kw)
    else:
        dq, dk, dv = flash_bwd.split_bwd(q, k_blk, v_blk, do, lse, delta,
                                         segment_ids=(seg_q, seg_kv), **kw)
    B, H, nk, D = dk.shape
    Hkv = k_blk.shape[1]
    if Hkv != H:
        dk = dk.view(B, Hkv, H // Hkv, nk, D).sum(2)
        dv = dv.view(B, Hkv, H // Hkv, nk, D).sum(2)
    return dq, dk, dv


class _Layout:
    """Where a ring's rows sit: rank r's Q parts and the K/V parts of the
    chunk that rank ``src`` started with, each ``(start, length, global
    offset)`` along the local sequence. Contiguous: one part, at ``r · n``."""

    def __init__(self, world: int):
        self.world = world

    def q_parts(self, r: int, n: int):
        return [(0, n, r * n)]

    def kv_parts(self, src: int, n: int):
        return [(0, n, src * n)]


def _pairs(layout, r: int, step: int, nq: int, nk: int, causal, window):
    """The live (Q part, K/V part) pairs of rank ``r`` at ``step``."""
    src = (r - step) % layout.world
    return [(qp, kp) for qp in layout.q_parts(r, nq) for kp in layout.kv_parts(src, nk)
            if _chunk_needed(qp[2], kp[2], qp[1], kp[1], causal, window)]


def _part(x, p):
    return x.narrow(2, p[0], p[1])


class _RingCore(torch.autograd.Function):
    """The ring over one group of local ranks: ``cfg`` = (transport, layout,
    causal, scale, window, seg_q list or None, seg_kv list or None), then
    the members' q, k and v chunks (in ring order). Returns each member's O;
    the backward is the JAX ``_ring_core_bwd`` (its accumulators rotating
    with their chunk and taking the last hop home)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        xport, layout, causal, scale, window, seg_q, seg_kv = cfg
        n = len(tensors) // 3
        qs, ks, vs = tensors[:n], tensors[n:2 * n], tensors[2 * n:]
        nq, nk = qs[0].shape[2], ks[0].shape[2]
        f32 = dict(dtype=torch.float32, device=qs[0].device)
        os = [torch.zeros(q.shape, **f32) for q in qs]
        lses = [torch.full(q.shape[:3], -math.inf, **f32) for q in qs]
        cur = [(k, v) + (() if seg_kv is None else (seg_kv[i],)) for i, (k, v) in
               enumerate(zip(ks, vs))]
        slots = [[tuple(torch.empty_like(t) for t in c) for _ in range(2)] for c in cur]
        for step in range(layout.world):
            if step < layout.world - 1:  # step + 1's chunks move while this step computes
                nxt = [sl[(step + 1) % 2] for sl in slots]
                moving = xport.rotate(cur, nxt)
            for i, r in enumerate(xport.ranks):
                for qp, kp in _pairs(layout, r, step, nq, nk, causal, window):
                    o_p, lse_p = _partial_fwd(
                        _part(qs[i], qp), _part(cur[i][0], kp), _part(cur[i][1], kp), qp[2],
                        kp[2], causal=causal, scale=scale, window=window,
                        seg_q=None if seg_q is None else seg_q[i].narrow(1, qp[0], qp[1]),
                        seg_kv=None if seg_kv is None else cur[i][2].narrow(1, kp[0], kp[1]))
                    o_v, lse_v = _merge(_part(os[i], qp), lses[i].narrow(2, qp[0], qp[1]),
                                        o_p, lse_p)
                    _part(os[i], qp).copy_(o_v)
                    lses[i].narrow(2, qp[0], qp[1]).copy_(lse_v)
            if step < layout.world - 1:
                xport.wait(moving)
                cur = nxt
        outs = [o.to(q.dtype) for o, q in zip(os, qs)]
        ctx.cfg = cfg
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        xport, layout, causal, scale, window, seg_q, seg_kv = ctx.cfg
        saved = ctx.saved_tensors
        n = len(gs)
        qs, ks, vs, outs, lses = (saved[j * n:(j + 1) * n] for j in range(5))
        nq, nk = qs[0].shape[2], ks[0].shape[2]
        dos = [g.to(q.dtype).contiguous() for g, q in zip(gs, qs)]
        deltas = [(do.float() * o.float()).sum(-1) for do, o in zip(dos, outs)]
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
        acc = [[tuple(torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                      for _ in "kv") for _ in range(2)] for k in ks]
        cur = [(k, v) + (() if seg_kv is None else (seg_kv[i],)) for i, (k, v) in
               enumerate(zip(ks, vs))]
        slots = [[tuple(torch.empty_like(t) for t in c) for _ in range(2)] for c in cur]
        P = layout.world
        for step in range(P):
            if step < P - 1:
                nxt = [sl[(step + 1) % 2] for sl in slots]
                moving = xport.rotate(cur, nxt)
            held = [a[step % 2] for a in acc]
            for i, r in enumerate(xport.ranks):
                for qp, kp in _pairs(layout, r, step, nq, nk, causal, window):
                    dq_p, dk_p, dv_p = _chunk_grads(
                        _part(qs[i], qp), _part(cur[i][0], kp), _part(cur[i][1], kp),
                        _part(dos[i], qp), lses[i].narrow(2, qp[0], qp[1]),
                        deltas[i].narrow(2, qp[0], qp[1]), qp[2], kp[2], causal=causal,
                        scale=scale, window=window,
                        seg_q=None if seg_q is None else seg_q[i].narrow(1, qp[0], qp[1]),
                        seg_kv=None if seg_kv is None else cur[i][2].narrow(1, kp[0], kp[1]))
                    _part(dqs[i], qp).add_(dq_p)
                    _part(held[i][0], kp).add_(dk_p)
                    _part(held[i][1], kp).add_(dv_p)
            if P > 1:  # after the step that wrote them; at step P - 1, the hop home
                xport.wait(xport.rotate(held, [a[(step + 1) % 2] for a in acc],
                                        tag=len(cur[0])))
            if step < P - 1:
                xport.wait(moving)
                cur = nxt
        home = [a[P % 2 if P > 1 else 0] for a in acc]
        return (None, *(dq.to(q.dtype) for dq, q in zip(dqs, qs)),
                *(h[0].to(k.dtype) for h, k in zip(home, ks)),
                *(h[1].to(v.dtype) for h, v in zip(home, vs)))


def _split_ids(segment_ids):
    """``(q_ids, kv_ids)`` of a ring's segment ids: one array (q and kv
    chunks cover the same tokens) or a ``(q_ids, kv_ids)`` pair."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)) and len(segment_ids) == 2 and not isinstance(
            segment_ids[0], (tuple, list)):
        return segment_ids
    return segment_ids, segment_ids


def run_ring(mesh, axis: str, layout_cls, qs, ks, vs, *, causal, scale, window, seg_q=None,
             seg_kv=None):
    """Run :class:`_RingCore` over every ``axis`` group of ``mesh``'s local
    ranks: ``qs`` / ``ks`` / ``vs`` (and the ids, if any) are lists with one
    chunk per local rank. Dtype dispatch as the JAX function (fp16 runs as
    bf16); K/V contiguous, as the transports send them. Returns the outputs
    in the inputs' dtype."""
    in_dtype = qs[0].dtype
    kdt = _dispatch_dtype(in_dtype)
    qs = [q.to(kdt) for q in qs]
    ks, vs = ([x.to(kdt).contiguous() for x in xs] for xs in (ks, vs))
    outs = [None] * len(qs)
    for xport, members in mesh.rings(axis):
        cfg = (xport, layout_cls(mesh.shape[axis]), bool(causal), float(scale), window,
               None if seg_q is None else [seg_q[i].to(torch.int32).contiguous()
                                           for i in members],
               None if seg_kv is None else [seg_kv[i].to(torch.int32).contiguous()
                                            for i in members])
        got = _RingCore.apply(cfg, *(qs[i] for i in members), *(ks[i] for i in members),
                              *(vs[i] for i in members))
        for i, o in zip(members, got):
            outs[i] = o.to(in_dtype)
    return outs


def ring_attention(qs, ks, vs, *, mesh, axis: str = "seq", causal: bool = False,
                   scale: float | None = None, window=None, segment_ids=None):
    """Sequence-parallel fused attention over ``axis`` of ``mesh`` (the JAX
    function inside ``shard_map``, with the mesh in place of ``axis_name`` /
    ``axis_size``).

    ``qs`` / ``ks`` / ``vs``: one local chunk per local rank of ``mesh``
    (``mesh.ranks``), ``[B, H(kv), N / P, D]``, sequence sharded on
    ``axis`` in rank order. Differentiable (the ring backward); GQA K/V
    rotate at Hkv heads. ``causal`` and ``window = (left, right)`` mask in
    global positions. ``segment_ids``: per local rank one ``[B, N / P]`` id
    chunk (q and kv chunks cover the same tokens) or a ``(q_ids, kv_ids)``
    pair; the kv ids rotate with K/V, and a chunk pair that leaves a row no
    key merges as a no-op. Returns the local output chunks, in q's dtype."""
    if scale is None:
        scale = float(qs[0].shape[-1]) ** -0.5
    pairs = [_split_ids(s) for s in segment_ids] if segment_ids is not None else None
    return run_ring(mesh, axis, _Layout, qs, ks, vs, causal=causal, scale=scale,
                    window=check_window(window),
                    seg_q=None if pairs is None else [p[0] for p in pairs],
                    seg_kv=None if pairs is None else [p[1] for p in pairs])


def ring_attention_sharded(mesh, *, axis: str = "seq", batch_axis: str | None = "data",
                           head_axis: str | None = "model", causal: bool = False,
                           scale: float | None = None, window=None,
                           with_segment_ids: bool = False):
    """A callable on global ``[B, H, N, D]`` tensors: shards the sequence on
    ``axis`` (batch and heads on ``batch_axis`` / ``head_axis``), runs
    :func:`ring_attention` on each shard and gathers the output -- 2-D / 3-D
    parallel attention (heads x sequence x data) in one call.
    Differentiable. With ``with_segment_ids=True`` it takes ``(q, k, v,
    segment_ids)``, the ids the global ``[B, N]`` array."""
    spec = (batch_axis, head_axis, axis, None)
    seg_spec = (batch_axis, axis)

    def call(q, k, v, segment_ids=None):
        if with_segment_ids != (segment_ids is not None):
            raise TypeError("segment_ids is required exactly when with_segment_ids=True")
        ids = None if segment_ids is None else mesh.shard(segment_ids, seg_spec)
        outs = ring_attention(mesh.shard(q, spec), mesh.shard(k, spec), mesh.shard(v, spec),
                              mesh=mesh, axis=axis, causal=causal, scale=scale, window=window,
                              segment_ids=ids)
        return mesh.unshard(outs, spec)

    return call
