"""Head-parallel (tensor-parallel) attention (port of
flashattn_tpu/parallel/head_parallel.py).

Heads are an embarrassingly parallel axis of the kernel grid; across ranks
the same structure becomes a sharded head dimension with no communication
inside attention. GQA co-locates each KV head with its query-head group; when
the KV heads do not divide the axis, K/V stay replicated and each rank picks
the KV head of each of its query heads.
"""

from __future__ import annotations

import torch

from flashattn_tpu_torch.ops.flash import flash_attention


def head_parallel_attention(mesh, *, axis: str = "model", batch_axis: str | None = "data",
                            causal: bool = False, scale: float | None = None,
                            layout: str = "BHND"):
    """A callable ``(q, k, v) -> o`` on global tensors (``[B, H, N, D]``, or
    ``[B, N, H, D]`` with ``layout="BNHD"``) with heads sharded on ``axis`` of
    ``mesh`` (and the batch on ``batch_axis``): each rank calls
    ``flash_attention`` on its heads, with no collective. K/V heads must
    divide by the axis size to be sharded with Q; otherwise K/V are
    replicated and each rank takes, for each of its query heads, the KV head
    of its GQA group. Differentiable."""
    h_dim = 1 if layout == "BHND" else 2
    n = mesh.shape[axis]

    def spec_for(sharded: bool):
        parts = [batch_axis, None, None, None]
        parts[h_dim] = axis if sharded else None
        return tuple(parts)

    qspec = spec_for(True)

    def call(q, k, v):
        hq, hkv = q.shape[h_dim], k.shape[h_dim]
        kv_sharded = hkv % n == 0
        kvspec = spec_for(kv_sharded)
        group = hq // hkv
        qs, ks, vs = mesh.shard(q, qspec), mesh.shard(k, kvspec), mesh.shard(v, kvspec)
        outs = []
        for i, (ql, kl, vl) in zip(mesh.axis_index(axis), zip(qs, ks, vs)):
            if not kv_sharded and group > 1:
                # K/V replicated, Q heads sharded: the local head index no
                # longer encodes the global GQA group.
                hq_loc = ql.shape[h_dim]
                kvidx = (torch.arange(hq_loc, device=ql.device) + i * hq_loc) // group
                kl, vl = kl.index_select(h_dim, kvidx), vl.index_select(h_dim, kvidx)
            outs.append(flash_attention(ql, kl, vl, causal=causal, scale=scale, layout=layout))
        return mesh.unshard(outs, qspec)

    return call
