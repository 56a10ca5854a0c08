"""Zigzag ring attention: causally load-balanced sequence parallelism (port
of flashattn_tpu/parallel/zigzag.py).

With contiguous sequence sharding, causal ring attention is imbalanced: rank
0's rows attend one chunk while rank P-1's attend all P. The zigzag layout
splits the sequence into 2P chunks and gives rank d the PAIR (d, 2P-1-d):
early rows and late rows together, so every rank owns the same causal area.

The ring still rotates each rank's (two-chunk) K/V block; each step computes
up to three sub-pair partials with K1's dense route at their global offsets:

  q_hi x k_lo : always live (late rows attend early columns);
  q_lo x k_lo : live iff src <= d (diagonal when src == d);
  q_hi x k_hi : live iff src >= d (diagonal when src == d);
  q_lo x k_hi : never live.

That is 2P + 1 sub-pairs per rank over the P steps, the same on every rank.
The rule is the ring's ``_chunk_needed`` on the sub-chunks' offsets, so the
ring engine of ``parallel/ring.py`` runs it with a layout of two parts per
rank (:class:`_ZigzagLayout`); the backward rotates (dK, dV) accumulators
with their chunks like the plain ring.

The layout contract: local chunks are ``[chunk_d ; chunk_{2P-1-d}]`` along
the sequence axis. :func:`zigzag_shard` / :func:`zigzag_unshard` convert a
global tensor to and from this order; :func:`zigzag_ring_attention_sharded`
applies them around the ring, so callers keep natural token order.
"""

from __future__ import annotations

import numpy as np
import torch

from flashattn_tpu_torch.parallel.ring import _Layout, run_ring


def zigzag_order(n_total: int, n_dev: int) -> np.ndarray:
    """Global row permutation: natural order -> zigzag-sharded order.

    Row i of the permuted array is row ``order[i]`` of the natural array;
    rank d's contiguous shard of the permuted array holds natural chunks
    (d, 2P-1-d).
    """
    c, rem = divmod(n_total, 2 * n_dev)
    if rem or c == 0:
        raise ValueError(
            f"zigzag needs the sequence ({n_total}) divisible into "
            f"2*devices={2 * n_dev} equal chunks")
    order = np.empty(n_total, np.int64)
    pos = 0
    for d in range(n_dev):
        order[pos:pos + c] = np.arange(d * c, (d + 1) * c)
        order[pos + c:pos + 2 * c] = np.arange((2 * n_dev - 1 - d) * c, (2 * n_dev - d) * c)
        pos += 2 * c
    return order


def zigzag_shard(x: torch.Tensor, n_dev: int, axis: int = 2) -> torch.Tensor:
    """Permute a (global) tensor's sequence axis into zigzag order."""
    order = torch.from_numpy(zigzag_order(x.shape[axis], n_dev)).to(x.device)
    return torch.index_select(x, axis, order)


def zigzag_unshard(x: torch.Tensor, n_dev: int, axis: int = 2) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    order = zigzag_order(x.shape[axis], n_dev)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return torch.index_select(x, axis, torch.from_numpy(inv).to(x.device))


def _offsets(idx: int, c: int, n_dev: int) -> tuple[int, int]:
    """Global row offsets of a rank's (lo, hi) chunks."""
    return idx * c, (2 * n_dev - 1 - idx) * c


class _ZigzagLayout(_Layout):
    """Rank d's rows and a chunk's keys as the two halves (d, 2P-1-d)."""

    def q_parts(self, r: int, n: int):
        c = n // 2
        lo, hi = _offsets(r, c, self.world)
        return [(0, c, lo), (c, c, hi)]

    kv_parts = q_parts


def zigzag_ring_attention(qs, ks, vs, *, mesh, axis: str = "seq",
                          scale: float | None = None):
    """Causal ring attention on ZIGZAG-layout local chunks (the JAX function
    inside ``shard_map``, with the mesh in place of ``axis_name`` /
    ``axis_size``): per local rank of ``mesh``, ``[B, H(kv), 2c, D]`` holding
    natural chunks ``(d, 2P-1-d)`` concatenated. Differentiable; GQA K/V
    rotate at Hkv heads. Causal only -- for non-causal or windowed attention
    the plain ring is already balanced."""
    if scale is None:
        scale = float(qs[0].shape[-1]) ** -0.5
    if qs[0].shape[2] % 2:
        raise ValueError("zigzag local chunks hold two sub-chunks; local "
                         f"sequence length must be even, got {qs[0].shape[2]}")
    return run_ring(mesh, axis, _ZigzagLayout, qs, ks, vs, causal=True, scale=scale,
                    window=None)


def zigzag_ring_attention_sharded(mesh, *, axis: str = "seq", batch_axis: str | None = "data",
                                  head_axis: str | None = "model", scale: float | None = None):
    """A callable on global ``[B, H, N, D]`` tensors in NATURAL token order:
    permutes them to the zigzag layout, shards them (sequence on ``axis``,
    batch and heads on ``batch_axis`` / ``head_axis``), runs the balanced
    causal ring and returns the output in natural order. Differentiable."""
    n = mesh.shape[axis]
    spec = (batch_axis, head_axis, axis, None)

    def call(q, k, v):
        local = [mesh.shard(zigzag_shard(x, n), spec) for x in (q, k, v)]
        outs = zigzag_ring_attention(*local, mesh=mesh, axis=axis, scale=scale)
        return zigzag_unshard(mesh.unshard(outs, spec), n)

    return call
