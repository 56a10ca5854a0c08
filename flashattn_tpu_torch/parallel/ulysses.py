"""Ulysses-style sequence parallelism: all-to-all (seq <-> heads) around the
single-device kernel (port of flashattn_tpu/parallel/ulysses.py).

Instead of rotating K/V, one all-to-all turns sequence-sharded Q/K/V into
head-sharded full-sequence tensors, the ordinary ``flash_attention`` runs
locally with no further communication, and a second all-to-all restores the
sequence sharding. The all-to-all is linear, and the mesh's is
differentiable, so the whole transform trains.
"""

from __future__ import annotations

from flashattn_tpu_torch.ops.flash import flash_attention


def ulysses_attention(qs, ks, vs, *, mesh, axis: str = "seq", causal: bool = False,
                      scale: float | None = None, bias=None, window=None, segment_ids=None):
    """Sequence-parallel attention by all-to-all over ``axis`` of ``mesh``
    (the JAX function inside ``shard_map``, with the mesh in place of
    ``axis_name`` / ``axis_size``).

    ``qs`` / ``ks`` / ``vs``: one local chunk per local rank, ``[B, H, N/n,
    D]``, sharded on ``axis``; H must be divisible by the axis size (K/V
    heads that are not are repeated to H first). ``segment_ids``: per local
    rank the ``[B, N/n]`` id chunk, all-gathered along the axis, since the
    kernel after the all-to-all sees the full sequence. A ``bias`` raises
    ValueError: a sequence-local bias slice has no meaning after the
    all-to-all. Returns the local output chunks."""
    n = mesh.shape[axis]
    B, H, _, D = qs[0].shape
    if H % n != 0:
        raise ValueError(f"Ulysses needs n_devices | heads: H={H}, n={n}")
    if bias is not None:
        raise ValueError(
            "ulysses_attention does not support bias: inputs are sequence-"
            "sharded but the post-all-to-all kernel sees the full sequence; "
            "use ring_attention (windowed/causal masks) or replicated "
            "full-sequence attention with bias instead.")
    Hkv = ks[0].shape[1]
    if Hkv != H and Hkv % n != 0:
        ks = [k.repeat_interleave(H // Hkv, dim=1) for k in ks]
        vs = [v.repeat_interleave(H // Hkv, dim=1) for v in vs]

    def seq_to_head(xs):  # [B, H, N/n, D] -> [B, H/n, N, D]
        return mesh.all_to_all(xs, axis, split_dim=1, concat_dim=2)

    seg_full = (None,) * len(qs) if segment_ids is None else mesh.all_gather(
        segment_ids, axis, dim=1)
    outs = [flash_attention(qg, kg, vg, causal=causal, scale=scale, window=window,
                            segment_ids=seg)
            for qg, kg, vg, seg in zip(seq_to_head(qs), seq_to_head(ks), seq_to_head(vs),
                                       seg_full)]
    return mesh.all_to_all(outs, axis, split_dim=2, concat_dim=1)


def ulysses_attention_sharded(mesh, *, axis: str = "seq", batch_axis: str | None = "data",
                              causal: bool = False, scale: float | None = None, window=None,
                              with_segment_ids: bool = False):
    """A callable on global ``[B, H, N, D]`` tensors for Ulysses SP: shards
    the sequence on ``axis`` (the batch on ``batch_axis``), runs
    :func:`ulysses_attention` and gathers the output. Differentiable. With
    ``with_segment_ids=True`` it takes ``(q, k, v, segment_ids)``, the ids
    the global ``[B, N]`` array."""
    spec = (batch_axis, None, axis, None)
    seg_spec = (batch_axis, axis)

    def call(q, k, v, segment_ids=None):
        if with_segment_ids != (segment_ids is not None):
            raise TypeError("segment_ids is required exactly when with_segment_ids=True")
        ids = None if segment_ids is None else mesh.shard(segment_ids, seg_spec)
        outs = ulysses_attention(mesh.shard(q, spec), mesh.shard(k, spec),
                                 mesh.shard(v, spec), mesh=mesh, axis=axis, causal=causal,
                                 scale=scale, window=window, segment_ids=ids)
        return mesh.unshard(outs, spec)

    return call
