"""Packed-sequence (segment_ids) attention in the port against the JAX package on CPU.

Ports tests/test_segments.py. On a CPU tensor the port's K1, K5 and K6
wrappers run their plain PyTorch versions; the JAX package runs its Pallas
kernels in interpret mode, as its own tests do (its segment backward is the
two-kernel pair K5/K6). Inputs and segment ids come from numpy seeds and go
to both. Budgets are the package's: f32 outputs within FWD_TOL[f32] (1e-4),
f32 gradients within BWD_TOL[f32] (1e-3 abs + 5e-4 rel); bf16 outputs are
held against the f32 oracle at FWD_TOL[bf16] (2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.ops import oracle as jax_oracle
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, oracle
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv


def packed_ids(seed, B, N, max_segs=4):
    """Contiguous segment ids per batch row, e.g. [0,0,0,1,1,2,2,2,...]: a
    boundary after each token with probability max_segs / N."""
    bounds = np.random.default_rng(seed).random((B, N)) < max_segs / N
    return np.cumsum(bounds, axis=1).astype(np.int32)


def _jax(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


def _grads(fn, q, k, v, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v), do)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 256, 64), (2, 3, 300, 64)])  # aligned, unaligned N
def test_segments_fwd_matches_jax(shape, causal):
    B, H, N, D = shape
    q, k, v = make_qkv(N + H, B, H, N, D)
    seg = packed_ids(N + 1, B, N)
    want = flashattn_tpu.flash_attention(*_jax(q, k, v, seg)[:3], causal=causal,
                                         segment_ids=jnp.asarray(seg))
    got = flashattn_tpu_torch.flash_attention(q, k, v, causal=causal,
                                              segment_ids=torch.from_numpy(seg))
    assert got.shape == q.shape and got.dtype == torch.float32
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("causal", [False, True])
def test_segments_with_lse_matches_jax(causal):
    q, k, v = make_qkv(14, 1, 2, 128, 64)
    seg = packed_ids(15, 1, 128)
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *_jax(q, k, v), causal=causal, segment_ids=jnp.asarray(seg))
    o, lse = flashattn_tpu_torch.flash_attention_with_lse(
        q, k, v, causal=causal, segment_ids=torch.from_numpy(seg))
    assert lse.shape == (1, 2, 128) and lse.dtype == torch.float32
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


def test_segments_gqa_bf16():
    B, Hq, Hkv, N, D = 1, 4, 2, 256, 64
    q = make_qkv(5, B, Hq, N, D, dtype=torch.bfloat16)[0]
    _, k, v = make_qkv(6, B, Hkv, N, D, dtype=torch.bfloat16)
    seg = packed_ids(7, B, N)
    want = jax_oracle.attention_reference(*_jax(q.float(), k.float(), v.float()), causal=True,
                                          segment_ids=_jax(seg, seg))
    got = flashattn_tpu_torch.flash_attention(q, k, v, causal=True,
                                              segment_ids=torch.from_numpy(seg))
    got_jax = flashattn_tpu.flash_attention(
        *(x.astype(jnp.bfloat16) for x in _jax(q.float(), k.float(), v.float())),
        causal=True, segment_ids=jnp.asarray(seg))
    assert got.dtype == torch.bfloat16
    assert_close(got, np.asarray(want), FWD_TOL[torch.bfloat16], "port")
    assert_close(np.asarray(got_jax.astype(jnp.float32)), np.asarray(want),
                 FWD_TOL[torch.bfloat16], "jax")


def test_segments_cross_attention_tuple():
    """(q_ids, kv_ids) with Nq != Nk; some query rows match no key."""
    B, H, Nq, D, Nk = 2, 2, 130, 64, 200
    q, k, v = make_qkv(2, B, H, Nq, D, Nk=Nk)
    seg_q, seg_kv = packed_ids(3, B, Nq), packed_ids(4, B, Nk)
    want = flashattn_tpu.flash_attention(*_jax(q, k, v), segment_ids=_jax(seg_q, seg_kv))
    got = flashattn_tpu_torch.flash_attention(
        q, k, v, segment_ids=(torch.from_numpy(seg_q), torch.from_numpy(seg_kv)))
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("causal", [False, True])
def test_segments_grads_match_jax(causal):
    B, H, Hkv, N, D = 1, 4, 2, 192, 64
    q, k, v = make_qkv(8, B, H, N, D, Hkv=Hkv)
    do = make_qkv(9, B, H, N, D)[0]
    seg = packed_ids(10, B, N)
    jq, jk, jv, jdo, jseg = _jax(q, k, v, do, seg)
    want = jax.grad(lambda a, b, c: jnp.sum(flashattn_tpu.flash_attention(
        a, b, c, causal=causal, segment_ids=jseg) * jdo), (0, 1, 2))(jq, jk, jv)
    got = _grads(lambda a, b, c: flashattn_tpu_torch.flash_attention(
        a, b, c, causal=causal, segment_ids=torch.from_numpy(seg)), q, k, v, do)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.shape == x.shape
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


def test_packing_equivalence():
    """Golden test: two sequences packed into one call == separate calls, in
    the output and in every gradient."""
    B, H, D, n1, n2 = 1, 2, 64, 100, 156
    q, k, v = make_qkv(10, B, H, n1 + n2, D)
    do = make_qkv(11, B, H, n1 + n2, D)[0]
    seg = torch.cat([torch.zeros(B, n1, dtype=torch.int32), torch.ones(B, n2, dtype=torch.int32)],
                    dim=1)

    def packed(a, b, c):
        return flashattn_tpu_torch.flash_attention(a, b, c, causal=True, segment_ids=seg)

    def separate(a, b, c):
        return torch.cat([flashattn_tpu_torch.flash_attention(
            a[:, :, s], b[:, :, s], c[:, :, s], causal=True, scale=D ** -0.5)
            for s in (slice(0, n1), slice(n1, None))], dim=2)

    with torch.no_grad():
        assert_close(packed(q, k, v), separate(q, k, v), FWD_TOL[torch.float32])
    for name, g, w in zip(("dq", "dk", "dv"), _grads(packed, q, k, v, do),
                          _grads(separate, q, k, v, do)):
        assert_close(g, w, BWD_TOL[torch.float32], name)


def test_dead_rows_zero_output_and_grads():
    """q rows whose segment matches no kv token: zeros out, zero dQ, and
    nothing in dK/dV (against the JAX oracle's gradients); their LSE is the
    dead-row value ln2 * mask, as the JAX kernel stores it."""
    B, H, N, D = 1, 2, 128, 64
    q, k, v = make_qkv(11, B, H, N, D)
    seg_q = np.concatenate([np.zeros((B, 64), np.int32), np.full((B, N - 64), 7, np.int32)], 1)
    seg_kv = np.zeros((B, N), np.int32)
    ids = (torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    o = flashattn_tpu_torch.flash_attention(qg, kg, vg, segment_ids=ids)
    o.sum().backward()
    assert not o[:, :, 64:].any()
    assert not qg.grad[:, :, 64:].any()
    want = jax.grad(lambda a, b, c: jnp.sum(jax_oracle.attention_reference(
        a, b, c, segment_ids=_jax(seg_q, seg_kv))), argnums=(1, 2))(*_jax(q, k, v))
    assert_close(kg.grad, np.asarray(want[0]), BWD_TOL[torch.float32], "dk")
    assert_close(vg.grad, np.asarray(want[1]), BWD_TOL[torch.float32], "dv")
    _, lse = flashattn_tpu_torch.flash_attention_with_lse(q, k, v, segment_ids=ids)
    _, lse_jax = flashattn_tpu.flash_attention_with_lse(*_jax(q, k, v),
                                                        segment_ids=_jax(seg_q, seg_kv))
    assert torch.equal(lse[:, :, 64:], torch.from_numpy(np.array(lse_jax))[:, :, 64:])
    assert torch.all(lse[:, :, 64:] == np.log(2.0) * oracle.DEFAULT_MASK_VALUE)


def test_segments_layout_bnhd_and_int64_ids():
    """BNHD layout, int64 ids and a list of (q_ids, kv_ids) give the BHND answer."""
    q, k, v = make_qkv(16, 2, 2, 96, 32)
    seg = packed_ids(17, 2, 96)
    want = flashattn_tpu_torch.flash_attention(q, k, v, causal=True,
                                               segment_ids=torch.from_numpy(seg))
    ids = torch.from_numpy(seg).long()
    got = flashattn_tpu_torch.flash_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), causal=True, layout="BNHD",
        segment_ids=[ids, ids])
    assert torch.equal(got.transpose(1, 2), want)


def test_segment_validation_matches_jax():
    q, k, v = make_qkv(18, 1, 2, 128, 64)
    seg = packed_ids(19, 1, 128)
    for fn, xs, ids in ((flashattn_tpu_torch.flash_attention, (q, k, v), torch.from_numpy(seg)),
                        (flashattn_tpu.flash_attention, _jax(q, k, v), jnp.asarray(seg))):
        with pytest.raises(ValueError, match="integers"):
            fn(*xs, segment_ids=ids.astype(jnp.float32) if isinstance(ids, jax.Array)
               else ids.float())
        with pytest.raises(ValueError, match="shapes"):
            fn(*xs, segment_ids=ids[:, :64])
        with pytest.raises(ValueError, match="Nq == Nk"):
            fn(xs[0][:, :, :100], *xs[1:], segment_ids=ids)


def test_fwd_reference_segments_and_kv_tail():
    """K1's plain version with segments composes them with the KV tail and
    causal mask as the oracle does, and stores dead rows' O = 0 and LSE =
    ln2 * mask value."""
    q, k, v = make_qkv(20, 2, 2, 80, 32, Nk=120)
    seg_q, seg_kv = torch.from_numpy(packed_ids(21, 2, 80)), torch.from_numpy(packed_ids(22, 2, 120))
    o, lse = flash_fwd.fwd(q, k, v, scale=0.3, kv_valid_len=100, causal=True,
                           segment_ids=(seg_q, seg_kv))
    want = oracle.attention_reference(q, k[:, :, :100], v[:, :, :100], scale=0.3, causal=True,
                                      segment_ids=(seg_q, seg_kv[:, :100]))
    assert_close(o, want, FWD_TOL[torch.float32])
    keep = flash_fwd.pair_mask(80, 120, kv_valid_len=100, causal=True,
                               segment_ids=(seg_q, seg_kv), device="cpu")
    dead = ~keep.any(-1).expand_as(lse)
    assert dead.any() and (~dead).any()
    assert torch.all(lse[dead] == np.log(2.0) * oracle.DEFAULT_MASK_VALUE)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    want_lse = torch.logsumexp(s.masked_fill(~keep, -torch.inf), -1)
    assert_close(lse[~dead], want_lse[~dead], FWD_TOL[torch.float32], "lse")


def test_segments_on_cpu_launch_no_kernel():
    before = (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches, flash_bwd.split_bwd.launches,
              flash_bwd.bias_bwd.launches)
    q, k, v = make_qkv(23, 1, 2, 130, 32, dtype=torch.bfloat16)
    q.requires_grad_(True)
    seg = torch.from_numpy(packed_ids(24, 1, 130))
    flashattn_tpu_torch.flash_attention(q, k, v, causal=True, segment_ids=seg).float().sum().backward()
    assert q.grad is not None
    assert (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches, flash_bwd.split_bwd.launches,
            flash_bwd.bias_bwd.launches) == before
