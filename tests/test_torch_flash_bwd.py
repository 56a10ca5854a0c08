"""The port's causal forward and its backward (K3's wrapper and plain version,
the autograd wiring of flash_attention) against the JAX package on CPU.

On a CPU tensor the port's wrappers run their plain PyTorch versions; the JAX
package runs its Pallas kernels in interpret mode, as its own tests do:
non-causal gradients go through its fused backward (K3), causal ones at
N <= 384 through its resident causal kernels (K2 forward, K4 backward).
Budgets are the package's: f32 gradients agree within BWD_TOL[f32] (1e-3 abs
+ 5e-4 rel, the f32 kernel budget), the causal forward within FWD_TOL[f32];
bf16/fp16 gradients are held against the f32 oracle at BWD_TOL[bf16] (8e-2:
inputs, P and the outputs are rounded to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.utils import testing as jax_testing
from flashattn_tpu.utils import timing as jax_timing
from flashattn_tpu_torch.ops import flash_bwd_fused, flash_fwd, oracle
from flashattn_tpu_torch.utils import testing, timing
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv


def _layout(x, layout):
    return x if layout == "BHND" else x.transpose(1, 2).contiguous()


def _grads(fn, q, k, v, do):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v)
    return torch.autograd.grad(o, (q, k, v), do)


# (D, Nq, Nk, Hkv, causal, layout) with Hq = 4; D=111 is the reference's
# unaligned head dim, N=200 a ragged length.
GRAD_CASES = [
    (40, 200, 200, 2, False, "BHND"),
    (64, 256, 256, 2, False, "BNHD"),
    (111, 200, 300, 4, False, "BHND"),
    (40, 200, 200, 2, True, "BNHD"),
    (64, 256, 256, 4, True, "BHND"),
    (111, 384, 384, 2, True, "BNHD"),
]


@pytest.mark.parametrize("D,Nq,Nk,Hkv,causal,layout", GRAD_CASES)
def test_flash_attention_grads_f32_match_jax(D, Nq, Nk, Hkv, causal, layout):
    q, k, v = (_layout(x, layout) for x in make_qkv(D + Nq + Hkv, 1, 4, Nq, D, Nk=Nk, Hkv=Hkv))
    do = _layout(make_qkv(D + 7, 1, 4, Nq, D)[0], layout)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    want = jax.grad(lambda a, b, c: jnp.sum(flashattn_tpu.flash_attention(
        a, b, c, causal=causal, layout=layout) * jdo), (0, 1, 2))(jq, jk, jv)
    got = _grads(lambda a, b, c: flashattn_tpu_torch.flash_attention(
        a, b, c, causal=causal, layout=layout), q, k, v, do)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == x.shape
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


@pytest.mark.parametrize("D,N,Hkv,layout", [(64, 256, 2, "BHND"), (111, 200, 2, "BNHD"),
                                            (40, 384, 4, "BHND")])
def test_causal_forward_matches_jax(D, N, Hkv, layout):
    q, k, v = (_layout(x, layout) for x in make_qkv(D + N, 1, 4, N, D, Hkv=Hkv))
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True, layout=layout)
    o, lse = flashattn_tpu_torch.flash_attention_with_lse(q, k, v, causal=True, layout=layout)
    assert o.shape == q.shape and lse.shape == (1, 4, N)
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


def test_causal_is_top_left_when_nq_differs_from_nk():
    """kv_pos <= q_pos with zero offsets (ops/oracle.py): with Nq < Nk the
    keys past the last query take no part and get zero dK/dV."""
    q, k, v = make_qkv(11, 1, 2, 96, 32, Nk=160)
    o, lse = flash_fwd.fwd(q, k, v, scale=0.2, causal=True)
    o_want, lse_want = oracle.attention_reference_with_lse(q, k[:, :, :96], v[:, :, :96],
                                                           scale=0.2, causal=True)
    assert_close(o, o_want, FWD_TOL[torch.float32], "o")
    assert_close(lse, lse_want, FWD_TOL[torch.float32], "lse")
    do = make_qkv(12, 1, 2, 96, 32)[0]
    dq, dk, dv = flash_bwd_fused.bwd(q, k, v, do, lse, (do * o).sum(-1), scale=0.2, causal=True)
    assert not dk[:, :, 96:].any() and not dv[:, :, 96:].any()
    assert dk[:, :, :96].abs().amin(-1).gt(0).all()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kv_valid_len", [150, 113])
def test_bwd_reference_matches_oracle_autograd(causal, kv_valid_len):
    """``bwd_reference`` equals torch.autograd through the f32 oracle over the
    first ``kv_valid_len`` keys, with dK/dV exactly 0 past them; dK/dV come
    per query head (GQA 4/2) and sum to the oracle's per KV head."""
    B, Hq, Hkv, Nq, Nk, D, scale = 2, 4, 2, 130, 150, 40, 0.3
    q, k, v = make_qkv(21, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(22, B, Hq, Nq, D)[0]
    n = kv_valid_len
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=scale, kv_valid_len=n, causal=causal)
    dq, dk, dv = flash_bwd_fused.bwd_reference(
        q, k, v, do, lse, (do * o).sum(-1), scale=scale, causal=causal, kv_valid_len=n)
    assert dq.shape == q.shape and dk.shape == dv.shape == (B, Hq, Nk, D)
    assert not dk[:, :, n:].any() and not dv[:, :, n:].any()
    want = _grads(lambda a, b, c: oracle.attention_reference(a, b, c, scale=scale, causal=causal),
                  q, k[:, :, :n], v[:, :, :n], do)
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk[:, :, :n].reshape(B, Hkv, 2, n, D).sum(2), want[1], tol, "dk")
    assert_close(dv[:, :, :n].reshape(B, Hkv, 2, n, D).sum(2), want[2], tol, "dv")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_grads_vs_f32_oracle(dtype, causal):
    q, k, v = make_qkv(31, 1, 4, 200, 64, Nk=200, Hkv=2, dtype=dtype)
    do = make_qkv(32, 1, 4, 200, 64, dtype=dtype)[0]
    got = _grads(lambda a, b, c: flashattn_tpu_torch.flash_attention(a, b, c, causal=causal),
                 q, k, v, do)
    want = _grads(lambda a, b, c: oracle.attention_reference(a, b, c, causal=causal),
                  *(x.float() for x in (q, k, v, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype
        assert_close(g, w, BWD_TOL[dtype], name)


def test_gqa_grads_sum_over_the_query_heads_of_each_kv_head():
    q, k, v = make_qkv(41, 1, 6, 64, 16, Hkv=2)
    do = make_qkv(42, 1, 6, 64, 16)[0]
    got = _grads(lambda a, b, c: flashattn_tpu_torch.flash_attention(a, b, c), q, k, v, do)
    rep = _grads(lambda a, b, c: flashattn_tpu_torch.flash_attention(
        a, b.repeat_interleave(3, 1), c.repeat_interleave(3, 1)), q, k, v, do)
    for g, w in zip(got, rep):
        assert_close(g, w, testing.Tolerance(1e-6, 1e-6))


def test_with_lse_is_forward_only():
    q, k, v = make_qkv(51, 1, 2, 64, 32)
    q.requires_grad_(True)
    o, _ = flashattn_tpu_torch.flash_attention_with_lse(q, k, v)
    with pytest.raises(NotImplementedError, match="forward-only"):
        o.sum().backward()


def test_bwd_takes_no_plain_path_off_the_cpu():
    """Only a CPU tensor runs the plain version: a tensor on another device
    (here the meta device) gets no silent fallback."""
    q = torch.empty(1, 2, 64, 40, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        flash_bwd_fused.bwd(q, q, q, q, lse, lse, scale=0.1)


def test_bwd_launch_counter_does_not_move_on_cpu():
    before = (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches)
    q, k, v = make_qkv(61, 1, 2, 300, 40, dtype=torch.bfloat16)
    q.requires_grad_(True)
    flashattn_tpu_torch.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert q.grad is not None
    assert (flash_fwd.fwd.launches, flash_bwd_fused.bwd.launches) == before


def test_bwd_validation_errors():
    q, k, v = make_qkv(71, 1, 4, 32, 16, Hkv=2)
    lse = torch.zeros(1, 4, 32)
    with pytest.raises(ValueError, match="kv_valid_len"):
        flash_bwd_fused.bwd(q, k, v, q, lse, lse, scale=0.1, kv_valid_len=33)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_fused.bwd(q, k, v, q, lse[:, :, :8], lse, scale=0.1)
    with pytest.raises(ValueError, match="do like q"):
        flash_bwd_fused.bwd(q, k, v, q[:, :, :8], lse, lse, scale=0.1)
    with pytest.raises(ValueError, match="dtypes"):
        flash_bwd_fused.bwd(q, k, v, q.double(), lse, lse, scale=0.1)


def test_bwd_tol_and_grad_gate_match_jax():
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        assert tuple(BWD_TOL[dt]) == tuple(jax_testing.BWD_TOL[jnp.dtype(jdt)])
    rng = np.random.default_rng(81)
    want = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(3)]
    got = [w + rng.standard_normal((3, 5)).astype(np.float32) * 2e-3 for w in want]
    for tol in (BWD_TOL[torch.float32], BWD_TOL[torch.bfloat16]):
        port = testing.grad_gate([torch.from_numpy(g) for g in got], want, tol)
        ref = jax_testing.grad_gate(got, want, jax_testing.Tolerance(*tol))
        assert port[0] == ref[0] and port[2:] == pytest.approx(ref[2:])
        assert port[1] == ref[1]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["fwd", "bwd", "fwd_bwd"])
def test_attention_flops_matches_jax(mode, causal):
    for args in ((1, 16, 2048, 2048, 128), (2, 8, 1537, 77, 40)):
        for window in (None, (255, -1), (64, 64)):
            assert timing.attention_flops(*args, causal=causal, mode=mode, window=window) == \
                jax_timing.attention_flops(*args, causal=causal, mode=mode, window=window)
