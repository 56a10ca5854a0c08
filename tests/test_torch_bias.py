"""The port's additive bias and GQA decode fold (ops/flash.py, ops/flash_fwd.py)
against the JAX package on CPU.

The same numpy inputs go through the JAX ``flash_attention`` (Pallas in
interpret mode, as its own tests run it) and the port's, whose K1 wrapper
runs its plain version on a CPU tensor. Budget: FWD_TOL[f32] (1e-4 abs +
1e-4 rel, the f32 kernel budget against the exact oracle) for outputs and
gradients of the fold, which compute the same sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu_torch.ops import flash_fwd, oracle
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

B, HQ, HKV, NQ, NK, D = 2, 4, 2, 100, 77, 32
BIAS_SHAPES = {"slots": (1, 1, 1, NK), "rows": (B, 1, NQ, NK), "full": (B, HQ, NQ, NK)}


def _bias(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _jax(*xs):
    return tuple(jnp.asarray(x.numpy()) for x in xs)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", sorted(BIAS_SHAPES))
def test_bias_forward_matches_jax(kind, causal):
    """Bias shapes [1,1,1,Nk], [B,1,Nq,Nk], [B,H,Nq,Nk]; GQA 4/2; Nk 77."""
    q, k, v = make_qkv(20, B, HQ, NQ, D, Nk=NK, Hkv=HKV)
    bias = _bias(21, BIAS_SHAPES[kind])
    want = flashattn_tpu.flash_attention(*_jax(q, k, v), bias=jnp.asarray(bias), causal=causal)
    got = flashattn_tpu_torch.flash_attention(q, k, v, bias=torch.from_numpy(bias),
                                              causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("kind", ["slots", "full"])
def test_bias_with_lse_bnhd_matches_jax(kind):
    q, k, v = make_qkv(22, B, HQ, NQ, D, Nk=NK, Hkv=HKV)
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    bias = _bias(23, BIAS_SHAPES[kind])
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *_jax(q, k, v), bias=jnp.asarray(bias), layout="BNHD")
    o, lse = flashattn_tpu_torch.flash_attention_with_lse(
        q, k, v, bias=torch.from_numpy(bias), layout="BNHD")
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


# (Nq, bias kind): Hq 8 over Hkv 2, so rep·Nq = 4 or 32, both folded.
FOLD_CASES = [(1, None), (1, "slots"), (4, None), (8, "slots"), (8, "rows")]


@pytest.mark.parametrize("nq,kind", FOLD_CASES)
def test_gqa_fold_equals_unfolded_and_jax(nq, kind):
    q, k, v = make_qkv(24 + nq, 2, 8, nq, 64, Nk=150, Hkv=2)
    bias = None
    if kind is not None:
        bias = _bias(25, (2, 1, nq if kind == "rows" else 1, 150))
        bias[..., 140:] = -1e9  # the decode cache-slot mask's dead slots
    tb = None if bias is None else torch.from_numpy(bias)
    got = flashattn_tpu_torch.flash_attention(q, k, v, bias=tb)
    unfolded = flashattn_tpu_torch.flash_attention(
        q, k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1), bias=tb)
    want = flashattn_tpu.flash_attention(*_jax(q, k, v),
                                         bias=None if bias is None else jnp.asarray(bias))
    assert_close(got, unfolded, FWD_TOL[torch.float32], "vs unfolded")
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32], "vs jax")


def test_fold_condition_matches_jax(monkeypatch):
    """K1 sees [B, Hkv, rep·Nq, D] exactly under the JAX condition: rep > 1,
    non-causal, no segments, a bias without a head dim, Nq·rep <= 32; and
    flash_attention_with_lse never folds."""
    seen = []
    real = flash_fwd.fwd

    def spy(q, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", spy)
    q, k, v = make_qkv(26, 1, 8, 4, 16, Nk=40, Hkv=2)
    fa = flashattn_tpu_torch.flash_attention
    fa(q, k, v)                                             # folded
    fa(q, k, v, bias=torch.zeros(1, 1, 4, 40))              # folded, bias tiled
    fa(q, k, v, causal=True)                                # causal: no
    fa(q, k, v, bias=torch.zeros(1, 8, 1, 40))              # head-dependent bias: no
    fa(q, k, v, segment_ids=(torch.zeros(1, 4, dtype=torch.int32),
                             torch.zeros(1, 40, dtype=torch.int32)))  # segments: no
    q9, k9, v9 = make_qkv(27, 1, 8, 9, 16, Nk=40, Hkv=2)
    fa(q9, k9, v9)                                          # Nq·rep = 36 > 32: no
    flashattn_tpu_torch.flash_attention_with_lse(q, k, v)   # with_lse: no
    q1, k1, v1 = make_qkv(28, 1, 2, 1, 16, Nk=40)
    fa(q1, k1, v1)                                          # rep == 1: nothing to fold
    assert seen == [(1, 2, 16, 16), (1, 2, 16, 16), (1, 8, 4, 16), (1, 8, 4, 16),
                    (1, 8, 4, 16), (1, 8, 9, 16), (1, 8, 4, 16), (1, 2, 1, 16)]


def test_fold_gradient_equals_unfolded():
    """The fold is a reshape around the differentiable core: its gradients
    are the unfolded call's."""
    q, k, v = make_qkv(29, 1, 8, 2, 32, Nk=70, Hkv=2)
    do = make_qkv(30, 1, 8, 2, 32)[0]

    def grads(fn):
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        (fn(qq, kk, vv) * do).sum().backward()
        return qq.grad, kk.grad, vv.grad

    got = grads(flashattn_tpu_torch.flash_attention)
    want = grads(lambda qq, kk, vv: flashattn_tpu_torch.flash_attention(
        qq, kk.repeat_interleave(4, dim=1), vv.repeat_interleave(4, dim=1)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert_close(g, w, BWD_TOL[torch.float32], name)


@pytest.mark.parametrize("fold", [False, True])
def test_bias_backward_raises(fold):
    """The gradient through a bias raised until K5's bias read and K6's dbias
    were ported; now it runs, folded or not: a zero bias leaves dQ as without
    a bias, and dbias ``[1, 1, 1, Nk]`` is the f32 oracle's under autograd."""
    hkv = 2 if fold else 4
    q, k, v = make_qkv(31, 1, 4, 1 if fold else 32, 16, Nk=32, Hkv=hkv)
    grads = []
    for fn in (flashattn_tpu_torch.flash_attention, oracle.attention_reference):
        qq, bias = q.clone().requires_grad_(True), torch.zeros(1, 1, 1, 32, requires_grad=True)
        (fn(qq, k, v, bias=bias) ** 2).sum().backward()
        grads.append((qq.grad, bias.grad))
    (dq, dbias), (dq_want, dbias_want) = grads
    qq = q.clone().requires_grad_(True)
    (flashattn_tpu_torch.flash_attention(qq, k, v) ** 2).sum().backward()
    assert dbias.shape == (1, 1, 1, 32)
    assert_close(dq, qq.grad, BWD_TOL[torch.float32], "dq vs no bias")
    assert_close(dq, dq_want, BWD_TOL[torch.float32], "dq")
    assert_close(dbias, dbias_want, BWD_TOL[torch.float32], "dbias")


def test_kernel_bias_strides_never_expand():
    """The kernel reads a broadcast dim with stride 0: decode's [1, 1, 1, Nk]
    f32 bias reaches it as it is, a bf16 bias is cast to f32 once, and only a
    non-unit column stride is made contiguous."""
    slots = torch.zeros(1, 1, 1, 64)
    got, strides = flash_fwd.kernel_bias(slots)
    assert got.data_ptr() == slots.data_ptr() and strides == (0, 0, 0)
    rows = torch.zeros(2, 1, 5, 64, dtype=torch.bfloat16)
    got, strides = flash_fwd.kernel_bias(rows)
    assert got.dtype == torch.float32 and strides == (320, 0, 64)
    expanded = torch.zeros(1, 1, 1, 64).expand(3, 4, 5, 64)
    got, strides = flash_fwd.kernel_bias(expanded)
    assert got.data_ptr() == expanded.data_ptr() and strides == (0, 0, 0)
    cols = torch.zeros(1, 1, 64, 2)[..., 0][:, :, None]  # column stride 2
    got, strides = flash_fwd.kernel_bias(cols)
    assert got.stride(-1) == 1 and torch.equal(got, cols)
    assert flash_fwd.kernel_bias(None) == (None, (0, 0, 0))


def test_bf16_bias_equals_its_f32_copy():
    q, k, v = make_qkv(32, 1, 2, 40, 16, Nk=50)
    bias = torch.from_numpy(_bias(33, (1, 2, 40, 50))).to(torch.bfloat16)
    a = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias)
    b = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias.float())
    assert torch.equal(a, b)


def test_bias_validation_matches_jax():
    q, k, v = make_qkv(34, 2, 4, 16, 8, Nk=24)
    fa = flashattn_tpu_torch.flash_attention
    with pytest.raises(ValueError, match="rank-4"):
        fa(q, k, v, bias=torch.zeros(16, 24))
    with pytest.raises(ValueError, match="not broadcastable"):
        fa(q, k, v, bias=torch.zeros(3, 1, 16, 24))
    with pytest.raises(ValueError, match="seq dims"):
        fa(q, k, v, bias=torch.zeros(1, 1, 16, 23))
    with pytest.raises(ValueError, match="bias"):
        flash_fwd.fwd(q, k, v, scale=0.3, bias=torch.zeros(1, 2, 16, 24))


def test_bias_takes_no_plain_path_off_the_cpu():
    q = torch.empty(1, 2, 64, 40, device="meta", dtype=torch.bfloat16)
    bias = torch.empty(1, 1, 1, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        flash_fwd.fwd(q, q, q, scale=0.1, bias=bias)
