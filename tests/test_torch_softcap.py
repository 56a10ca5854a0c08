"""Logit soft-capping (Gemma-2-style) in the port against the JAX package on CPU.

Ports tests/test_softcap.py:26-78: ``s -> cap·tanh(s/cap)`` on the scaled
logits before the bias and the masks, differentiable through the ``1 − tanh²``
Jacobian. On a CPU tensor the port's K1, K5 and K6 wrappers run their plain
PyTorch versions; the JAX package runs its Pallas kernels in interpret mode,
as its own tests do, once per module (the ``jax_softcap`` fixture). Inputs
come from numpy seeds and go to both, Q and K scaled by 3 so that the cap
bends the scores. Budgets: the JAX test's, FWD_TOL[f32] for outputs and
BWD_TOL[f32] for gradients; a bf16 output against the f32 oracle at
FWD_TOL[bf16].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd, oracle
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

CAP = 30.0
SHAPES = [(1, 2, 256, 64, 256), (2, 3, 150, 64, 170)]  # aligned; unaligned cross-length
CAUSAL = [False, True]


def _jax(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


def _fwd_qkv(shape):
    B, H, Nq, D, Nk = shape
    q, k, v = make_qkv(Nq + H, B, H, Nq, D, Nk=Nk)
    return 3 * q, 3 * k, v


def _grad_qkv():
    q, k, v = make_qkv(2, 1, 2, 192, 64)
    return 3 * q, 3 * k, v


def _seg_qkv():
    q, k, v = make_qkv(3, 1, 2, 256, 64)
    bounds = np.random.default_rng(5).random((1, 256)) < 4 / 256
    return 3 * q, 3 * k, v, np.cumsum(bounds, axis=1).astype(np.int32)


def _cos_loss(o):
    return (o * torch.cos(o)).sum() if isinstance(o, torch.Tensor) else jnp.sum(o * jnp.cos(o))


SEG_KW = dict(causal=True, window=(96, -1), logit_softcap=CAP)


@pytest.fixture(scope="module")
def jax_softcap():
    """The JAX flash_attention with CAP for every (shape, causal), its
    gradients of sum(o·cos o) per causal, and the gradients of sum(o²) with
    segment ids and a window: computed once."""
    fwd = {(i, c): np.asarray(flashattn_tpu.flash_attention(
        *_jax(*_fwd_qkv(shape)), causal=c, logit_softcap=CAP))
        for i, shape in enumerate(SHAPES) for c in CAUSAL}
    grads = {c: [np.asarray(g) for g in jax.grad(lambda a, b, d: _cos_loss(
        flashattn_tpu.flash_attention(a, b, d, causal=c, logit_softcap=CAP)), (0, 1, 2))(
        *_jax(*_grad_qkv()))] for c in CAUSAL}
    q, k, v, seg = _seg_qkv()
    seg_grads = jax.grad(lambda a, b, d: jnp.sum(flashattn_tpu.flash_attention(
        a, b, d, segment_ids=jnp.asarray(seg), **SEG_KW) ** 2), (0, 1, 2))(*_jax(q, k, v))
    return fwd, grads, [np.asarray(g) for g in seg_grads]


def _grads(fn, q, k, v):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    return torch.autograd.grad(fn(q, k, v), (q, k, v))


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_softcap_fwd_matches_jax(jax_softcap, i, causal):
    q, k, v = _fwd_qkv(SHAPES[i])
    got = flashattn_tpu_torch.flash_attention(q, k, v, causal=causal, logit_softcap=CAP)
    assert_close(got, jax_softcap[0][(i, causal)], FWD_TOL[torch.float32])
    # and the cap must actually change the result
    plain = flashattn_tpu_torch.flash_attention(q, k, v, causal=causal)
    assert (got - plain).abs().max() > 1e-3


def test_softcap_bf16_vs_f32_oracle():
    """tests/test_softcap.py's bf16 case: bf16 inputs scaled in bf16 first,
    so both arms see the same numbers; the port within FWD_TOL[bf16] of the
    f32 oracle."""
    q, k, v = make_qkv(1, 1, 4, 1024, 64, dtype=torch.bfloat16)
    q, k = (3.0 * q).to(torch.bfloat16), (3.0 * k).to(torch.bfloat16)
    want = oracle.attention_reference(q.float(), k.float(), v.float(), causal=True,
                                      logit_softcap=CAP)
    got = flashattn_tpu_torch.flash_attention(q, k, v, causal=True, logit_softcap=CAP)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, FWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", CAUSAL)
def test_softcap_grads_match_jax(jax_softcap, causal):
    got = _grads(lambda a, b, c: _cos_loss(flashattn_tpu_torch.flash_attention(
        a, b, c, causal=causal, logit_softcap=CAP)), *_grad_qkv())
    for name, g, w in zip(("dq", "dk", "dv"), got, jax_softcap[1][causal]):
        assert_close(g, w, BWD_TOL[torch.float32], name)


def test_softcap_with_segments_and_window_routes_to_k5_k6(jax_softcap, monkeypatch):
    """Softcap composed with segment ids and a window (no bias): the
    gradients of the JAX package's, and the backward is K5 then K6, never
    K3."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, kw.get("softcap"), kw.get("window")))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_bwd_fused, "bwd", spy("K3", flash_bwd_fused.bwd))
    monkeypatch.setattr(flash_bwd, "dkv", spy("K5", flash_bwd.dkv))
    monkeypatch.setattr(flash_bwd, "dq", spy("K6", flash_bwd.dq))
    q, k, v, seg = _seg_qkv()
    got = _grads(lambda a, b, c: (flashattn_tpu_torch.flash_attention(
        a, b, c, segment_ids=torch.from_numpy(seg), **SEG_KW) ** 2).sum(), q, k, v)
    assert calls == [("K5", CAP, (96, -1)), ("K6", CAP, (96, -1))]
    for name, g, w in zip(("dq", "dk", "dv"), got, jax_softcap[2]):
        assert_close(g, w, BWD_TOL[torch.float32], name)


@pytest.mark.parametrize("window", [None, (40, -1)])
def test_softcap_plain_versions_match_oracle_autograd(window):
    """K1's and K5/K6's plain versions with the cap (and a window, GQA 4/2)
    against the f32 oracle and its autograd."""
    q, k, v = make_qkv(12, 1, 4, 120, 32, Nk=140, Hkv=2)
    q, k = 3 * q, 3 * k
    do = make_qkv(13, 1, 4, 120, 32)[0]
    kw = dict(scale=0.3, causal=True, window=window)
    o, lse = flash_fwd.fwd(q, k, v, softcap=CAP, **kw)
    assert_close(o, oracle.attention_reference(q, k, v, logit_softcap=CAP, **kw),
                 FWD_TOL[torch.float32])
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(oracle.attention_reference(qg, kg, vg, logit_softcap=CAP, **kw),
                               (qg, kg, vg), do)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    dk, dv = flash_bwd.dkv(*args, softcap=CAP, **kw)
    dq = flash_bwd.dq(*args, softcap=CAP, **kw)
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk.view(1, 2, 2, 140, 32).sum(2), want[1], tol, "dk")
    assert_close(dv.view(1, 2, 2, 140, 32).sum(2), want[2], tol, "dv")


def test_softcap_decode_fold_passes_the_cap(monkeypatch):
    """A tiny-Nq GQA call with the cap and the cache-slot bias folds, as in
    the JAX package (flash.py:1065-1075), and gives the unfolded answer."""
    shapes = []
    fwd = flash_fwd.fwd

    def spy(q, *a, **kw):
        shapes.append((tuple(q.shape), kw.get("softcap")))
        return fwd(q, *a, **kw)

    q, k, v = make_qkv(14, 2, 8, 1, 32, Nk=40, Hkv=2)
    q, k = 3 * q, 3 * k
    bias = torch.where(torch.arange(40) < 25, 0.0, -1e9)[None, None, None]
    monkeypatch.setattr(flash_fwd, "fwd", spy)
    got = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias, logit_softcap=CAP)
    assert shapes == [((2, 2, 4, 32), CAP)]
    want = oracle.attention_reference(q, k, v, bias=bias, logit_softcap=CAP)
    assert_close(got, want, FWD_TOL[torch.float32])


def test_softcap_bias_gradient_and_quantized_kv_raise():
    """The forward with a bias and the cap is ported, and so is its gradient
    (K5's bias read, K6's dbias taken before the cap's Jacobian): dQ and
    dbias match autograd through the oracle; the cap on quantized K/V raises
    the JAX package's ValueError; a cap that is not positive is refused."""
    q, k, v = make_qkv(15, 1, 2, 64, 32)
    bias = torch.from_numpy(np.random.default_rng(16).standard_normal((1, 2, 64, 64),
                                                                       dtype=np.float32))
    o = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias, logit_softcap=CAP)
    assert_close(o, oracle.attention_reference(q, k, v, bias=bias, logit_softcap=CAP),
                 FWD_TOL[torch.float32])
    grads = []
    for fn in (flashattn_tpu_torch.flash_attention, oracle.attention_reference):
        qq, bb = q.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        (fn(qq, k, v, bias=bb, logit_softcap=CAP) ** 2).sum().backward()
        grads.append((qq.grad, bb.grad))
    for name, got, want in zip(("dq", "dbias"), *grads):
        assert_close(got, want, BWD_TOL[torch.float32], name)
    ks = torch.ones(1, 2, 64)
    with pytest.raises(ValueError, match="quantized"):
        flash_fwd.fwd(q.detach(), k.to(torch.int8), v.to(torch.int8), scale=0.2, k_scale=ks,
                      v_scale=ks, softcap=CAP)
    with pytest.raises(ValueError, match="positive"):
        flashattn_tpu_torch.flash_attention(q.detach(), k, v, logit_softcap=0.0)


def _counts():
    return (flash_fwd.fwd.launches, flash_fwd.fwd.launches_softcap, flash_bwd.split_bwd.launches,
            flash_bwd.bias_bwd.launches)


def test_softcap_on_cpu_launches_no_kernel():
    before = _counts()
    q, k, v = make_qkv(17, 1, 2, 100, 32, dtype=torch.bfloat16)
    q.requires_grad_(True)
    flashattn_tpu_torch.flash_attention(q, k, v, causal=True, logit_softcap=CAP).float().sum() \
        .backward()
    assert q.grad is not None and _counts() == before
