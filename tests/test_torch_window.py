"""Sliding-window attention in the port against the JAX package on CPU.

Ports tests/test_window.py:13-53. On a CPU tensor the port's K1, K3, K5 and
K6 wrappers run their plain PyTorch versions; the JAX package runs its Pallas
kernels in interpret mode, as its own tests do, once per module (the
``jax_window`` fixture). Inputs come from numpy seeds and go to both.
Budgets: the JAX test's own, outputs within 2e-5 and gradients within 5e-4 in
f32 (max abs); a GQA window within FWD_TOL[f32] / BWD_TOL[f32] of the JAX
oracle. The window is ``(left, right)``: pair (i, j) attends iff
``i - left <= j <= i + right``, -1 disabling a side.
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

CASES = [
    # (N, window, causal) -- tests/test_window.py's, landing inside/astride tiles
    (512, (127, 0), False),
    (512, (64, 64), False),
    (777, (200, -1), True),     # causal + left window (Mistral-style SWA)
    (300, (-1, 50), False),     # right-only window
    (1024, (33, 12), False),
]
GRAD_N, GRAD_WINDOW = 512, (100, 30)


def _jax(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


def _case_qkv(n):
    return make_qkv(n, 1, 2, n, 64)


def _grad_qkv():
    return make_qkv(1, 1, 2, GRAD_N, 64)


@pytest.fixture(scope="module")
def jax_window():
    """The JAX flash_attention of every CASE, and its gradients of
    sum(o²) with GRAD_WINDOW, computed once."""
    fwd = {case: np.array(flashattn_tpu.flash_attention(
        *_jax(*_case_qkv(case[0])), window=case[1], causal=case[2])) for case in CASES}
    grads = jax.grad(lambda a, b, c: (flashattn_tpu.flash_attention(
        a, b, c, window=GRAD_WINDOW) ** 2).sum(), (0, 1, 2))(*_jax(*_grad_qkv()))
    return fwd, [np.array(g) for g in grads]


def _grads(fn, q, k, v, do=None):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    return torch.autograd.grad(out, (q, k, v), torch.ones_like(out) if do is None else do)


@pytest.mark.parametrize("n,window,causal", CASES)
def test_window_fwd_matches_jax(jax_window, n, window, causal):
    q, k, v = _case_qkv(n)
    got = flashattn_tpu_torch.flash_attention(q, k, v, window=window, causal=causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert (got - torch.from_numpy(jax_window[0][(n, window, causal)])).abs().max() < 2e-5


def test_window_grads_match_jax(jax_window):
    q, k, v = _grad_qkv()
    got = _grads(lambda a, b, c: (flashattn_tpu_torch.flash_attention(
        a, b, c, window=GRAD_WINDOW) ** 2).sum(), q, k, v)
    for name, g, w in zip(("dq", "dk", "dv"), got, jax_window[1]):
        assert (g - torch.from_numpy(w)).abs().max() < 5e-4, name


def test_window_equals_causal_when_right_zero():
    """window=(-1, 0) equals causal=True exactly (same band, same mask), in
    the output and in every gradient."""
    q, k, v = make_qkv(2, 1, 2, 384, 64)
    a = flashattn_tpu_torch.flash_attention(q, k, v, window=(-1, 0))
    b = flashattn_tpu_torch.flash_attention(q, k, v, causal=True)
    assert torch.equal(a, b)
    ga = _grads(lambda x, y, z: flashattn_tpu_torch.flash_attention(x, y, z, window=(-1, 0)),
                q, k, v)
    gb = _grads(lambda x, y, z: flashattn_tpu_torch.flash_attention(x, y, z, causal=True),
                q, k, v)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))


@pytest.mark.parametrize("causal,window", [(True, (40, -1)), (False, (17, 9))])
def test_window_gqa_matches_jax_oracle(causal, window):
    """GQA 4/2 with a window: output and gradients against the JAX oracle."""
    q, k, v = make_qkv(3, 2, 4, 200, 32, Hkv=2)
    do = make_qkv(4, 2, 4, 200, 32)[0]
    got = flashattn_tpu_torch.flash_attention(q, k, v, causal=causal, window=window)
    jq, jk, jv, jdo = _jax(q, k, v, do)
    want = jax_oracle.attention_reference(jq, jk, jv, causal=causal, window=window)
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])
    gw = jax.grad(lambda a, b, c: jnp.sum(jax_oracle.attention_reference(
        a, b, c, causal=causal, window=window) * jdo), (0, 1, 2))(jq, jk, jv)
    gp = _grads(lambda a, b, c: flashattn_tpu_torch.flash_attention(
        a, b, c, causal=causal, window=window), q, k, v, do)
    for name, g, w, x in zip(("dq", "dk", "dv"), gp, gw, (q, k, v)):
        assert g.shape == x.shape
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


# (Nq, Nk, causal, window): a left bound with Nq > Nk (rows past Nk + 8 see
# no key: dead rows), right-only past Nk, a non-causal band, causal SWA; then
# the band edges the CUDA kernels' tile ranges must meet: a left bound that
# is not a multiple of the 64-row tile at an unaligned N, one that is, the
# diagonal alone, a right-only band with Nq < Nk, right bound 0 without
# causal at Nq > Nk, causal with Nq < Nk (the right bound then 0), and a
# band wider than the sequence.
KERNEL_CASES = [(130, 100, False, (8, -1)), (130, 100, False, (-1, 10)),
                (96, 120, False, (16, 16)), (200, 200, True, (63, -1)),
                (333, 333, True, (200, -1)), (150, 150, True, (64, -1)),
                (100, 100, False, (0, 0)), (64, 200, False, (0, 70)),
                (257, 190, False, (-1, 0)), (90, 300, True, (10, 5)),
                (70, 70, False, (500, 500))]


@pytest.mark.parametrize("nq,nk,causal,window", KERNEL_CASES)
def test_window_plain_versions_match_oracle_autograd(nq, nk, causal, window):
    """K1's, K3's and K5/K6's plain versions with a window against the f32
    oracle and its autograd; dead rows store O = 0, LSE = ln2 * mask and get
    dQ = 0."""
    q, k, v = make_qkv(5, 1, 4, nq, 32, Nk=nk, Hkv=2)
    do = make_qkv(6, 1, 4, nq, 32)[0]
    kw = dict(scale=0.3, causal=causal, window=window)
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    assert_close(o, oracle.attention_reference(q, k, v, **kw), FWD_TOL[torch.float32])
    want = _grads(lambda a, b, c: oracle.attention_reference(a, b, c, **kw), q, k, v, do)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    dq3, dk3, dv3 = flash_bwd_fused.bwd(*args, **kw)
    dk5, dv5 = flash_bwd.dkv(*args, **kw)
    dq6 = flash_bwd.dq(*args, **kw)
    assert torch.equal(dq3, dq6) and torch.equal(dk3, dk5) and torch.equal(dv3, dv5)
    tol = BWD_TOL[torch.float32]
    assert_close(dq3, want[0], tol, "dq")
    for name, g, w in (("dk", dk3, want[1]), ("dv", dv3, want[2])):
        assert_close(g.view(1, 2, 2, nk, 32).sum(2), w, tol, name)
    keep = flash_fwd.pair_mask(nq, nk, kv_valid_len=nk, causal=causal, segment_ids=None,
                               device="cpu", window=window)
    dead = ~keep.any(-1).expand(lse.shape)
    assert dead.any() == (window == (8, -1))
    assert torch.all(lse[dead] == np.log(2.0) * oracle.DEFAULT_MASK_VALUE)
    assert not o[dead].any() and not dq3[dead].any()


def test_window_routes_to_k3(monkeypatch):
    """Without segment ids or a softcap, the windowed backward is K3 alone."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append((name, kw.get("window")))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(flash_bwd_fused, "bwd", spy("K3", flash_bwd_fused.bwd))
    monkeypatch.setattr(flash_bwd, "dkv", spy("K5", flash_bwd.dkv))
    monkeypatch.setattr(flash_bwd, "dq", spy("K6", flash_bwd.dq))
    q, k, v = make_qkv(7, 1, 4, 64, 32, Hkv=2)
    q.requires_grad_(True)
    flashattn_tpu_torch.flash_attention(q, k, v, causal=True, window=[15.0, -1]).sum().backward()
    assert calls == [("K3", (15, -1))]


def test_window_offsets_and_bias_gradient_still_raise():
    """Nonzero offsets raise with their ROADMAP item, also with a window; the
    forward with a bias and a window is ported, and on the CPU its gradient
    too (dQ and dbias against autograd through the oracle; the card's
    kernels take a bias without a window)."""
    q, k, v = make_qkv(8, 1, 2, 64, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2, item 2"):
        flashattn_tpu_torch.flash_attention(q, k, v, window=(8, 8), q_offset=3)
    bias = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 2, 64, 64),
                                                                      dtype=np.float32))
    o = flashattn_tpu_torch.flash_attention(q, k, v, window=(8, 8), bias=bias)
    assert_close(o, oracle.attention_reference(q, k, v, window=(8, 8), bias=bias),
                 FWD_TOL[torch.float32])
    grads = []
    for fn in (flashattn_tpu_torch.flash_attention, oracle.attention_reference):
        qq, bb = q.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        (fn(qq, k, v, window=(8, 8), bias=bb) ** 2).sum().backward()
        grads.append((qq.grad, bb.grad))
    for name, got, want in zip(("dq", "dbias"), *grads):
        assert_close(got, want, BWD_TOL[torch.float32], name)


def test_window_validation():
    q, k, v = make_qkv(10, 1, 2, 32, 16)
    with pytest.raises(ValueError, match="window"):
        flash_fwd.fwd(q, k, v, scale=0.25, window=(1, 2, 3))
    assert flash_fwd.kernel_window(None) == (-1, -1)
    assert flash_fwd.kernel_window((-5, 7)) == (-1, 7)


def test_window_on_cpu_launches_no_kernel():
    before = (flash_fwd.fwd.launches, flash_fwd.fwd.launches_window,
              flash_bwd_fused.bwd.launches)
    q, k, v = make_qkv(11, 1, 2, 130, 32, dtype=torch.bfloat16)
    q.requires_grad_(True)
    flashattn_tpu_torch.flash_attention(q, k, v, causal=True, window=(31, -1)).float().sum() \
        .backward()
    assert q.grad is not None
    assert (flash_fwd.fwd.launches, flash_fwd.fwd.launches_window,
            flash_bwd_fused.bwd.launches) == before
