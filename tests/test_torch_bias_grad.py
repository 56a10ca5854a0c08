"""Gradients through an additive bias in the port (K5's bias read, K6's dbias)
against the JAX package on CPU.

Ports tests/test_flash_bwd.py::test_bwd_bias_grad (:64-80): one case per bias
shape it takes, ``(2,2,100,90)``, ``(1,2,100,90)`` and ``(1,1,100,90)``, with
the causal mask as there, without it, and with a logit softcap. The port's K1,
K5 and K6 wrappers run their plain PyTorch versions on CPU tensors; its
gradients (dQ, dK, dV, dbias) are held against ``jax.grad`` of the JAX
``attention_reference`` on the same numpy inputs, and one small case against
the JAX ``flash_attention`` in interpret mode (its Pallas K5/K6, as its own
tests run them). Budget: BWD_TOL[f32], the JAX test's. The port's own
invariants (the dbias reduction over broadcast dims, a bf16 bias's dbias
dtype, the GQA fold, a mask's missing gradient) are held the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.ops.oracle import attention_reference as jax_reference
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils.testing import BWD_TOL, assert_close, make_qkv

B, H, NQ, NK, D = 2, 2, 100, 90, 32
BIAS_SHAPES = [(2, 2, 100, 90), (1, 2, 100, 90), (1, 1, 100, 90)]
CAP = 30.0
VARIANTS = {"causal": dict(causal=True), "non-causal": {},
            "softcap": dict(causal=True, logit_softcap=CAP)}
TOL = BWD_TOL[torch.float32]
NAMES = ("dq", "dk", "dv", "dbias")


def _qkv(seed=1, **kw):
    return tuple(x.numpy() for x in make_qkv(seed, B, H, NQ, D, Nk=NK, **kw))


def _bias(seed, shape, scale=0.5):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale


def _torch_grads(q, k, v, bias, fn=flashattn_tpu_torch.flash_attention, **kw):
    leaves = [(x.clone() if isinstance(x, torch.Tensor) else torch.from_numpy(x)).requires_grad_(True)
              for x in (q, k, v, bias)]
    (fn(*leaves[:3], bias=leaves[3], **kw) ** 2).sum().backward()
    return [x.grad for x in leaves]


def _jax_grads(fn, q, k, v, bias, **kw):
    grads = jax.grad(lambda a, b, c, d: jnp.sum(fn(a, b, c, bias=d, **kw) ** 2),
                     argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    return [np.asarray(g) for g in grads]


def _assert_grads(got, want, tol=TOL, tag=""):
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), f"{name}{tag}"
        assert_close(g, w, tol, f"{name}{tag}")


@pytest.mark.parametrize("bshape", BIAS_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bias_grad_matches_jax(variant, bshape):
    q, k, v = _qkv()
    bias = _bias(2, bshape)
    kw = VARIANTS[variant]
    got = _torch_grads(q, k, v, bias, **kw)
    want = _jax_grads(jax_reference, q, k, v, bias, **kw)
    _assert_grads(got, want, tag=f"{variant}{bshape}")


@pytest.mark.parametrize("variant", ["causal", "softcap"])
def test_bias_grad_matches_jax_flash_interpret(variant):
    """One small case against the JAX flash_attention's own backward (Pallas
    K5/K6 with the bias read and dbias, in interpret mode)."""
    q, k, v = (x.numpy() for x in make_qkv(3, 1, 2, 64, 32, Nk=48))
    bias = _bias(4, (1, 2, 64, 48))
    kw = VARIANTS[variant]
    got = _torch_grads(q, k, v, bias, **kw)
    want = _jax_grads(flashattn_tpu.flash_attention, q, k, v, bias, **kw)
    _assert_grads(got, want, tag=variant)


REDUCED = [(1, 1, 1, NK), (B, 1, 1, NK), (1, H, 1, NK), (B, 1, NQ, NK), (B, H, 1, NK)]


@pytest.mark.parametrize("bshape", REDUCED, ids=lambda s: "x".join(map(str, s)))
def test_dbias_reduced_over_broadcast_dims(bshape):
    """dbias comes back in the bias's shape, summed over every dim where the
    bias had size 1 (flash.py:944-954), as autodiff of the broadcast gives."""
    q, k, v = _qkv(5, Hkv=1)
    bias = _bias(6, bshape)
    got = _torch_grads(q, k, v, bias, causal=True)
    want = _jax_grads(jax_reference, q, k, v, bias, causal=True)
    _assert_grads(got, want, tag=str(bshape))


def test_bf16_bias_gets_a_bf16_dbias():
    """A bf16 bias's gradient is cast to bf16: its f32 copy's, rounded."""
    q, k, v = _qkv(7)
    bias32 = torch.from_numpy(_bias(8, (1, 2, NQ, NK)))
    want = _torch_grads(q, k, v, bias32, causal=True)[3]
    got = _torch_grads(q, k, v, bias32.to(torch.bfloat16), causal=True)[3]
    assert got.dtype == torch.bfloat16 and got.shape == bias32.shape
    assert_close(got, want, BWD_TOL[torch.bfloat16], "dbias")


@pytest.mark.parametrize("kind", ["slots", "rows"])
def test_fold_dbias_equals_unfolded(kind):
    """The GQA decode fold tiles a row bias head-major (``bias.repeat``): its
    gradient sums back to the unfolded call's dbias, and dQ/dK/dV agree."""
    q, k, v = (x.numpy() for x in make_qkv(9, 2, 8, 4, 32, Nk=70, Hkv=2))
    bias = _bias(10, (1, 1, 1, 70) if kind == "slots" else (2, 1, 4, 70))
    bias[..., 60:] = -1e9  # the decode cache-slot mask's dead slots
    got = _torch_grads(q, k, v, bias)
    want = _torch_grads(q, k.repeat(4, axis=1), v.repeat(4, axis=1), bias)
    want[1:3] = [w.view(2, 2, 4, 70, 32).sum(2) for w in want[1:3]]
    _assert_grads(got, want, tag=kind)
    jax_want = _jax_grads(flashattn_tpu.flash_attention, q, k, v, bias)
    _assert_grads(got, jax_want, tag=f"{kind} vs jax")


def test_dbias_only_when_the_bias_needs_it(monkeypatch):
    """The backward (K6, or the bias route that computes K5 and K6 in one
    launch: every f32 and bf16 call with a bias up to D 128) is asked for
    dbias only when the bias requires grad; a mask (a bias without grad, as
    the SDPA adapter makes from a boolean mask) gets none."""
    asked = []
    for name in ("dq", "bias_bwd"):
        def spy(*args, want_dbias=False, real=getattr(flash_bwd, name), **kw):
            asked.append(want_dbias)
            return real(*args, want_dbias=want_dbias, **kw)

        monkeypatch.setattr(flash_bwd, name, spy)
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _qkv(11))
    bias = torch.from_numpy(_bias(12, (1, 1, NQ, NK)))
    flashattn_tpu_torch.flash_attention(q, k, v, bias=bias).sum().backward()
    flashattn_tpu_torch.flash_attention(q, k, v, bias=bias.requires_grad_(True)).sum().backward()
    assert asked == [False, True] and bias.grad is not None


@pytest.mark.parametrize("rank", [2, 4])
def test_sdpa_float_mask_gets_its_gradient(rank):
    """A float attn_mask that requires grad gets its gradient in its own
    shape (ranks < 4 are left-padded); a boolean mask gets none."""
    q, k, v = _qkv(13)
    mask = _bias(14, (NQ, NK) if rank == 2 else (1, H, NQ, NK))
    got = _torch_grads(q, k, v, mask, fn=lambda a, b, c, bias: (
        flashattn_tpu_torch.scaled_dot_product_attention(a, b, c, attn_mask=bias, impl="fused")))
    want = _jax_grads(jax_reference, q, k, v, mask.reshape((1,) * (4 - rank) + mask.shape))
    want[3] = want[3].reshape(mask.shape)
    _assert_grads(got, want, tag=f"rank {rank}")
    keep = torch.from_numpy(_bias(15, (1, 1, NQ, NK)) > -0.5)
    qq = torch.from_numpy(q).requires_grad_(True)
    flashattn_tpu_torch.scaled_dot_product_attention(
        qq, torch.from_numpy(k), torch.from_numpy(v), attn_mask=keep, impl="fused").sum().backward()
    assert qq.grad is not None and not keep.requires_grad


def test_padding_mask_rows_are_dead_as_in_jax():
    """A key-padding mask turned additive leaves the padded rows nothing to
    attend: K1's plain version, like the kernels, stores O = 0 there, and the
    backward gives them no gradient, as the JAX flash_attention does."""
    q, k, v = (x.numpy() for x in make_qkv(16, 1, 2, 64, 32))
    valid = np.arange(64) < 40
    pad = np.where(valid[:, None] & valid[None, :], 0.0, DEFAULT_MASK_VALUE)
    pad = pad.astype(np.float32)[None, None]
    o = flashattn_tpu_torch.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                            bias=torch.from_numpy(pad))
    assert torch.equal(o[:, :, 40:], torch.zeros_like(o[:, :, 40:]))
    got = _torch_grads(q, k, v, pad)
    _assert_grads(got, _jax_grads(flashattn_tpu.flash_attention, q, k, v, pad))
    assert float(got[0][:, :, 40:].abs().max()) == 0.0


def test_plain_k6_dbias_is_zero_on_masked_pairs():
    """dq_reference's dbias: P (dP − Δ), the full [B, Hq, Nq, Nk] f32, exactly
    0 on the pairs the forward masked (causal, keys past kv_valid_len)."""
    q, k, v = make_qkv(17, 1, 4, 40, 16, Nk=50, Hkv=2)
    do = make_qkv(18, 1, 4, 40, 16)[0]
    bias = torch.from_numpy(_bias(19, (1, 1, 40, 50)))
    kw = dict(scale=0.25, causal=True, kv_valid_len=30, bias=bias)
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    dq, dbias = flash_bwd.dq(q, k, v, do, lse, delta, want_dbias=True, **kw)
    assert dbias.shape == (1, 4, 40, 50) and dbias.dtype == torch.float32
    keep = flash_fwd.pair_mask(40, 50, kv_valid_len=30, causal=True, segment_ids=None,
                               device="cpu")
    assert torch.equal(dbias[~keep.expand_as(dbias)], torch.zeros(int((~keep).sum()) * 4))
    assert_close(dq, flash_bwd.dq(q, k, v, do, lse, delta, **kw), TOL, "dq")
    with pytest.raises(ValueError, match="want_dbias"):
        flash_bwd.dq(q, k, v, do, lse, delta, scale=0.25, want_dbias=True)
