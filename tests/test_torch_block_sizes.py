"""``BlockSizes`` and ``flash_attention(block_sizes=)`` against the JAX package
on CPU.

The class keeps the JAX one's fields, defaults, frozenness and checks, with
the same ``ValueError`` messages; the package exports it as the JAX package
does. The Hopper kernels' tiles are their design, so the option leaves the
call as it is (a tiny-Nq GQA call still folds): with and without it the
port gives the same tensors, and
against the JAX ``flash_attention`` given the same sizes (its Pallas K1 in
interpret mode) O agrees within FWD_TOL[f32] and the gradients within
BWD_TOL[f32]. What is not a ``BlockSizes`` raises ``TypeError``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu_torch.ops import flash
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

FIELDS = [f.name for f in dataclasses.fields(flashattn_tpu.BlockSizes)]


def test_fields_and_defaults_match_jax():
    assert [f.name for f in dataclasses.fields(flashattn_tpu_torch.BlockSizes)] == FIELDS
    assert (dataclasses.asdict(flashattn_tpu_torch.BlockSizes())
            == dataclasses.asdict(flashattn_tpu.BlockSizes()))


@pytest.mark.parametrize("field", FIELDS)
def test_frozen_as_jax(field):
    for cls in (flashattn_tpu_torch.BlockSizes, flashattn_tpu.BlockSizes):
        with pytest.raises(dataclasses.FrozenInstanceError):
            setattr(cls(), field, 512)


# Bad values per kind of field: block_q* a multiple of 16, block_k* of 128.
BAD = {"q": (8, 100, 129), "k": (64, 200, 16)}


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("which", [0, 1, 2])
def test_each_check_raises_the_jax_message(field, which):
    bad = BAD["q" if field.startswith("block_q") else "k"][which]
    with pytest.raises(ValueError) as jax_err:
        flashattn_tpu.BlockSizes(**{field: bad})
    with pytest.raises(ValueError) as err:
        flashattn_tpu_torch.BlockSizes(**{field: bad})
    assert str(err.value) == str(jax_err.value)
    assert str(err.value).startswith(f"{field}={bad} must be a multiple of")


@pytest.mark.parametrize("field", FIELDS)
def test_good_values_pass(field):
    good = 48 if field.startswith("block_q") else 384
    assert getattr(flashattn_tpu_torch.BlockSizes(**{field: good}), field) == good


def test_the_package_exports_it():
    assert flashattn_tpu_torch.BlockSizes is flash.BlockSizes
    assert "BlockSizes" in flashattn_tpu_torch.__all__


SIZES = dict(block_q=64, block_k=128, block_q_dkv=64, block_k_dkv=128, block_q_dq=64,
             block_k_dq=128)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(), dict(logit_softcap=5.0)],
                         ids=["causal", "full", "softcap"])
def test_same_function_with_block_sizes_and_as_jax(kw):
    """Forward and gradients: with the option equal to without it, bit for
    bit (the kernels' tiles do not move), and to the JAX function given the
    same sizes."""
    q, k, v = make_qkv(21, 1, 4, 130, 32, Nk=200, Hkv=2)
    do = torch.from_numpy(np.random.default_rng(22).standard_normal(q.shape, dtype=np.float32))
    outs = []
    for sizes in (None, flashattn_tpu_torch.BlockSizes(**SIZES)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = flashattn_tpu_torch.flash_attention(*leaves, block_sizes=sizes, **kw)
        outs.append((o.detach(), *torch.autograd.grad(o, leaves, do)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    o_jax, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(
        a, b, c, block_sizes=flashattn_tpu.BlockSizes(**SIZES), **kw), jq, jk, jv)
    grads_jax = vjp(jnp.asarray(do.numpy()))
    assert_close(outs[1][0], np.asarray(o_jax), FWD_TOL[torch.float32], "o")
    for name, g, w in zip(("dq", "dk", "dv"), outs[1][1:], grads_jax):
        assert_close(g, np.asarray(w), BWD_TOL[torch.float32], name)


def test_with_lse_takes_block_sizes():
    q, k, v = make_qkv(23, 1, 2, 64, 16)
    got = flashattn_tpu_torch.flash_attention_with_lse(
        q, k, v, block_sizes=flashattn_tpu_torch.BlockSizes(block_q=16))
    want = flashattn_tpu_torch.flash_attention_with_lse(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_block_sizes_keep_the_decode_fold(monkeypatch):
    """A tiny-Nq GQA call folds with the option as without it (the Hopper
    kernels take no tile sizes, so the option changes nothing): K1 sees
    [B, Hkv, rep·Nq, D] both times, and the outputs are equal."""
    from flashattn_tpu_torch.ops import flash_fwd

    seen = []
    real = flash_fwd.fwd

    def spy(q, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", spy)
    q, k, v = make_qkv(25, 1, 8, 4, 16, Nk=40, Hkv=2)
    got = flashattn_tpu_torch.flash_attention(
        q, k, v, block_sizes=flashattn_tpu_torch.BlockSizes(**SIZES))
    want = flashattn_tpu_torch.flash_attention(q, k, v)
    assert seen == [(1, 2, 16, 16), (1, 2, 16, 16)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_with_lse"])
@pytest.mark.parametrize("bad", [object(), dict(SIZES), (64, 128), "jax"],
                         ids=["object", "dict", "tuple", "jax BlockSizes"])
def test_what_is_not_a_block_sizes_raises(fn, bad):
    if bad == "jax":
        bad = flashattn_tpu.BlockSizes()
    q, k, v = make_qkv(24, 1, 2, 16, 8)
    with pytest.raises(TypeError, match="block_sizes must be a BlockSizes"):
        getattr(flashattn_tpu_torch, fn)(q, k, v, block_sizes=bad)
