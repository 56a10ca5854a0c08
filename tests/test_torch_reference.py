"""The port's golden model (``ops/reference.py``: the tiled FlashAttention-2
forward and the recompute backward) against the JAX package's on CPU.

The cases are tests/test_reference.py's -- (B, H, Nq, D, Nk) aligned, ragged
and the reference's unaligned head dim 111, causal or not, several
``block_q`` / ``block_k`` (tails padded to whole tiles), a bias -- on the same
numpy inputs for both; each is also held against the port's exact-softmax
oracle. Budgets: FWD_TOL[f32] on O and the LSE, BWD_TOL[f32] on dQ / dK /
dV and dbias (both models compute in f32; only the order of their sums
differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import reference as jax_ref
from flashattn_tpu_torch.ops import oracle, reference
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32 = torch.float32


def _jax(x):
    return jnp.asarray(x.detach().float().numpy())


# (B, H, Nq, D, Nk): tests/test_reference.py's shapes.
SHAPES = [(1, 2, 256, 64, 256), (2, 3, 200, 48, 130), (1, 1, 65, 111, 33)]
# (block_q, block_k): the JAX test's 64 x 64, the defaults, a block past N, an
# odd pair that leaves ragged tails on both sides.
BLOCKS = [(64, 64), (128, 128), (512, 32), (48, 80)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("blocks", BLOCKS, ids=lambda b: f"bq{b[0]}-bk{b[1]}")
def test_golden_forward_matches_jax_and_the_oracle(shape, causal, blocks):
    B, H, Nq, D, Nk = shape
    q, k, v = make_qkv(sum(shape), B, H, Nq, D, Nk=Nk)
    bq, bk = blocks
    o, lse = reference.flash_attention_reference(q, k, v, causal=causal, block_q=bq,
                                                 block_k=bk, return_lse=True)
    o_jax, lse_jax = jax_ref.flash_attention_reference(
        *(_jax(x) for x in (q, k, v)), causal=causal, block_q=bq, block_k=bk, return_lse=True)
    assert o.dtype == F32 and o.shape == q.shape and lse.shape == (B, H, Nq)
    assert_close(o, np.asarray(o_jax), FWD_TOL[F32], "o vs jax")
    assert_close(lse, np.asarray(lse_jax), FWD_TOL[F32], "lse vs jax")
    want, lse_want = oracle.attention_reference_with_lse(q, k, v, causal=causal)
    assert_close(o, want, FWD_TOL[F32], "o vs oracle")
    assert_close(lse, lse_want, FWD_TOL[F32], "lse vs oracle")


def test_golden_with_bias_matches_jax():
    q, k, v = make_qkv(2, 2, 2, 96, 32, Nk=80)
    bias = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 2, 96, 80),
                                                                      dtype=np.float32))
    got = reference.flash_attention_reference(q, k, v, bias=bias, block_q=32, block_k=32)
    want = jax_ref.flash_attention_reference(*(_jax(x) for x in (q, k, v)), bias=_jax(bias),
                                             block_q=32, block_k=32)
    assert_close(got, np.asarray(want), FWD_TOL[F32], "o vs jax")
    assert_close(got, oracle.attention_reference(q, k, v, bias=bias), FWD_TOL[F32], "oracle")


@pytest.mark.parametrize("window", [(16, -1), (8, 8), (-1, 4)])
def test_golden_window_and_gqa_match_jax(window):
    """GQA (K / V repeated to q's heads) and a window, causal, with a ragged
    tail; against the JAX model and the oracle."""
    q, k, v = make_qkv(5, 1, 4, 100, 32, Hkv=2)
    kw = dict(causal=True, window=window, block_q=32, block_k=64)
    got = reference.flash_attention_reference(q, k, v, **kw)
    want = jax_ref.flash_attention_reference(*(_jax(x) for x in (q, k, v)), **kw)
    assert_close(got, np.asarray(want), FWD_TOL[F32], "o vs jax")
    assert_close(got, oracle.attention_reference(q, k, v, causal=True, window=window),
                 FWD_TOL[F32], "o vs oracle")


def test_golden_keeps_the_input_dtype():
    q, k, v = (x.to(torch.bfloat16) for x in make_qkv(6, 1, 2, 70, 16))
    o, lse = reference.flash_attention_reference(q, k, v, block_q=32, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == F32


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("biased", [False, True])
def test_golden_backward_matches_jax_and_autograd(causal, biased):
    """The recompute backward (dQ, dK, dV and, with a bias, dbias) against
    the JAX model's on the same O / LSE / dO, and against autograd through
    the port's oracle (tests/test_reference.py's loss: sum of O squared)."""
    q, k, v = make_qkv(4, 1, 2, 96, 32, Nk=96)
    bias = None
    if biased:
        bias = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 2, 96, 96),
                                                                          dtype=np.float32))
    o, lse = oracle.attention_reference_with_lse(q, k, v, causal=causal, bias=bias)
    do = 2.0 * o
    got = reference.flash_attention_reference_bwd(q, k, v, o, lse, do, causal=causal, bias=bias)
    want = jax_ref.flash_attention_reference_bwd(
        *(_jax(x) for x in (q, k, v, o, lse, do)), causal=causal,
        bias=None if bias is None else _jax(bias))
    names = ("dq", "dk", "dv", "dbias")
    assert len(got) == len(want) == 3 + biased
    for name, g, w in zip(names, got, want):
        assert_close(g, np.asarray(w), BWD_TOL[F32], f"{name} vs jax")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    b_leaf = None if bias is None else bias.clone().requires_grad_(True)
    out = oracle.attention_reference(*leaves, causal=causal, bias=b_leaf)
    auto = torch.autograd.grad((out ** 2).sum(), leaves + ([b_leaf] if biased else []))
    for name, g, w in zip(names, got, auto):
        assert_close(g, w, BWD_TOL[F32], f"{name} vs autograd")
