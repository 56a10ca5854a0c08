"""The port's exact-softmax oracle against the JAX package's, in f32 on CPU.

Both oracles compute the same unfused f32 softmax attention from the same
numpy inputs; only the summation order of the two matrix products differs,
so they must agree to f32 round-off. ORACLE_TOL (1e-5 abs + 1e-5 rel) is ten
times below the package's f32 kernel budget FWD_TOL[f32] and well above the
~1e-6 round-off of O(1) outputs summed over at most 1234 keys and 111 dims.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import oracle as jax_oracle
from flashattn_tpu_torch.ops import oracle
from flashattn_tpu_torch.utils.testing import Tolerance, assert_close

ORACLE_TOL = Tolerance(1e-5, 1e-5)


def _inputs(seed, B, H, Nq, D, Nk, Hkv):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s, dtype=np.float32)
                 for s in ((B, H, Nq, D), (B, Hkv, Nk, D), (B, Hkv, Nk, D)))


def _both(fn_name, arrays, jax_kw, torch_kw):
    jfn, tfn = getattr(jax_oracle, fn_name), getattr(oracle, fn_name)
    want = jfn(*(jnp.asarray(a) for a in arrays), **jax_kw)
    got = tfn(*(torch.from_numpy(a) for a in arrays), **torch_kw)
    return got, want


def _segments(seed, B, Nq, Nk):
    """Sorted packed-sequence ids; q id 9 never appears among the kv ids, so
    those rows are dead (exact zeros by the package convention)."""
    rng = np.random.default_rng(seed)
    seg_q = np.sort(rng.integers(0, 3, (B, Nq)), axis=1).astype(np.int32)
    seg_q[:, -5:] = 9
    seg_kv = np.sort(rng.integers(0, 3, (B, Nk)), axis=1).astype(np.int32)
    return seg_q, seg_kv


# (name, (B, H, Nq, D, Nk, Hkv), options)
CASES = [
    # the reference's adversarial shape (tests/test_flash_fwd.py:75-78)
    ("adversarial", (3, 7, 1537, 111, 1234, 7), {}),
    ("gqa", (2, 8, 130, 64, 200, 2), {}),
    ("scale", (1, 2, 64, 40, 77, 2), {"scale": 0.3}),
    ("causal", (1, 3, 150, 64, 170, 3), {"causal": True}),
    ("causal-offsets", (1, 2, 96, 32, 160, 1), {"causal": True, "q_offset": 64, "kv_offset": 0}),
    ("window", (1, 2, 128, 32, 128, 2), {"window": (16, 8)}),
    ("window-left-causal", (1, 2, 128, 32, 128, 2), {"window": (31, -1), "causal": True}),
    ("window-dead-rows", (1, 2, 64, 32, 16, 2), {"window": (2, 0), "q_offset": 40}),
    ("softcap", (2, 2, 100, 48, 90, 1), {"logit_softcap": 5.0}),
    ("segments", (2, 2, 120, 32, 100, 2), {"segment_ids": None}),
    ("bias", (2, 4, 100, 32, 90, 4), {"bias": (2, 4, 100, 90)}),
    ("bias-broadcast", (2, 4, 100, 32, 90, 2), {"bias": (1, 4, 1, 90)}),
    ("all", (2, 4, 100, 32, 100, 2), {"bias": (2, 1, 100, 100), "causal": True,
                                       "window": (20, -1), "logit_softcap": 3.0,
                                       "segment_ids": None}),
]


@pytest.mark.parametrize("name,shape,opts", CASES, ids=[c[0] for c in CASES])
def test_attention_reference_matches_jax(name, shape, opts):
    B, H, Nq, D, Nk, Hkv = shape
    arrays = _inputs(len(name), B, H, Nq, D, Nk, Hkv)
    jax_kw, torch_kw = dict(opts), dict(opts)
    if "bias" in opts:
        bias = np.random.default_rng(7).standard_normal(opts["bias"], dtype=np.float32)
        jax_kw["bias"], torch_kw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    if "segment_ids" in opts:
        seg_q, seg_kv = _segments(3, B, Nq, Nk)
        jax_kw["segment_ids"] = (jnp.asarray(seg_q), jnp.asarray(seg_kv))
        torch_kw["segment_ids"] = (torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    got, want = _both("attention_reference", arrays, jax_kw, torch_kw)
    assert got.dtype == torch.float32 and got.shape == (B, H, Nq, D)
    assert_close(got, np.asarray(want), ORACLE_TOL, name)
    if "segment_ids" in opts or name == "window-dead-rows":
        dead = ~np.asarray(want).any(axis=-1)
        assert dead.any(), "the case must contain dead rows"
        assert not got.numpy()[dead].any(), "dead rows must be exact zeros"


@pytest.mark.parametrize("name,shape,opts", [
    ("plain", (1, 2, 130, 64, 200, 2), {}),
    ("gqa-causal-offsets", (2, 4, 96, 40, 160, 2), {"causal": True, "q_offset": 64}),
    ("bias", (1, 2, 77, 32, 77, 2), {"bias": (1, 2, 77, 77)}),
], ids=lambda x: x if isinstance(x, str) else "")
def test_attention_reference_with_lse_matches_jax(name, shape, opts):
    B, H, Nq, D, Nk, Hkv = shape
    arrays = _inputs(11, B, H, Nq, D, Nk, Hkv)
    jax_kw, torch_kw = dict(opts), dict(opts)
    if "bias" in opts:
        bias = np.random.default_rng(8).standard_normal(opts["bias"], dtype=np.float32)
        jax_kw["bias"], torch_kw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    (o, lse), (o_want, lse_want) = _both("attention_reference_with_lse", arrays,
                                         jax_kw, torch_kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Nq)
    assert_close(o, np.asarray(o_want), ORACLE_TOL, "o")
    assert_close(lse, np.asarray(lse_want), ORACLE_TOL, "lse")


def test_mask_value_is_finite_and_equal():
    assert oracle.DEFAULT_MASK_VALUE == jax_oracle.DEFAULT_MASK_VALUE
    assert np.isfinite(oracle.DEFAULT_MASK_VALUE) and oracle.DEFAULT_MASK_VALUE < -1e38


def test_low_precision_inputs_compute_in_f32():
    """bf16 inputs are upcast, computed in f32 and returned in bf16: the same
    result as the f32 computation rounded once."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(5, 1, 2, 64, 40, 77, 2))
    got = oracle.attention_reference(q, k, v)
    want = oracle.attention_reference(q.float(), k.float(), v.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_gqa_head_mismatch_raises():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 3, 8, 16, 8, 2))
    with pytest.raises(ValueError, match="GQA"):
        oracle.attention_reference(q, k, v)
