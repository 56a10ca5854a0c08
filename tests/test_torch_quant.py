"""The port's quantized-KV attention (ops/quant.py) and fp8 guard
(utils/platform.py) against the JAX package on CPU.

The same numpy inputs go through the JAX functions (Pallas in interpret mode,
as tests/test_quant_gemm.py runs them) and the port's, whose K1 wrapper runs
its plain version on a CPU tensor: attention over the dequantized cache in
f32. Budgets: ``quantize_kv`` payloads bit-equal and scales within one f32
ulp (both divide and round the same f32 values: ``jnp.round`` and
``torch.round`` round half to even, the fp8 casts round to nearest even);
attention outputs of bf16 queries at FWD_TOL[bf16] (2e-2, the bf16 kernel
budget: the JAX kernel rounds the scaled Q and P to bf16, the plain version
does not), f32 queries at FWD_TOL[f32] (1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import quant as jax_quant
from flashattn_tpu.ops.oracle import attention_reference as jax_reference
from flashattn_tpu_torch.ops import flash_fwd, quant
from flashattn_tpu_torch.utils import platform
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close, make_qkv

DTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _np(x):
    """A torch tensor as numpy, fp8 as its bytes (numpy has no fp8)."""
    if x.dtype == torch.float8_e4m3fn:
        return x.view(torch.uint8).numpy()
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _jnp_np(x):
    x = np.asarray(x)
    if str(x.dtype) == "float8_e4m3fn":
        return x.view(np.uint8)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def _jax_qkv(qkv):
    """The port's QuantizedKV as the JAX package's, every value kept."""
    def payload(x):
        if x.dtype == torch.float8_e4m3fn:
            return jnp.asarray(x.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        return jnp.asarray(x.numpy())
    return jax_quant.QuantizedKV(payload(qkv.k_q), jnp.asarray(qkv.k_scale.numpy()),
                                 payload(qkv.v_q), jnp.asarray(qkv.v_scale.numpy()))


def _to_jax(x):
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantize_kv_matches_jax(name, in_dtype):
    jdt, tdt = DTYPES[name]
    _, k, v = make_qkv(11, 2, 2, 8, 64, Nk=150, dtype=in_dtype)
    k = k * torch.linspace(0.01, 30.0, 150)[:, None].to(in_dtype)  # scales over decades
    want = jax_quant.quantize_kv(_to_jax(k), _to_jax(v), jdt, allow_slow_fp8=True)
    got = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    assert got.k_q.dtype == got.v_q.dtype == tdt
    assert got.k_scale.dtype == torch.float32 and got.k_scale.shape == (2, 2, 150)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            np.testing.assert_array_max_ulp(_np(g), np.asarray(w), maxulp=1)
        else:
            assert np.array_equal(_np(g), _jnp_np(w))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dequantize_kv_matches_jax(name):
    jdt, tdt = DTYPES[name]
    _, k, v = make_qkv(12, 1, 2, 8, 32, Nk=40)
    qkv = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = quant.dequantize_kv(qkv, dtype)
        want = jax_quant.dequantize_kv(_jax_qkv(qkv), jdtype)
        for g, w in zip(got, want):
            assert g.dtype == dtype
            assert np.array_equal(_np(g), _jnp_np(w))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantized_matches_jax(name, causal):
    """tests/test_quant_gemm.py's cases: bf16 q [1, 2, 200, 64], Nk 150."""
    jdt, tdt = DTYPES[name]
    q, k, v = make_qkv(0, 1, 2, 200, 64, Nk=150, dtype=torch.bfloat16)
    qkv = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    got = quant.flash_attention_quantized(q, qkv, causal=causal)
    want = jax_quant.flash_attention_quantized(_to_jax(q), _jax_qkv(qkv), causal=causal)
    kd, vd = quant.dequantize_kv(qkv, torch.float32)
    oracle = jax_reference(jnp.asarray(q.float().numpy()), jnp.asarray(kd.numpy()),
                           jnp.asarray(vd.numpy()), causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    tol = FWD_TOL[torch.bfloat16]
    assert_close(got, np.asarray(want.astype(jnp.float32)), tol, "vs jax")
    assert_close(got, np.asarray(oracle), tol, "vs dequantized oracle")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantized_bnhd_layout_matches_jax(name):
    """BNHD: q [B, N, H, D], payloads [B, N, Hkv, D], scales [B, N, Hkv]."""
    jdt, tdt = DTYPES[name]
    q, k, v = make_qkv(2, 2, 4, 96, 32, Nk=130, Hkv=2)
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qkv = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    assert qkv.k_scale.shape == (2, 130, 2)
    got = quant.flash_attention_quantized(q, qkv, layout="BNHD")
    want = jax_quant.flash_attention_quantized(_to_jax(q), _jax_qkv(qkv), layout="BNHD")
    bhnd = quant.flash_attention_quantized(
        q.transpose(1, 2), quant.QuantizedKV(*(x.transpose(1, 2) for x in qkv)))
    assert got.shape == q.shape
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32], "vs jax")
    assert torch.equal(got, bhnd.transpose(1, 2))


def _decode_bias(Nk, live, shape=(1, 1, 1)):
    bias = np.where(np.arange(Nk) < live, 0.0, -1e9).astype(np.float32)
    return np.broadcast_to(bias, (*shape, Nk)).copy()


@pytest.mark.parametrize("bias_rows", [1, 3])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_quantized_gqa_fold_with_decode_bias(name, bias_rows):
    """Hq 4 over Hkv 2 with Nq 1 and 3 (the fold's Nq·rep <= 32) and a
    head-broadcast cache-slot bias, row-broadcast or per row: equals JAX and
    the unfolded attention (K/V repeated to Hq heads, no fold)."""
    jdt, tdt = DTYPES[name]
    q, k, v = make_qkv(3, 2, 4, bias_rows, 64, Nk=90, Hkv=2)
    qkv = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    bias = _decode_bias(90, 57, (2, 1, bias_rows))
    got = quant.flash_attention_quantized(q, qkv, bias=torch.from_numpy(bias))
    want = jax_quant.flash_attention_quantized(jnp.asarray(q.numpy()), _jax_qkv(qkv),
                                               bias=jnp.asarray(bias))
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32], "vs jax")
    rep = quant.QuantizedKV(*(x.repeat_interleave(2, dim=1) for x in qkv))
    unfolded = quant.flash_attention_quantized(q, rep, bias=torch.from_numpy(bias))
    assert_close(got, unfolded, FWD_TOL[torch.float32], "vs unfolded")


def test_quantized_fold_reads_each_kv_head_once(monkeypatch):
    """With the fold K1 sees [B, Hkv, rep·Nq, D] queries; a head-dependent
    bias or causal keeps the Hq heads, as in the JAX package."""
    seen = []
    real = flash_fwd.fwd

    def spy(q, *args, **kw):
        seen.append(tuple(q.shape))
        return real(q, *args, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", spy)
    q, k, v = make_qkv(4, 1, 8, 2, 16, Nk=40, Hkv=2)
    qkv = quant.quantize_kv(k, v)
    quant.flash_attention_quantized(q, qkv)
    quant.flash_attention_quantized(q, qkv, bias=torch.zeros(1, 1, 1, 40))
    quant.flash_attention_quantized(q, qkv, bias=torch.zeros(1, 8, 1, 40))
    quant.flash_attention_quantized(q, qkv, causal=True)
    assert seen == [(1, 2, 8, 16), (1, 2, 8, 16), (1, 8, 2, 16), (1, 8, 2, 16)]


def test_fp8_guard_warns_and_falls_back_on_cpu():
    """tests/test_quant_gemm.py:34-44: on a device without native fp8 matrix
    units (the CPU) fp8 warns and quantizes as int8; allow_slow_fp8 forces
    fp8 through."""
    _, k, v = make_qkv(3, 1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.warns(UserWarning, match="native fp8"):
        qkv = quant.quantize_kv(k, v, dtype=torch.float8_e4m3fn)
    assert qkv.k_q.dtype == torch.int8
    qkv = quant.quantize_kv(k, v, dtype=torch.float8_e4m3fn, allow_slow_fp8=True)
    assert qkv.k_q.dtype == torch.float8_e4m3fn
    assert quant.resolve_quant_dtype(torch.int8) == torch.int8


def test_native_fp8_matmul_is_false_on_cpu():
    assert platform.native_fp8_matmul("cpu") is False
    assert platform.native_fp8_matmul(torch.device("cpu")) is False


def test_qmax_and_unsupported_dtype():
    assert quant._qmax(torch.int8) == 127.0 and quant._qmax(torch.float8_e4m3fn) == 448.0
    with pytest.raises(ValueError, match="unsupported KV quant dtype"):
        quant._qmax(torch.float16)


def test_fwd_checks_quantized_arguments():
    q, k, v = make_qkv(5, 1, 2, 16, 16, Nk=24)
    qkv = quant.quantize_kv(k, v)
    with pytest.raises(ValueError, match="need k_scale"):
        flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=0.25)
    with pytest.raises(ValueError, match="come together"):
        flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=0.25, k_scale=qkv.k_scale)
    with pytest.raises(ValueError, match="scales"):
        flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=0.25, k_scale=qkv.k_scale[:, :, :3],
                      v_scale=qkv.v_scale)
    with pytest.raises(ValueError, match="int8 or float8"):
        flash_fwd.fwd(q, k, v, scale=0.25, k_scale=qkv.k_scale, v_scale=qkv.v_scale)
    o, lse = flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=0.25, k_scale=qkv.k_scale,
                           v_scale=qkv.v_scale, kv_valid_len=10)
    kd, vd = quant.dequantize_kv(qkv, torch.float32)
    o_want, lse_want = flash_fwd.fwd_reference(q, kd, vd, scale=0.25, kv_valid_len=10)
    assert_close(o, o_want, FWD_TOL[torch.float32], "o")
    assert_close(lse, lse_want, FWD_TOL[torch.float32], "lse")


def test_quantized_takes_no_plain_path_off_the_cpu():
    q = torch.empty(1, 2, 1, 32, device="meta", dtype=torch.bfloat16)
    kq = torch.empty(1, 2, 64, 32, device="meta", dtype=torch.int8)
    s = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        quant.flash_attention_quantized(q, quant.QuantizedKV(kq, s, kq, s))
