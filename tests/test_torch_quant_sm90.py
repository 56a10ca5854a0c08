"""K1's quantized route (``csrc/flash_fwd_quant_sm90.cu``: int8 / fp8 K/V
widened in shared memory on the Hopper forward body) -- its plain version
against the JAX package, and the host glue that reaches its C entry -- on the
CPU.

* The plain K1 on int8 and fp8 K/V with segment ids, a window, q / kv
  offsets, a bias, GQA and a ragged ``kv_valid_len``: ``flash_fwd.fwd`` on
  CPU tensors (``fwd_reference``) against the JAX oracle
  ``flashattn_tpu.ops.oracle.attention_reference`` over JAX's
  ``quant.dequantize_kv`` of the same 8-bit K/V and scales (f32 queries,
  FWD_TOL[f32]; a kv_valid_len below Nk is given to JAX as K / V, their
  scales and ids cut to the valid keys; rows that see no key are dead, O =
  0, and are compared only there). Where the JAX ``flash_attention_quantized``
  reaches the case (causal, a bias), the port's is held against it too, its
  Pallas K1 in interpret mode as tests/test_quant_gemm.py runs it (bf16
  queries, FWD_TOL[bf16]).
* On a simulated card (meta tensors, the device checks off, a stand-in
  library recording each C entry's typed arguments): every quantized call
  that is not decode-shaped reaches ``fa_fwd_quant_sm90`` once and no other
  entry -- at D 40 / 96 / 136 / 256, on BNHD views with the BNHD scales'
  strides as they are, with 8-bit rows of D % 16 == 8 padded to 16 bytes,
  with the band ints, offsets, ids and bias strides -- and the decode-shaped
  ones at D 64 / 128 still reach ``fa_decode``.

The kernel itself runs only on the card: ``python3 chip_smoke.py`` holds it
against ``fwd_reference`` there (``phase_quant_check``).
"""

import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import quant as jax_quant
from flashattn_tpu.ops.oracle import attention_reference as jax_reference
from flashattn_tpu_torch.ops import flash_fwd, quant
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close, make_qkv

DTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _jax_qkv(qkv):
    """The port's QuantizedKV as the JAX package's, every value kept."""
    def payload(x):
        if x.dtype == torch.float8_e4m3fn:
            return jnp.asarray(x.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        return jnp.asarray(x.numpy())
    return jax_quant.QuantizedKV(payload(qkv.k_q), jnp.asarray(qkv.k_scale.numpy()),
                                 payload(qkv.v_q), jnp.asarray(qkv.v_scale.numpy()))


def _ids(seed, B, N, docs=3):
    """Sorted (packed) document ids [B, N] int32: cuts drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, N), np.int32)
    for b in range(B):
        for c in np.sort(rng.choice(np.arange(1, N), size=docs - 1, replace=False)):
            out[b, c:] += 1
    return torch.from_numpy(out)


# (B, Hq, Hkv, Nq, Nk, D, options): options as flash_fwd.fwd takes them, with
# "ids" for packed ids on both sides, "bias" for a normal [B, Hq, Nq, Nk]
# bias and "kvl" for kv_valid_len.
PLAIN_CASES = {
    "ids, GQA 4/2": (2, 4, 2, 96, 96, 32, dict(ids=True)),
    "window (40, 10), D 40": (1, 4, 2, 120, 120, 40, dict(window=(40, 10))),
    "causal, q_offset 48, D 96": (1, 4, 4, 64, 112, 96, dict(causal=True, q_offset=48)),
    "bias, window (30, -1), kv_offset 16": (2, 4, 2, 80, 80, 64,
                                           dict(bias=True, window=(30, -1), kv_offset=16)),
    "ragged kv_valid_len 70 of 96, causal": (1, 4, 2, 50, 96, 32, dict(causal=True, kvl=70)),
    "everything": (2, 4, 2, 100, 130, 40, dict(ids=True, bias=True, causal=True,
                                                window=(60, -1), q_offset=32, kvl=117)),
}


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_plain_k1_on_quantized_kv_matches_jax(case, name):
    jdt, tdt = DTYPES[name]
    B, Hq, Hkv, Nq, Nk, D, opts = PLAIN_CASES[case]
    q, k, v = make_qkv(40 + len(case), B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    qkv = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    kw = {n: x for n, x in opts.items() if n not in ("ids", "bias", "kvl")}
    kvl = opts.get("kvl", Nk)
    ids = (_ids(7, B, Nq), _ids(8, B, Nk)) if opts.get("ids") else None
    bias = (torch.from_numpy(np.random.default_rng(9).standard_normal((B, Hq, Nq, Nk),
                                                                      dtype=np.float32))
            if opts.get("bias") else None)
    o, lse = flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=D ** -0.5, k_scale=qkv.k_scale,
                           v_scale=qkv.v_scale, kv_valid_len=kvl, segment_ids=ids, bias=bias,
                           **kw)
    kd, vd = jax_quant.dequantize_kv(_jax_qkv(qkv), jnp.float32)
    jkw = dict(kw)
    if ids is not None:
        jkw["segment_ids"] = (jnp.asarray(ids[0].numpy()), jnp.asarray(ids[1][:, :kvl].numpy()))
    if bias is not None:
        jkw["bias"] = jnp.asarray(bias[..., :kvl].numpy())
    want = np.asarray(jax_reference(jnp.asarray(q.numpy()), kd[:, :, :kvl], vd[:, :, :kvl],
                                    scale=D ** -0.5, **jkw))
    live = flash_fwd.pair_mask(Nq, Nk, kv_valid_len=kvl, causal=kw.get("causal", False),
                               segment_ids=ids, device="cpu", window=kw.get("window"),
                               q_offset=kw.get("q_offset", 0),
                               kv_offset=kw.get("kv_offset", 0)).any(-1).expand(B, Hq, Nq)
    assert o.shape == q.shape and lse.shape == (B, Hq, Nq)
    assert_close(o[live], want[live.numpy()], FWD_TOL[torch.float32], "O on the live rows")
    assert not o[~live].any(), "dead rows' O"


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("causal,bias", [(True, False), (False, True), (True, True)])
def test_flash_attention_quantized_matches_jax_kernel(name, causal, bias):
    """The port's flash_attention_quantized (its plain K1 here) against the
    JAX one (its Pallas K1 in interpret mode) on bf16 queries, GQA 4/2, with
    causal and / or a per-row bias [B, 1, Nq, Nk] -- the calls K1's quantized
    route takes on the card (Nq is not decode-shaped)."""
    jdt, tdt = DTYPES[name]
    q, k, v = make_qkv(60, 2, 4, 96, 32, Nk=112, Hkv=2, dtype=torch.bfloat16)
    qkv = quant.quantize_kv(k, v, tdt, allow_slow_fp8=True)
    b = (torch.from_numpy(np.random.default_rng(61).standard_normal((2, 1, 96, 112),
                                                                    dtype=np.float32))
         if bias else None)
    got = quant.flash_attention_quantized(q, qkv, causal=causal, bias=b)
    want = jax_quant.flash_attention_quantized(
        jnp.asarray(q.float().numpy()).astype(jnp.bfloat16), _jax_qkv(qkv), causal=causal,
        bias=None if b is None else jnp.asarray(b.numpy()))
    assert got.dtype == torch.bfloat16
    assert_close(got, np.asarray(want.astype(jnp.float32)), FWD_TOL[torch.bfloat16], "vs jax")


# ---------------------------------------------------------------------------
# The simulated card.


def _recorder(name, argtypes, calls):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: calls.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: K1's device checks are off, and the
    stand-in library records the name and typed arguments of every C entry
    called."""
    calls = []
    typed = {"fa_fwd_quant_sm90": native.FWD_QUANT_SM90_ARGTYPES,
             "fa_fwd_sm90": native.FWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    lib.fa_decode = lambda *args: calls.append(("fa_decode", args)) or 0
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta(B, Hq, Hkv, Nq, Nk, D, dtype, bnhd):
    """Meta q (bf16), 8-bit k / v and f32 scales, BNHD views or BHND."""
    if bnhd:
        q = torch.empty((B, Nq, Hq, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
        k, v = (torch.empty((B, Nk, Hkv, D), dtype=dtype, device="meta").transpose(1, 2)
                for _ in "kv")
        ks, vs = (torch.empty((B, Nk, Hkv), device="meta").transpose(1, 2) for _ in "kv")
    else:
        q = torch.empty((B, Hq, Nq, D), dtype=torch.bfloat16, device="meta")
        k, v = (torch.empty((B, Hkv, Nk, D), dtype=dtype, device="meta") for _ in "kv")
        ks, vs = (torch.empty((B, Hkv, Nk), device="meta") for _ in "kv")
    return q, k, v, ks, vs


# (B, Hq, Hkv, Nq, Nk, D, K/V dtype, BNHD, options): the LM's prefill, the
# U-Net's head dim with ids, D 96 with a window and offsets, D 136 and D 256
# (the D 256 instantiation) with a bias, BNHD views with their strided
# scales, D 40 / 136 rows padded to 16 bytes, a decode-shaped call at D 256
# (the decode kernel lacks it).
GLUE_CASES = {
    "LM prefill, int8": (1, 16, 8, 256, 256, 128, torch.int8, False, dict(causal=True)),
    "D 40 ids, fp8 (rows padded)": (2, 4, 2, 130, 130, 40, torch.float8_e4m3fn, False,
                                    dict(ids=True)),
    "D 96 window + offsets, int8": (1, 4, 2, 200, 180, 96, torch.int8, False,
                                    dict(causal=True, window=(63, -1), q_offset=64)),
    "D 136 bias, fp8 (rows padded)": (1, 4, 4, 100, 90, 136, torch.float8_e4m3fn, False,
                                      dict(bias=True, kv_valid_len=77)),
    "D 256 bias + ids, int8": (2, 8, 4, 128, 128, 256, torch.int8, False,
                               dict(bias=True, ids=True, window=(100, 20))),
    "BNHD, int8": (2, 8, 2, 150, 150, 64, torch.int8, True, dict(causal=True)),
    "BNHD D 40, fp8": (1, 4, 2, 90, 160, 40, torch.float8_e4m3fn, True,
                       dict(kv_valid_len=100, kv_offset=30, causal=True)),
    "decode-shaped D 256, int8": (2, 8, 4, 1, 300, 256, torch.int8, False, {}),
}


@pytest.mark.parametrize("case", list(GLUE_CASES))
def test_quantized_calls_reach_fa_fwd_quant_sm90(card, case):
    """One fa_fwd_quant_sm90 call a K1 call, no other entry: K / V as the TMA
    maps read them (their strides, or a copy with rows padded to 16 bytes),
    the scales' pointers and strides as they are (BNHD's [B, Nk, Hkv]
    transposed), the dtype code, dims, band ints, offsets, scale, O in q's
    strides, the bias's strides, the ids' batch stride and the stream; the
    counters of the route, of the dtype and of the window."""
    B, Hq, Hkv, Nq, Nk, D, dt, bnhd, opts = GLUE_CASES[case]
    q, k, v, ks, vs = _meta(B, Hq, Hkv, Nq, Nk, D, dt, bnhd)
    kw = dict(opts)
    if kw.pop("ids", False):
        kw["segment_ids"] = (torch.zeros((B, Nq), dtype=torch.int32, device="meta"),
                             torch.zeros((B, Nk), dtype=torch.int32, device="meta"))
    if kw.pop("bias", False):
        kw["bias"] = torch.empty((B, 1, Nq, Nk), device="meta")
    kvl = kw.get("kv_valid_len", Nk)
    counters = lambda: (flash_fwd.fwd.launches_quant_sm90, flash_fwd.fwd.launches_int8,  # noqa
                        flash_fwd.fwd.launches_fp8, flash_fwd.fwd.launches_window)
    before = counters()
    o, lse = flash_fwd.fwd(q, k, v, scale=0.1, k_scale=ks, v_scale=vs, **kw)
    assert [name for name, _ in card] == ["fa_fwd_quant_sm90"]
    args = card[0][1]
    assert len(args) == len(native.FWD_QUANT_SM90_ARGTYPES) == 48
    window = kw.get("window")
    assert args[12:20] == (flash_fwd.KV_DTYPE_CODE[dt], B, Hq, Hkv, Nq, D, kvl,
                           int(kw.get("causal", False)))
    qo, ko = flash_fwd.band_offsets(kw.get("causal", False), window, kw.get("q_offset", 0),
                                    kw.get("kv_offset", 0))
    assert args[20:24] == (*flash_fwd.kernel_window(window), qo, ko)
    assert args[24] == pytest.approx(0.1)
    assert args[25:28] == tuple(q.stride()[:3]) and args[34:37] == tuple(o.stride()[:3])
    row = D + -D % 16  # an 8-bit row as TMA reads it: 16-byte strides
    want_kv = ((Nk * Hkv * D, D, Hkv * D) if bnhd and D % 16 == 0
               else (Hkv * Nk * row, Nk * row, row))
    assert args[28:31] == args[31:34] == want_kv
    pitch = Nk + -Nk % flash_fwd.BIAS_ROW_ALIGN
    want_bias = (0 if B == 1 else Nq * pitch, 0, pitch)  # 0 on the broadcast dims
    assert args[37:40] == (want_bias if "bias" in kw else (0, 0, 0))
    assert args[40:43] == args[43:46] == tuple(ks.stride())
    assert args[46] == (Nq if "segment_ids" in kw else 0) and args[47] == 77
    assert o.shape == q.shape and lse.shape == (B, Hq, Nq)
    assert counters() == (before[0] + 1, before[1] + (dt == torch.int8),
                          before[2] + (dt == torch.float8_e4m3fn),
                          before[3] + (flash_fwd.kernel_window(window) != (-1, -1)))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_shaped_quantized_calls_keep_the_decode_kernel(card, name, D):
    """A decode-shaped quantized call (Nq 1, GQA 8/4, no band) at D 64 / 128
    reaches fa_decode, as before the quantized route; never
    fa_fwd_quant_sm90."""
    q, k, v, ks, vs = _meta(2, 8, 4, 1, 500, D, DTYPES[name][1], False)
    flash_fwd.fwd(q, k, v, scale=0.1, k_scale=ks, v_scale=vs)
    assert [name for name, _ in card] == ["fa_decode"]


def test_flash_attention_quantized_bnhd_passes_the_scales_as_they_are(card):
    """flash_attention_quantized(layout="BNHD") over a whole prompt: the
    BNHD cache's views reach fa_fwd_quant_sm90 uncopied -- K / V with their
    [B, N, Hkv, D] strides, the scales with their [B, N, Hkv] strides."""
    q, k, v, ks, vs = _meta(1, 16, 8, 256, 256, 128, torch.int8, True)
    qkv = quant.QuantizedKV(*(x.transpose(1, 2) for x in (k, ks, v, vs)))
    o = quant.flash_attention_quantized(q.transpose(1, 2), qkv, causal=True, layout="BNHD")
    assert [name for name, _ in card] == ["fa_fwd_quant_sm90"]
    args = card[0][1]
    assert args[28:31] == (256 * 8 * 128, 128, 8 * 128)
    assert args[40:43] == args[43:46] == (256 * 8, 1, 8)
    assert o.shape == (1, 256, 16, 128)


@pytest.mark.parametrize("D,dtype,takes", [
    (128, torch.int8, True), (256, torch.float8_e4m3fn, True), (40, torch.int8, True),
    (128, torch.bfloat16, False), (264, torch.int8, False)])
def test_quant_route_takes_8bit_kv_up_to_d256(D, dtype, takes):
    assert flash_fwd.quant_route(head_dim=D, kv_dtype=dtype) == takes


@pytest.mark.parametrize("D", [40, 48, 136])
def test_8bit_rows_are_padded_to_16_bytes_for_tma(D):
    """An 8-bit K whose rows are not 16-byte multiples is copied with its rows
    padded (the map's column extent stays D, so the padding is never read);
    one whose rows are is passed as it is; the values survive either way."""
    k = torch.arange(2 * 3 * 5 * D, dtype=torch.int32).reshape(2, 3, 5, D).remainder(251).sub(
        125).to(torch.int8)
    got = flash_fwd._kernel_ready(k, 16, tma=True)
    assert torch.equal(got, k)
    assert (got is k) == (D % 16 == 0)
    assert all(s % 16 == 0 for s in got.stride()[:3]) and got.stride(-1) == 1
