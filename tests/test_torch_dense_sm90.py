"""K1's dense route and K3's Hopper kernel -- the rules that send a call to
them (``flash_fwd.dense_route`` after the decode and bias routes, the K3
branch of ``_FlashCore.backward``), the segment-id tile ranges the dense kernel skips by, the packing of both C
entries' arguments, the routing of ``flash_fwd.fwd`` and of
``_FlashCore.backward`` on a simulated card, and the plain versions at the
kernels' edge shapes -- against the JAX package on CPU.

The kernels run only on the card (``python3 chip_smoke.py`` holds them
against ``fwd_reference`` / ``bwd_reference`` there). On a "simulated card"
the wrappers get meta tensors (shapes and strides without data), their
device check is switched off and a stand-in library records every C entry
they call, so the route each call takes is seen without a GPU. The plain
versions are held against the JAX ``flash_attention_with_lse`` and
``jax.vjp`` of ``flash_attention``, whose Pallas K1 and K3 run in interpret
mode, as the JAX package's own tests run them, on the same numpy inputs:
budget FWD_TOL[f32] (1e-4 abs + 1e-4 rel) for the forward and BWD_TOL[f32]
(1e-3 abs + 5e-4 rel) for the gradients. A kv_valid_len below Nk is given to
JAX as K / V cut to their first kv_valid_len keys.
"""

import contextlib
import ctypes
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.ops.flash import _seg_block_flags
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

N = 2048  # the LM's sequence


def _dense(head_dim=128, bias=None, kv_dtype=torch.bfloat16):
    return flash_fwd.dense_route(head_dim=head_dim, bias=bias, kv_dtype=kv_dtype)


# The head dims K1's dense route takes on bf16 K/V without a bias: the LM's
# 128, the U-Net's 40, those run in a wider box (8, 80, 96) and, on its D 256
# form, Gemma 2's 256 and those run in its box (136, 160, 192). Causal, a
# window, segment ids, the softcap and the rows per KV head are not its test:
# the rule does not read them, and fwd's order (decode, bias, dense) decides
# the rows, on a simulated card below.
DENSE_TAKES = {"LM D 128": {}, "U-Net D 40": dict(head_dim=40), "D 64": dict(head_dim=64),
               "D 80": dict(head_dim=80), "D 96": dict(head_dim=96), "D 8": dict(head_dim=8),
               "D 160": dict(head_dim=160), "D 136": dict(head_dim=136),
               "D 192": dict(head_dim=192), "D 256": dict(head_dim=256)}
# Those it refuses, which take the quantized route (int8 / fp8 K/V) or the
# bias route (a bias).
DENSE_REFUSES = {"int8 K/V": dict(kv_dtype=torch.int8),
                 "fp8 K/V": dict(kv_dtype=torch.float8_e4m3fn),
                 "bias": dict(bias=torch.empty((1, 1, 1, N), device="meta")),
                 "bias at D 160": dict(head_dim=160,
                                       bias=torch.empty((1, 1, 1, N), device="meta")),
                 "int8 K/V at D 256": dict(head_dim=256, kv_dtype=torch.int8)}


@pytest.mark.parametrize("case", list(DENSE_TAKES))
def test_dense_route_takes(case):
    assert _dense(**DENSE_TAKES[case])


@pytest.mark.parametrize("case", list(DENSE_REFUSES))
def test_dense_route_refuses(case):
    assert not _dense(**DENSE_REFUSES[case])


# ---------------------------------------------------------------------------
# The C entries' argument packing, through ctypes stand-ins with their argtypes.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


def _bnhd(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16) for x in xs)


@pytest.mark.parametrize("segments", [False, True])
def test_dense_launch_packs_the_c_arguments(segments):
    """fa_fwd_sm90 on BNHD views with GQA, a window, q / kv offsets and (or
    not) segment ids: every pointer (the four segment inputs null without
    them), dim, the window as the C entry's (wl, wr), the offsets, the scale,
    every stride, the ids' batch stride and the stream, in the C entry's
    order."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 200, 150, 64
    q, k, v = _bnhd(*make_qkv(80, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o, lse = torch.empty_like(q), torch.empty((B, Hq, Nq))
    ids = (torch.arange(Nq).repeat(B, 1) // 50, torch.arange(Nk).repeat(B, 1) // 50)
    seg = flash_fwd.sm90_segments(ids, Nq, 140) if segments else None
    seen = []
    lib = types.SimpleNamespace(fa_fwd_sm90=_recorder("fa_fwd_sm90", native.FWD_SM90_ARGTYPES,
                                                      seen))
    rc = flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, seg, scale=0.125, kv_valid_len=140,
                                      causal=True, window=(100, -1), softcap=None, stream=4096,
                                      q_offset=600, kv_offset=200)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.FWD_SM90_ARGTYPES) == 36
    assert args[:5] == tuple(x.data_ptr() for x in (q, k, v, o, lse))
    assert args[5:9] == ((None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg))
    assert args[9:18] == (B, Hq, Hkv, Nq, D, 140, 1, 100, -1)
    assert args[18:20] == (600, 200)  # q_offset, kv_offset
    assert args[20:22] == (0.125, 0.0)  # the scale, no softcap
    assert args[22:25] == (Nq * Hq * D, D, Hq * D)  # q: BNHD, (batch, head, seq)
    assert args[25:28] == (Nk * Hkv * D, D, Hkv * D)
    assert args[28:31] == args[25:28] and args[31:34] == args[22:25]
    assert args[34] == (Nq if segments else 0) and args[35] == 4096


@pytest.mark.parametrize("D", [160, 256])
def test_dense_launch_packs_wide_head_dims(D):
    """fa_fwd_sm90 at a head dim its D 256 form takes (D 160 in the 256
    box, D 256), causal with q / kv offsets (a contiguous ring's chunk
    pair): D as passed (the C entry picks the box), the offsets and the
    strides of the BNHD views packed as at D <= 128."""
    B, Hq, Hkv, Nq, Nk = 1, 4, 2, 130, 70
    q, k, v = _bnhd(*make_qkv(81, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o, lse = torch.empty_like(q), torch.empty((B, Hq, Nq))
    seen = []
    lib = types.SimpleNamespace(fa_fwd_sm90=_recorder("fa_fwd_sm90", native.FWD_SM90_ARGTYPES,
                                                      seen))
    rc = flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, None, scale=D ** -0.5,
                                      kv_valid_len=Nk, causal=True, window=None, softcap=None,
                                      stream=8192, q_offset=Nq, kv_offset=0)
    assert rc == 0 and [name for name, _ in seen] == ["fa_fwd_sm90"]
    args = seen[0][1]
    assert args[5:9] == (None,) * 4
    assert args[9:18] == (B, Hq, Hkv, Nq, D, Nk, 1, -1, -1)
    assert args[18:20] == (Nq, 0)  # q_offset, kv_offset
    assert args[20] == pytest.approx(D ** -0.5) and args[21] == 0.0
    assert args[22:25] == (Nq * Hq * D, D, Hq * D)
    assert args[25:28] == (Nk * Hkv * D, D, Hkv * D)
    assert args[34:] == (0, 8192)


@pytest.mark.parametrize("window", [None, (64, 7)])
def test_k3_launch_packs_the_c_arguments(window):
    """fa_bwd_sm90 on BNHD views with GQA: every pointer, dim, the window,
    the offsets, the LSE rows' pitch, the scale, every stride and the stream,
    in the C entry's order."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 130, 80
    q, k, v = _bnhd(*make_qkv(81, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 128))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hq, Nk, D)), torch.empty((B, Hq, Nk, D))
    seen = []
    lib = types.SimpleNamespace(fa_bwd_sm90=_recorder("fa_bwd_sm90", native.BWD_SM90_ARGTYPES,
                                                      seen))
    rc = flash_bwd_fused._launch(lib, q, k, v, do, stats, stats, dq, dk, dv, scale=0.25,
                                 causal=False, kv_valid_len=120, window=window, nq_pad=128,
                                 stream=4096, q_offset=96, kv_offset=-64)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.BWD_SM90_ARGTYPES) == 36
    assert args[:9] == tuple(x.data_ptr() for x in (q, k, v, do, stats, stats, dq, dk, dv))
    assert args[9:19] == (B, Hq, Hkv, Nq, Nk, D, 120, 0, *flash_fwd.kernel_window(window))
    assert args[19:22] == (96, -64, 128)  # q_offset, kv_offset, the LSE rows' pitch
    assert args[22] == 0.25
    assert args[23:26] == (Nq * Hq * D, D, Hq * D)
    assert args[26:29] == (Nk * Hkv * D, D, Hkv * D)
    assert args[29:32] == args[26:29] and args[32:35] == args[23:26]
    assert args[35] == 4096


# ---------------------------------------------------------------------------
# The routes on a simulated card.


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' device checks are off,
    the stand-in library records the name of every C entry called."""
    calls = []
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_bias_sm90": native.BWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES,
             "fa_fwd_quant_sm90": native.FWD_QUANT_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    lib.fa_decode = lambda *args: calls.append(("fa_decode", args)) or 0
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta_qkv(B, Hq, Hkv, Nq, Nk, D, dtype=torch.bfloat16):
    q = torch.empty((B, Nq, Hq, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=dtype, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


# (B, Hq, Hkv, Nq, Nk, D, options, the C entry): the LM, the U-Net's self-
# and cross-attention, the packed LM, the SWA window, a two-sided window, a
# ragged D 96 call, the decode-shaped calls that the decode kernel refuses
# (D 40; causal), the softcap, D 160 and a decode-shaped call at D 256 on the
# dense route's D 256 form, and what stays elsewhere -- a bias on the bias
# route (above D 128 its D 256 form), a decode-shaped call at D 128 on the
# decode kernel.
FWD_CASES = {"LM causal": (1, 16, 8, 256, 256, 128, dict(causal=True), "fa_fwd_sm90"),
             "U-Net self D 40": (1, 8, 8, 512, 512, 40, {}, "fa_fwd_sm90"),
             "U-Net cross Nk 77": (1, 8, 8, 512, 77, 40, {}, "fa_fwd_sm90"),
             "packed segments": (2, 4, 2, 256, 256, 64, dict(causal=True, segment_ids=True),
                                 "fa_fwd_sm90"),
             "SWA window": (1, 4, 2, 512, 512, 128, dict(causal=True, window=(127, -1)),
                            "fa_fwd_sm90"),
             "two-sided window": (1, 4, 4, 300, 300, 64, dict(window=(30, 30)), "fa_fwd_sm90"),
             "ragged D 96": (1, 4, 2, 1537, 77, 96, {}, "fa_fwd_sm90"),
             "decode-shaped D 40": (2, 4, 2, 1, 512, 40, {}, "fa_fwd_sm90"),
             "decode-shaped causal": (2, 4, 2, 4, 512, 128, dict(causal=True), "fa_fwd_sm90"),
             "D 160": (1, 2, 2, 128, 128, 160, {}, "fa_fwd_sm90"),
             "decode-shaped D 256": (2, 4, 2, 1, 512, 256, {}, "fa_fwd_sm90"),
             "bias at D 160": (1, 2, 2, 128, 128, 160, dict(bias=True), "fa_fwd_bias_sm90"),
             "softcap": (1, 4, 2, 128, 128, 128, dict(causal=True, softcap=50.0), "fa_fwd_sm90"),
             "bias": (1, 4, 4, 128, 128, 128, dict(bias=True), "fa_fwd_bias_sm90"),
             "decode-shaped": (2, 4, 2, 1, 512, 128, {}, "fa_decode")}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_fwd_routes_on_a_simulated_card(card, case):
    B, Hq, Hkv, Nq, Nk, D, opts, entry = FWD_CASES[case]
    q, k, v = _meta_qkv(B, Hq, Hkv, Nq, Nk, D)
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = tuple(torch.zeros((B, n), dtype=torch.int32, device="meta")
                                  for n in (Nq, Nk))
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros((1, 1, 1, Nk), device="meta")
    counters = lambda: (flash_fwd.fwd.launches, flash_fwd.fwd.launches_dense_sm90,  # noqa: E731
                        flash_fwd.fwd.launches_dense_d256)
    before = counters()
    o, lse = flash_fwd.fwd(q, k, v, scale=D ** -0.5, **kw)
    assert [name for name, _ in card] == [entry]
    assert o.shape == q.shape and lse.shape == (B, Hq, Nq)
    dense = entry == "fa_fwd_sm90"
    assert counters() == (before[0] + 1, before[1] + dense, before[2] + (dense and D > 128))
    if dense:  # O in q's (BNHD) strides on every dim of extent > 1, as the kernel writes it
        assert [a for a, n in zip(o.stride(), q.shape) if n > 1] == [
            a for a, n in zip(q.stride(), q.shape) if n > 1]
        args = card[0][1]
        assert args[34] == (Nq if "segment_ids" in kw else 0)  # the ids' batch stride


# (D, K/V dtype, options): calls on quantized K/V (int8 with a per-query-row
# bias, fp8 causal without one), which K1's quantized route takes
# (fa_fwd_quant_sm90, where the mma.sync fa_fwd took them before it), and the
# bf16 calls with a bias above D 128 (with and without the softcap, causal),
# which reach fa_fwd_bias_sm90.
FA_FWD_CASES = {"bias at D 160": (160, torch.bfloat16, dict(bias=(1, 1, 1))),
                "capped bias at D 256": (256, torch.bfloat16,
                                         dict(bias=(2, 1, 1), causal=True, softcap=30.0)),
                "int8 K/V at D 64 with a row bias": (64, torch.int8, dict(bias=(1, 4, 100))),
                "fp8 K/V at D 128": (128, torch.float8_e4m3fn, dict(causal=True))}


@pytest.mark.parametrize("case", list(FA_FWD_CASES))
def test_fa_fwd_packs_the_c_arguments(card, case):
    """fa_fwd_quant_sm90 on BNHD views with GQA and kv_valid_len < Nk: the K/V
    dtype code, dims, causal, the window and offsets (none here), the scale,
    every stride (0 on the bias's broadcast dims; the bias's rows padded to
    16 bytes by sm90_bias; the scales' own) and the stream, in the C entry's
    typed order. A bf16 call takes the bias route (its D 256 form)."""
    D, kv_dtype, opts = FA_FWD_CASES[case]
    B, Hq, Hkv, Nq, Nk = 2, 4, 2, 100, 150
    q, k, v = _meta_qkv(B, Hq, Hkv, Nq, Nk, D, dtype=kv_dtype)
    kw = dict(opts)
    bias_shape = kw.pop("bias", None)
    if bias_shape:
        kw["bias"] = torch.zeros((*bias_shape, Nk), device="meta")
    quant = kv_dtype != torch.bfloat16
    if quant:
        kw["k_scale"], kw["v_scale"] = (torch.ones((B, Hkv, Nk), device="meta") for _ in "kv")
    flash_fwd.fwd(q, k, v, scale=0.125, kv_valid_len=120, **kw)
    if not quant:
        assert [name for name, _ in card] == ["fa_fwd_bias_sm90"]
        args = card[0][1]
        assert args[10:16] == (B, Hq, Hkv, Nq, D, 120)
        assert args[22] == pytest.approx(kw.get("softcap", 0.0))
        return
    assert [name for name, _ in card] == ["fa_fwd_quant_sm90"]
    args = card[0][1]
    assert len(args) == len(native.FWD_QUANT_SM90_ARGTYPES) == 48
    assert args[12:20] == (flash_fwd.KV_DTYPE_CODE[kv_dtype], B, Hq, Hkv, Nq, D, 120,
                           int(kw.get("causal", False)))
    assert args[20:24] == (-1, -1, 0, 0) and args[24] == 0.125
    assert args[25:28] == (Nq * Hq * D, D, Hq * D)
    assert args[28:31] == args[31:34] == (Nk * Hkv * D, D, Hkv * D)
    assert args[34:37] == args[25:28]  # O in q's strides
    if bias_shape:
        rows = bias_shape[2] * (Nk + -Nk % flash_fwd.BIAS_ROW_ALIGN)
        want = tuple(0 if n == 1 else s for n, s in zip(bias_shape, (
            bias_shape[1] * rows, rows, Nk + -Nk % flash_fwd.BIAS_ROW_ALIGN)))
        assert args[37:40] == want
    else:
        assert args[37:40] == (0, 0, 0) and args[7] is None
    assert args[40:46] == (Hkv * Nk, Nk, 1) * 2
    assert args[46:48] == (0, 77)


# flash_attention's forward and backward on a simulated card: the LM-like
# causal GQA call, the SWA window and a call with neither take K1's dense
# route and K3's Hopper kernel; the packed LM takes K5 + K6's one-launch
# split route behind the dense route; a bias takes the bias route and its
# one-kernel backward; the softcap takes the dense route, then the split route.
GRAD_CASES = {"causal GQA": (dict(causal=True), ["fa_fwd_sm90", "fa_bwd_sm90"]),
              "window": (dict(causal=True, window=(100, -1)), ["fa_fwd_sm90", "fa_bwd_sm90"]),
              "no mask": ({}, ["fa_fwd_sm90", "fa_bwd_sm90"]),
              "bias": (dict(bias=True), ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
              "packed": (dict(causal=True, segment_ids=True),
                         ["fa_fwd_sm90", "fa_bwd_split_sm90"]),
              "softcap": (dict(causal=True, logit_softcap=50.0),
                          ["fa_fwd_sm90", "fa_bwd_split_sm90"])}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_flash_core_routes_on_a_simulated_card(card, case):
    opts, entries = GRAD_CASES[case]
    B, Hq, Hkv, N_, D = 2, 8, 4, 300, 64
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(B, Hq, Hkv, N_, N_, D))
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, N_), dtype=torch.int32, device="meta")
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros((1, 1, 1, N_), device="meta")
    before = (flash_bwd_fused.bwd.launches, flash_bwd_fused.bwd.launches_sm90)
    o = flashattn_tpu_torch.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [name for name, _ in card] == entries
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    k3 = "fa_bwd_sm90" in entries
    assert (flash_bwd_fused.bwd.launches, flash_bwd_fused.bwd.launches_sm90) == (
        before[0] + k3, before[1] + k3)
    if k3:  # the LSE rows padded to 64
        assert card[1][1][21] == 320


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    """On CPU tensors the forward and backward of the dense route's and K3's
    calls run the plain versions: no library, no launch counted."""
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(native, "kernels", no_library)
    counters = lambda: (flash_fwd.fwd.launches, flash_fwd.fwd.launches_dense_sm90,  # noqa: E731
                        flash_bwd_fused.bwd.launches, flash_bwd_fused.bwd.launches_sm90)
    before = counters()
    q, k, v = (x.to(torch.bfloat16).requires_grad_(True)
               for x in make_qkv(82, 1, 4, 130, 40, Hkv=2))
    o = flashattn_tpu_torch.flash_attention(q, k, v, causal=True, window=(50, -1))
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert counters() == before
    assert all(torch.isfinite(g.float()).all() for g in grads)


# ---------------------------------------------------------------------------
# The segment-id tile ranges against the JAX package's block flags.


def _packed(n, doc):
    return np.arange(n) // doc


def _ids(kind, n, rng):
    if kind == "packed aligned":
        return np.stack([_packed(n, 128), _packed(n, 256)])
    if kind == "packed across edges":  # documents of 45 and 200 tokens
        return np.stack([_packed(n, 45), _packed(n, 200)])
    return np.cumsum(rng.random((2, n)) < 6 / n, axis=1)  # random boundaries


def _port_flags(q_ids, kv_ids, nq, nkv):
    qr = flash_fwd.seg_tile_ranges(torch.from_numpy(q_ids).int(), nq, flash_fwd.SM90_Q_TILE)
    kr = flash_fwd.seg_tile_ranges(torch.from_numpy(kv_ids).int(), nkv, flash_fwd.SM90_KV_TILE)
    run = (qr[:, :, None, 0] <= kr[:, None, :, 1]) & (kr[:, None, :, 0] <= qr[:, :, None, 1])
    full = ((qr[:, :, None, 0] == qr[:, :, None, 1]) & (kr[:, None, :, 0] == kr[:, None, :, 1])
            & (qr[:, :, None, 0] == kr[:, None, :, 0]))
    return run.numpy(), full.numpy()


@pytest.mark.parametrize("kind", ["packed aligned", "packed across edges", "random"])
def test_seg_tile_ranges_match_jax_block_flags(kind):
    """On whole tiles (Nq 1024, Nk 768), the ranges' run / full flags are
    exactly those of _seg_block_flags (flashattn_tpu/ops/flash.py:312) at
    the kernel's 128-row Q tiles and 64-key KV tiles."""
    rng = np.random.default_rng(83)
    q_ids = _ids(kind, 1024, rng)
    kv_ids = q_ids[:, :768] if kind != "random" else _ids(kind, 768, rng)
    run, full = _port_flags(q_ids, kv_ids, 1024, 768)
    flags = np.asarray(_seg_block_flags(jnp.asarray(q_ids, jnp.int32),
                                        jnp.asarray(kv_ids, jnp.int32), 128, 64))
    np.testing.assert_array_equal(run, flags[:, 0].astype(bool))
    np.testing.assert_array_equal(full, flags[:, 1].astype(bool))
    assert run.any() and not run.all()


def test_seg_tile_ranges_on_ragged_tiles_are_conservative():
    """On ragged tails (Nq 300, kv_valid_len 77 of Nk 100), a tile pair the
    ranges skip holds no pair of equal ids among the rows below Nq and the
    keys below kv_valid_len, and every pair they keep is one that the JAX
    flags (on the ids padded with their -1 / -2 sentinels) keep too."""
    q_ids, kv_ids = _packed(300, 45)[None], _packed(100, 30)[None]
    run, _ = _port_flags(q_ids, kv_ids, 300, 77)
    pad_q = np.pad(q_ids, ((0, 0), (0, 84)), constant_values=-1)
    pad_k = np.pad(kv_ids[:, :77], ((0, 0), (0, 51)), constant_values=-2)
    flags = np.asarray(_seg_block_flags(jnp.asarray(pad_q, jnp.int32),
                                        jnp.asarray(pad_k, jnp.int32), 128, 64))
    assert run.shape == (1, 3, 2) and not (run & ~flags[:, 0].astype(bool)).any()
    for i in range(3):
        for j in range(2):
            qs, ks = q_ids[0, 128 * i:min(300, 128 * i + 128)], kv_ids[0, 64 * j:min(77, 64 * j + 64)]
            assert run[0, i, j] == np.isin(qs, ks).any()


def test_sm90_segments_cut_and_pad_the_key_ids():
    """The dense kernel's segment inputs: seg_kv's first kv_valid_len ids in
    rows padded to whole 64-key tiles, one range per tile of each; none
    without keys or ids."""
    ids = (torch.arange(300).repeat(2, 1) // 45, torch.arange(200).repeat(2, 1) // 45)
    seg_q, kv_pad, q_rng, kv_rng = flash_fwd.sm90_segments(ids, 300, 130)
    assert seg_q.dtype == torch.int32 and torch.equal(seg_q, ids[0].int())
    assert kv_pad.shape == (2, 192) and torch.equal(kv_pad[:, :130], ids[1][:, :130].int())
    assert q_rng.shape == (2, 3, 2) and kv_rng.shape == (2, 3, 2)
    assert kv_rng[0, 2].tolist() == [128 // 45, 129 // 45]  # the ragged last tile
    # kv_valid_len a multiple of the tile below Nk: the rows are still copied
    # whole (the kernel reads them at a batch stride of 64 a tile).
    kv_pad = flash_fwd.sm90_segments(ids, 300, 128)[1]
    assert kv_pad.is_contiguous() and torch.equal(kv_pad, ids[1][:, :128].int())
    assert flash_fwd.sm90_segments(ids, 300, 0) is None
    assert flash_fwd.sm90_segments(None, 300, 130) is None


# ---------------------------------------------------------------------------
# The plain versions against the JAX K1 / K3 at the kernels' edge shapes.


def _jx(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


# (B, Hq, Hkv, Nq, Nk, D, kv_valid_len, options): ragged tiles on both sides
# (Nq 127 / 129, Nk 63 / 65 / 77), head dims the kernels run in a wider box
# (40, 80, 96), GQA 16 / 8 causal with Nq < Nk, a window whose edges fall
# inside a tile, causal with a window, documents straddling the tiles, and a
# kv_valid_len that ends inside a tile.
EDGE_CASES = {"Nq127-Nk63 D40": (1, 2, 2, 127, 63, 40, 63, {}),
              "Nq129-Nk65 D80 causal": (1, 2, 1, 129, 65, 80, 65, dict(causal=True)),
              "Nk77 D96": (2, 2, 2, 129, 77, 96, 77, {}),
              "GQA16/8 causal Nq<Nk": (1, 16, 8, 65, 129, 64, 129, dict(causal=True)),
              "window edges in a tile": (1, 2, 2, 129, 129, 64, 129, dict(window=(37, 5))),
              "causal window": (1, 2, 2, 127, 127, 128, 127, dict(causal=True, window=(63, -1))),
              "segments across tiles": (2, 2, 2, 129, 129, 40, 129,
                                        dict(causal=True, segment_ids=45)),
              "kv_valid_len 65 of 77": (1, 2, 2, 127, 77, 64, 65, {})}


def _edge_kwargs(case):
    B, Hq, Hkv, Nq, Nk, D, valid, opts = EDGE_CASES[case]
    opts = dict(opts)
    doc = opts.pop("segment_ids", None)
    seg = None if doc is None else np.stack([_packed(Nq, doc), _packed(Nq, doc + 7)])
    return (B, Hq, Hkv, Nq, Nk, D, valid), opts, seg


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_fwd_reference_at_edge_shapes_matches_jax(case):
    (B, Hq, Hkv, Nq, Nk, D, valid), opts, seg = _edge_kwargs(case)
    q, k, v = make_qkv(84, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    ids = None if seg is None else (torch.from_numpy(seg).int(),) * 2
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=D ** -0.5, kv_valid_len=valid,
                                     segment_ids=ids, **opts)
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *_jx(q, k[:, :, :valid], v[:, :, :valid]), **opts,
        segment_ids=None if seg is None else _jx(seg, seg[:, :valid]))
    live = lse > 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse[live], np.asarray(lse_want)[live.numpy()], FWD_TOL[torch.float32], "lse")
    assert (o[~live] == 0).all()


GRAD_EDGE = ["Nq127-Nk63 D40", "Nq129-Nk65 D80 causal", "GQA16/8 causal Nq<Nk",
             "window edges in a tile", "kv_valid_len 65 of 77"]


@pytest.mark.parametrize("case", GRAD_EDGE)
def test_bwd_reference_at_edge_shapes_matches_jax(case):
    """bwd_reference (fed the port's forward LSE and Δ) against jax.vjp of
    the JAX flash_attention, its Pallas K3 in interpret mode: dQ, and dK /
    dV summed over each KV head's query heads (as _FlashCore sums the
    kernel's per-query-head rows); keys past kv_valid_len get exactly 0."""
    (B, Hq, Hkv, Nq, Nk, D, valid), opts, _ = _edge_kwargs(case)
    q, k, v = make_qkv(85, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(86, B, Hq, Nq, D)[0]
    kw = dict(scale=D ** -0.5, kv_valid_len=valid, **opts)
    o, lse = flash_fwd.fwd_reference(q, k, v, **kw)
    dq, dk, dv = flash_bwd_fused.bwd_reference(q, k, v, do, lse, (do * o).sum(-1), **kw)
    dk, dv = (x.view(B, Hkv, Hq // Hkv, Nk, D).sum(2) for x in (dk, dv))
    _, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(a, b, c, **opts),
                     *_jx(q, k[:, :, :valid], v[:, :, :valid]))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk[:, :, :valid], want[1], tol, "dk")
    assert_close(dv[:, :, :valid], want[2], tol, "dv")
    assert (dk[:, :, valid:] == 0).all() and (dv[:, :, valid:] == 0).all()
