"""K1's bias route -- the rule that sends a dense call with a bias to the
Hopper bias kernel (``bias_route``), its plain version (``fwd_reference``,
K1's own) at the route's shapes, and the packing of the kernel's C arguments
-- against the JAX package on CPU.

The kernel itself runs only on the card (``python3 chip_smoke.py`` holds it
against ``fwd_reference`` there). Here the same numpy inputs go through
``fwd_reference`` and the JAX ``flash_attention_with_lse`` (Pallas in
interpret mode, as the JAX package's tests run it); budget FWD_TOL[f32]
(1e-4 abs + 1e-4 rel) for f32 queries, as test_torch_bias.py holds them. A
kv_valid_len below Nk is given to JAX as K / V and the bias cut to their
first kv_valid_len keys, which is what the port's kv_valid_len means.
"""

import ctypes
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
from flashattn_tpu_torch.integrations import (
    FlashMultiHeadDotProductAttention,
    make_attention_mask,
)
from flashattn_tpu_torch.ops import flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close, make_qkv

N = 2048  # path A's sequence


def _route(rows=N, causal=False, segment_ids=None, window=None, head_dim=128,
           bias_shape=(4, 1, N, N), kv_dtype=torch.bfloat16):
    # A meta tensor: the rule reads the bias's shape only.
    bias = None if bias_shape is None else torch.empty(bias_shape, device="meta")
    return flash_fwd.bias_route(rows=rows, causal=causal, segment_ids=segment_ids,
                                window=window, head_dim=head_dim, bias=bias, kv_dtype=kv_dtype)


# The calls the route takes: path A's attention (B4 H16 N2048 D128 with the
# mask arm's [4, 1, N, N] and the learned arm's [4, 16, N, N] bias), the
# causal LM with GQA (Hq16 / Hkv8: 2 x N folded rows) and a learned
# [1, 16, N, N] bias, D 64, D 40 and 96 (run in the D 64 / 128 boxes), a
# row-broadcast [B, 1, 1, Nk] key mask, a ragged Nq of 1000 against Nk 2048,
# an Nk that is not a multiple of 4 (the wrapper pads such a bias's rows
# to 16 bytes: sm90_bias), segment ids and a window (a decode-shaped call
# with a window too: the decode route takes no band). The softcap and the
# offsets are not the rule's to read: every such call with a bias takes it
# too.
ROUTE_TAKES = {"path A mask": {}, "path A learned": dict(bias_shape=(4, 16, N, N)),
               "causal GQA": dict(rows=2 * N, causal=True, bias_shape=(1, 16, N, N)),
               "D 64": dict(head_dim=64, bias_shape=(2, 1, 1536, 1536)),
               "D 40": dict(head_dim=40), "D 96": dict(head_dim=96),
               "row-broadcast": dict(bias_shape=(4, 1, 1, N)),
               "ragged Nq": dict(rows=1000, causal=True, bias_shape=(2, 16, 1000, N)),
               "empty window": dict(window=(-1, -1)),
               "Nk 2047": dict(bias_shape=(4, 1, N, N - 1)),
               "Nk 2046": dict(bias_shape=(4, 1, 1, N - 2)),
               "segment ids": dict(segment_ids=(torch.zeros(4, N), torch.zeros(4, N))),
               "window": dict(window=(128, -1)),
               "decode-shaped with a window": dict(rows=2, window=(256, 256),
                                                   bias_shape=(8, 1, 1, 8192)),
               "D 136": dict(head_dim=136), "D 256": dict(head_dim=256),
               "decode-shaped D 256": dict(rows=2, head_dim=256, bias_shape=(8, 1, 1, 8192))}
# Those it refuses: no bias, quantized K/V, a head dim above 256, and the
# decode-shaped calls at D 64 / 128 (the decode route's, checked first).
ROUTE_REFUSES = {"no bias": dict(bias_shape=None),
                 "int8 K/V": dict(kv_dtype=torch.int8),
                 "fp8 K/V": dict(kv_dtype=torch.float8_e4m3fn),
                 "D 264": dict(head_dim=264),
                 "decode-shaped": dict(rows=2, bias_shape=(8, 1, 1, 8192))}


@pytest.mark.parametrize("case", list(ROUTE_TAKES))
def test_bias_route_takes(case):
    assert _route(**ROUTE_TAKES[case])


@pytest.mark.parametrize("case", list(ROUTE_REFUSES))
def test_bias_route_refuses(case):
    assert not _route(**ROUTE_REFUSES[case])


def test_decode_route_comes_first():
    """A decode-shaped call with a bias is the decode kernel's, one row more
    than its bound the bias kernel's."""
    rows = flash_fwd.DECODE_MAX_ROWS
    kw = dict(causal=False, segment_ids=None, window=None, head_dim=128)
    assert flash_fwd.decode_route(rows=rows, **kw)
    assert not _route(rows=rows, bias_shape=(8, 1, 1, 8192))
    assert _route(rows=rows + 1, bias_shape=(8, 1, 1, 8192))


@pytest.mark.parametrize("arm", ["mask", "learned"])
def test_bias_route_takes_every_call_of_the_attention_module(arm, monkeypatch):
    """Every K1 call that FlashMultiHeadDotProductAttention's forward makes on
    path A (a key-padding mask, and the mask plus a learned [1, H, N, N] bias)
    at a small width -- 2 heads of 64 in bf16, N 64 -- is one that the bias
    route takes."""
    calls = []
    real = flash_fwd.fwd

    def spy(q, k, v, **kw):
        calls.append(flash_fwd.bias_route(
            rows=q.shape[1] // k.shape[1] * q.shape[2], causal=kw.get("causal", False),
            segment_ids=kw.get("segment_ids"), window=kw.get("window"), head_dim=q.shape[-1],
            bias=kw.get("bias"), kv_dtype=k.dtype))
        return real(q, k, v, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", spy)
    B, L, H, F = 2, 64, 2, 128
    module = FlashMultiHeadDotProductAttention(H, F, impl="fused", dtype=torch.bfloat16,
                                               device="cpu",
                                               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(40).standard_normal((B, L, F), dtype=np.float32))
    valid = torch.arange(L)[None] < torch.tensor([L, 40])[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    rel = None
    if arm == "learned":
        rel = torch.from_numpy(np.random.default_rng(41).standard_normal((1, H, L, L),
                                                                        dtype=np.float32))
        rel.requires_grad_(True)
    for _ in range(2):
        module(x.to(torch.bfloat16), mask=mask, bias=rel)
    assert calls == [True, True]


def _padding(lengths, n):
    keep = np.arange(n)[None] < np.asarray(lengths)[:, None]
    pair = keep[:, None, :, None] & keep[:, None, None, :]
    return np.where(pair, 0.0, DEFAULT_MASK_VALUE).astype(np.float32)


# (B, Hq, Hkv, Nq, Nk, D, kv_valid_len, causal, bias kind): the route's shape
# families cut to size -- path A's key-padding bias with dead rows and its
# learned [B, H, N, N] arm, the causal LM with GQA and a [1, Hq, N, N] bias, a
# [B, 1, 1, Nk] key mask, a ragged Nq with kv_valid_len < Nk at D 128.
REF_CASES = {"padding": (2, 2, 2, 64, 64, 64, 64, False, "padding"),
             "learned": (2, 2, 2, 64, 64, 64, 64, False, "full"),
             "causal GQA": (1, 4, 2, 64, 64, 128, 64, True, "heads"),
             "keys": (2, 2, 2, 64, 64, 64, 64, False, "keys"),
             "ragged": (1, 2, 1, 40, 64, 128, 48, True, "full")}


def _ref_bias(kind, B, Hq, Nq, Nk, rng):
    if kind == "padding":
        return _padding([Nq, Nq * 5 // 8], Nq)
    if kind == "keys":
        bias = rng.standard_normal((B, 1, 1, Nk), dtype=np.float32)
        bias[1, ..., Nk - 16:] = DEFAULT_MASK_VALUE
        return bias
    return rng.standard_normal((B if kind == "full" else 1, Hq, Nq, Nk), dtype=np.float32)


@pytest.mark.parametrize("case", list(REF_CASES))
def test_fwd_reference_at_route_shapes_matches_jax(case):
    """K1's plain version, the bias kernel's, against the JAX forward with
    its LSE (dead rows included: O = 0, LSE = ln2 x mask)."""
    B, Hq, Hkv, Nq, Nk, D, valid, causal, kind = REF_CASES[case]
    q, k, v = make_qkv(42, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    bias = _ref_bias(kind, B, Hq, Nq, Nk, np.random.default_rng(43))
    assert _route(rows=Hq // Hkv * Nq, causal=causal, head_dim=D, bias_shape=bias.shape)
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=D ** -0.5, kv_valid_len=valid,
                                     causal=causal, bias=torch.from_numpy(bias))
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        jnp.asarray(q.numpy()), jnp.asarray(k[:, :, :valid].numpy()),
        jnp.asarray(v[:, :, :valid].numpy()), bias=jnp.asarray(bias[..., :valid]),
        causal=causal)
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")
    if kind == "padding":
        dead = lse <= 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
        assert dead.any() and (o[dead] == 0).all()


def _fake_library():
    """A stand-in for the kernel library: a ctypes function with the C
    entry's argument types, so ctypes converts the arguments as it would for
    the real ``fa_fwd_bias_sm90``, and records what it receives."""
    seen = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *native.FWD_BIAS_SM90_ARGTYPES)
    fn = proto(lambda *args: seen.append(args) or 0)
    return types.SimpleNamespace(fa_fwd_bias_sm90=fn), seen


@pytest.mark.parametrize("causal", [False, True])
def test_launch_packs_the_c_arguments(causal):
    """The wrapper's call of fa_fwd_bias_sm90 on BNHD views with GQA and a
    [B, 1, 1, Nk] bias: every pointer (no segment ids), dim, the band
    (causal, no window, no offsets), stride (the bias's 0 on its broadcast
    dims), the scale and the stream in the C entry's order."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 128, 64
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16)
               for x in make_qkv(44, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Nq), dtype=torch.float32)
    bias, strides = flash_fwd.kernel_bias(torch.zeros((B, 1, 1, Nk)))
    lib, seen = _fake_library()
    rc = flash_fwd._launch_bias_sm90(lib, q, k, v, o, lse, bias, strides, None, scale=0.125,
                                     kv_valid_len=100, causal=causal, window=None,
                                     softcap=None, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0]
    assert len(args) == len(native.FWD_BIAS_SM90_ARGTYPES) == 40
    assert args[:6] == tuple(x.data_ptr() for x in (q, k, v, o, lse, bias))
    assert args[6:10] == (None,) * 4  # no segment ids
    assert args[10:21] == (B, Hq, Hkv, Nq, D, 100, int(causal), -1, -1, 0, 0)
    assert args[21:23] == (0.125, 0.0)  # the scale, no softcap
    assert args[23:26] == (Nq * Hq * D, D, Hq * D)  # q: BNHD, (batch, head, seq)
    assert args[26:29] == (Nk * Hkv * D, D, Hkv * D)
    assert args[29:32] == args[26:29] and args[32:35] == args[23:26]
    assert args[35:38] == (Nk, 0, 0)  # bias [B, 1, 1, Nk]: head and row broadcast
    assert args[38:40] == (0, 4096)  # no seg_q stride, the stream


def test_tma_ready_copies_only_what_a_tensor_map_cannot_address():
    """An aligned BNHD view is passed as it is; a head-expanded view (stride 0
    on a dim of extent 2) and a view whose rows are not 16-byte aligned are
    copied."""
    x = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert flash_fwd._kernel_ready(x, tma=True) is x
    expanded = torch.zeros((2, 1, 16, 64), dtype=torch.bfloat16).expand(2, 2, 16, 64)
    assert flash_fwd._kernel_ready(expanded) is expanded
    assert flash_fwd._kernel_ready(expanded, tma=True).stride() == (2048, 1024, 64, 1)
    ragged = torch.zeros((2, 2, 16, 68), dtype=torch.bfloat16)[..., :64]
    assert flash_fwd._kernel_ready(ragged, tma=True).is_contiguous()


# (bias, the strides the kernel gets, whether it is read in place): an aligned
# [B, 1, N, N] and [B, 1, 1, Nk] bias as they are; Nk 2047 and 2046 padded to
# 2048-float rows; a row view of a wider bias whose stride (2050) is not a
# multiple of 4; a bf16 bias cast to f32 by kernel_bias, already aligned.
SM90_BIAS = {"aligned": ((2, 1, 64, 64), None, (4096, 0, 64), True),
             "row-broadcast": ((2, 1, 1, 64), None, (64, 0, 0), True),
             "Nk 2047": ((2, 1, 8, 2047), None, (8 * 2048, 0, 2048), False),
             "Nk 2046 row-broadcast": ((2, 1, 1, 2046), None, (2048, 0, 0), False),
             "row view": ((2, 1, 8, 2050), 2048, (8 * 2048, 0, 2048), False),
             "bf16": ((2, 2, 8, 64), None, (1024, 512, 64), True)}


@pytest.mark.parametrize("case", list(SM90_BIAS))
def test_sm90_bias_pads_rows_to_16_bytes(case):
    """The bias kernel's bias: f32, 16-byte-aligned address and strides, the
    same values in its first Nk columns (zeros past them in a padded copy)."""
    shape, cut, strides, in_place = SM90_BIAS[case]
    x = torch.from_numpy(np.random.default_rng(46).standard_normal(shape, dtype=np.float32))
    if case == "bf16":
        x = x.to(torch.bfloat16)
    if cut is not None:
        x = x[..., :cut]
    got, got_strides = flash_fwd.sm90_bias(x)
    assert got_strides == strides and got.dtype == torch.float32
    assert got.data_ptr() % 16 == 0 and all(s % flash_fwd.BIAS_ROW_ALIGN == 0 for s in strides)
    assert torch.equal(got, x.float())
    assert (got.data_ptr() == x.data_ptr()) == (in_place and x.dtype == torch.float32)
    if not in_place:
        row = got.untyped_storage().nbytes() // 4 // math.prod(shape[:-1])
        assert row % flash_fwd.BIAS_ROW_ALIGN == 0
        padded = torch.tensor([], dtype=torch.float32).set_(got.untyped_storage()).view(
            *shape[:-1], row)
        assert (padded[..., got.shape[-1]:] == 0).all()


def test_cpu_fwd_takes_the_plain_version_not_the_bias_kernel():
    """On CPU tensors a call the route takes runs fwd_reference: no launch."""
    q, k, v = (x.to(torch.bfloat16) for x in make_qkv(45, 2, 2, 64, 64, Nk=64))
    bias = torch.from_numpy(_padding([64, 30], 64))
    before = (flash_fwd.fwd.launches, flash_fwd.fwd.launches_bias,
              flash_fwd.fwd.launches_bias_sm90)
    o, lse = flash_fwd.fwd(q, k, v, scale=0.125, bias=bias)
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, scale=0.125, bias=bias)
    assert torch.equal(o, o_want) and torch.equal(lse, lse_want)
    assert (flash_fwd.fwd.launches, flash_fwd.fwd.launches_bias,
            flash_fwd.fwd.launches_bias_sm90) == before
