"""K5 + K6 without a bias as one Hopper launch (``flash_bwd.split_bwd``) -- the
rule that sends a backward to it (``split_sm90_route``, the third branch of
``_FlashCore.backward``), the packing of its C entry's arguments, the routing
of ``_FlashCore.backward`` on a simulated card, the id ranges of its 64-row Q
tiles and 128-key KV tiles, and its plain version -- against the JAX package
on CPU.

The kernel runs only on the card (``python3 chip_smoke.py`` holds it against
``split_bwd_reference`` there, in ``phase_seg_check`` and
``phase_window_check``). On a "simulated card" the wrappers get meta tensors
(shapes and strides without data), their device checks are switched off and
a stand-in library records every C entry they call, so the route each call
takes is seen without a GPU. The plain version is held against ``jax.vjp``
of the JAX ``flash_attention``, whose Pallas K1, K5 and K6 run in interpret
mode, as the JAX package's own tests run them, on the same numpy inputs:
budget BWD_TOL[f32] (1e-3 abs + 5e-4 rel). A kv_valid_len below Nk is given
to JAX as K / V (and their ids) cut to their first kv_valid_len keys.
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
from flashattn_tpu_torch.utils.testing import BWD_TOL, assert_close, make_qkv

IDS = torch.zeros((1, 8), dtype=torch.int32)


def _route(head_dim=128, bias=None, dtype=torch.bfloat16, segment_ids=(IDS, IDS),
           softcap=None):
    return flash_bwd.split_sm90_route(head_dim=head_dim, bias=bias, dtype=dtype,
                                      segment_ids=segment_ids, softcap=softcap)


# The backwards it takes: bf16 or f32 without a bias, segment ids and / or a
# softcap, at the LM's D 128 and the head dims run in a wider box (8, 40,
# 96; in bf16 136 and 160, in the D 256 form); causal, a window and the
# tails are not its test (the kernel takes every one).
ROUTE_TAKES = {"packed D 128": {}, "softcap": dict(segment_ids=None, softcap=50.0),
               "ids + softcap": dict(softcap=5.0), "D 40": dict(head_dim=40),
               "D 8": dict(head_dim=8), "D 96 softcap": dict(head_dim=96, segment_ids=None,
                                                            softcap=30.0),
               "f32": dict(dtype=torch.float32),
               "D 136": dict(head_dim=136), "D 160 softcap": dict(head_dim=160, softcap=5.0),
               "f32 D 136": dict(head_dim=136, dtype=torch.float32)}
# Those it refuses: K3's (neither option), the bias calls (the bias route),
# head dims above 256 (in f32 too: f32 takes D 136-256 since its D 256
# form), fp16.
ROUTE_REFUSES = {"neither": dict(segment_ids=None),
                 "bias + softcap": dict(segment_ids=None, softcap=50.0,
                                        bias=torch.empty((1, 1, 1, 8), device="meta")),
                 "bias": dict(bias=torch.empty((1, 1, 1, 8), device="meta")),
                 "D 264": dict(head_dim=264), "f32 D 264": dict(head_dim=264,
                                                                dtype=torch.float32),
                 "fp16": dict(dtype=torch.float16)}


@pytest.mark.parametrize("case", list(ROUTE_TAKES))
def test_split_route_takes(case):
    assert _route(**ROUTE_TAKES[case])


@pytest.mark.parametrize("case", list(ROUTE_REFUSES))
def test_split_route_refuses(case):
    assert not _route(**ROUTE_REFUSES[case])


# ---------------------------------------------------------------------------
# The C entry's argument packing, through a ctypes stand-in with its argtypes.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


def _bnhd(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16) for x in xs)


@pytest.mark.parametrize("segments", [False, True])
def test_split_launch_packs_the_c_arguments(segments):
    """fa_bwd_split_sm90 on BNHD views with GQA, a window, the softcap and
    (or not) segment ids: every pointer (the four segment inputs null
    without them), dim, the window as the C entry's (wl, wr), the LSE rows'
    pitch, the scale and the cap, every stride and the stream, in the C
    entry's order."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 300, 80
    q, k, v = _bnhd(*make_qkv(90, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 128))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hq, Nk, D)), torch.empty((B, Hq, Nk, D))
    ids = (torch.arange(Nq).repeat(B, 1) // 50, torch.arange(Nk).repeat(B, 1) // 50)
    seg = flash_fwd.sm90_segments(ids, Nq, 290, q_tile=64, kv_tile=128,
                                  pad_q=True) if segments else None
    seen = []
    lib = types.SimpleNamespace(fa_bwd_split_sm90=_recorder(
        "fa_bwd_split_sm90", native.BWD_SPLIT_SM90_ARGTYPES, seen))
    rc = flash_bwd._launch_split(lib, q, k, v, do, stats, stats, dq, dk, dv, seg, scale=0.25,
                                 causal=True, kv_valid_len=290, window=(64, 7), softcap=30.0,
                                 nq_pad=128, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.BWD_SPLIT_SM90_ARGTYPES) == 41
    assert args[:9] == tuple(x.data_ptr() for x in (q, k, v, do, stats, stats, dq, dk, dv))
    assert args[9:13] == ((None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg))
    assert args[13:23] == (B, Hq, Hkv, Nq, Nk, D, 290, 1, 64, 7)
    assert args[23:26] == (0, 0, 128)  # no offsets, the LSE rows' pitch
    assert args[26:28] == (0.25, 30.0)
    assert args[28:31] == (Nq * Hq * D, D, Hq * D)  # q: BNHD, (batch, head, seq)
    assert args[31:34] == (Nk * Hkv * D, D, Hkv * D)
    assert args[34:37] == args[31:34] and args[37:40] == args[28:31]
    assert args[40] == 4096
    if segments:  # the ids in rows of whole tiles, one range per tile
        assert seg[0].shape == (B, 128) and seg[1].shape == (B, 384)
        assert seg[2].shape == (B, 2, 2) and seg[3].shape == (B, 3, 2)
        assert seg[0].is_contiguous() and seg[1].is_contiguous()


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
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    for name in ("fa_fwd_quant_sm90", "fa_decode"):
        setattr(lib, name, lambda *args, name=name: calls.append((name, args)) or 0)
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta_qkv(B, Hq, Hkv, Nq, Nk, D):
    q = torch.empty((B, Nq, Hq, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


# (Nq, Nk, D, options, the C entries of the forward and the backward): the
# packed LM, tuple ids with Nq != Nk, ids with a window, the softcap alone,
# with a window (the soft-capped SWA path) and with ids all take the split
# route (behind K1's dense route, the cap's too); neither option takes K3; a
# bias goes to the bias routes, a capped bias and a D 96 bias too.
SPLIT = "fa_bwd_split_sm90"
GRAD_CASES = {
    "packed": (300, 300, 64, dict(causal=True, segment_ids="one"), ["fa_fwd_sm90", SPLIT]),
    "tuple ids Nq != Nk": (200, 330, 64, dict(segment_ids="tuple"), ["fa_fwd_sm90", SPLIT]),
    "ids + window": (300, 300, 128, dict(causal=True, window=(100, -1), segment_ids="one"),
                     ["fa_fwd_sm90", SPLIT]),
    "softcap": (300, 300, 64, dict(causal=True, logit_softcap=50.0), ["fa_fwd_sm90", SPLIT]),
    "softcap + window": (300, 300, 128, dict(causal=True, window=(100, -1),
                                             logit_softcap=50.0), ["fa_fwd_sm90", SPLIT]),
    "softcap + ids": (300, 300, 40, dict(segment_ids="one", logit_softcap=30.0),
                      ["fa_fwd_sm90", SPLIT]),
    "neither": (300, 300, 64, dict(causal=True), ["fa_fwd_sm90", "fa_bwd_sm90"]),
    "bias route": (300, 300, 64, dict(bias=True), ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
    "capped bias": (300, 300, 64, dict(bias=True, logit_softcap=50.0),
                    ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
    "D 96 bias": (300, 300, 96, dict(bias=True), ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_flash_core_routes_the_split_backward(card, case):
    Nq, Nk, D, opts, entries = GRAD_CASES[case]
    B, Hq, Hkv = 2, 8, 4
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(B, Hq, Hkv, Nq, Nk, D))
    kw = dict(opts)
    ids = kw.pop("segment_ids", None)
    if ids == "one":
        kw["segment_ids"] = torch.zeros((B, Nq), dtype=torch.int32, device="meta")
    elif ids == "tuple":
        kw["segment_ids"] = tuple(torch.zeros((B, n), dtype=torch.int32, device="meta")
                                  for n in (Nq, Nk))
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros((1, 1, 1, Nk), device="meta")
    before = flash_bwd.split_bwd.launches
    o = flashattn_tpu_torch.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [name for name, _ in card] == entries
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    split = SPLIT in entries
    assert flash_bwd.split_bwd.launches == before + split
    if split:
        args = card[1][1]
        assert args[25] == -(-Nq // 64) * 64  # the LSE / Δ rows padded to 64
        assert args[27] == kw.get("logit_softcap", 0.0)
        assert args[20:23] == (int(kw.get("causal", False)),
                               *flash_fwd.kernel_window(kw.get("window")))


def test_split_bwd_without_keys_launches_nothing(card):
    """kv_valid_len 0: every row is dead, so dQ / dK / dV are zero and no
    kernel is launched (an empty grid is not a valid launch)."""
    q, k, v = _meta_qkv(1, 2, 2, 100, 100, 64)
    lse = torch.empty((1, 2, 100), device="meta")
    ids = (torch.zeros((1, 100), dtype=torch.int32, device="meta"),) * 2
    before = flash_bwd.split_bwd.launches
    dq, dk, dv = flash_bwd.split_bwd(q, k, v, q, lse, lse, scale=0.1, kv_valid_len=0,
                                     segment_ids=ids)
    assert card == [] and flash_bwd.split_bwd.launches == before
    assert dq.shape == q.shape and dk.shape == (1, 2, 100, 64) and dv.shape == dk.shape


def test_split_bwd_refuses_too_many_q_tiles(card):
    """With segment ids the kernel's list of visited Q tiles holds
    SPLIT_MAX_Q_TILES: a longer Nq raises before any launch."""
    nq = flash_bwd.SM90_BWD_Q_TILE * flash_bwd.SPLIT_MAX_Q_TILES + 1
    q, k, v = _meta_qkv(1, 1, 1, nq, 64, 64)
    lse = torch.empty((1, 1, nq), device="meta")
    ids = (torch.zeros((1, nq), dtype=torch.int32, device="meta"),
           torch.zeros((1, 64), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="Q tiles"):
        flash_bwd.split_bwd(q, k, v, q, lse, lse, scale=0.1, segment_ids=ids)
    assert card == []


@pytest.mark.parametrize("fn", ["dkv", "dq"])
def test_split_kernels_without_a_bias_name_the_route(card, fn):
    """On the card K5 and K6 keep only the bias calls: without a bias they
    raise NotImplementedError naming split_bwd, and launch nothing."""
    q, k, v = _meta_qkv(1, 2, 2, 64, 64, 64)
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match="split_bwd"):
        getattr(flash_bwd, fn)(q, k, v, q, lse, lse, scale=0.1, softcap=50.0)
    assert card == []


def test_split_bwd_needs_an_option():
    q, k, v = make_qkv(91, 1, 2, 64, 32)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="segment ids or a softcap"):
        flash_bwd.split_bwd(q, k, v, q, lse, lse, scale=0.1)


def test_split_bwd_takes_no_plain_path_off_the_cpu():
    """Only a CPU tensor runs the plain version: a tensor on another device
    (here the meta device) gets no silent fallback."""
    q = torch.empty(1, 2, 64, 40, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        flash_bwd.split_bwd(q, q, q, q, lse, lse, scale=0.1, softcap=5.0)


def test_cpu_split_calls_never_reach_a_kernel(monkeypatch):
    """bf16 CPU tensors with segment ids and the cap take the split route's
    branch of _FlashCore.backward, and its plain version: no library, no
    launch counted."""
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(native, "kernels", no_library)
    calls = []
    real = flash_bwd.split_bwd
    monkeypatch.setattr(flash_bwd, "split_bwd",
                        lambda *a, **kw: calls.append(kw.get("softcap")) or real(*a, **kw))
    before = real.launches
    q, k, v = (x.to(torch.bfloat16).requires_grad_(True)
               for x in make_qkv(92, 1, 4, 130, 40, Hkv=2))
    ids = torch.arange(130)[None] // 50
    o = flashattn_tpu_torch.flash_attention(q, k, v, causal=True, segment_ids=ids,
                                            logit_softcap=5.0)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert calls == [5.0] and real.launches == before
    assert all(torch.isfinite(g.float()).all() for g in grads)


# ---------------------------------------------------------------------------
# The id ranges of the kernel's tiles against the JAX package's block flags.


def _packed(n, doc):
    return np.arange(n) // doc


def _ids(kind, n, rng):
    if kind == "packed aligned":
        return np.stack([_packed(n, 128), _packed(n, 256)])
    if kind == "packed across edges":  # documents of 45 and 200 tokens
        return np.stack([_packed(n, 45), _packed(n, 200)])
    return np.cumsum(rng.random((2, n)) < 6 / n, axis=1)  # random boundaries


def _split_flags(q_ids, kv_ids, nq, nkv):
    """The (run, full) flags of each (64-row Q tile, 128-key KV tile) pair
    that the kernel's list keeps from the wrapper's ranges."""
    seg = flash_fwd.sm90_segments((torch.from_numpy(q_ids).int(), torch.from_numpy(kv_ids).int()),
                                  nq, nkv, q_tile=flash_bwd.SM90_BWD_Q_TILE,
                                  kv_tile=flash_bwd.SM90_BWD_KV_TILE, pad_q=True)
    qr, kr = seg[2], seg[3]
    run = (qr[:, :, None, 0] <= kr[:, None, :, 1]) & (kr[:, None, :, 0] <= qr[:, :, None, 1])
    full = ((qr[:, :, None, 0] == qr[:, :, None, 1]) & (kr[:, None, :, 0] == kr[:, None, :, 1])
            & (qr[:, :, None, 0] == kr[:, None, :, 0]))
    return run.numpy(), full.numpy()


@pytest.mark.parametrize("kind", ["packed aligned", "packed across edges", "random"])
def test_split_tile_ranges_match_jax_block_flags(kind):
    """On whole tiles (Nq 1024, Nk 768), the ranges' run / full flags are
    exactly those of _seg_block_flags (flashattn_tpu/ops/flash.py:312) at
    block_q 64 and block_k 128, the kernel's tiles."""
    rng = np.random.default_rng(93)
    q_ids = _ids(kind, 1024, rng)
    kv_ids = q_ids[:, :768] if kind != "random" else _ids(kind, 768, rng)
    run, full = _split_flags(q_ids, kv_ids, 1024, 768)
    flags = np.asarray(_seg_block_flags(jnp.asarray(q_ids, jnp.int32),
                                        jnp.asarray(kv_ids, jnp.int32), 64, 128))
    np.testing.assert_array_equal(run, flags[:, 0].astype(bool))
    np.testing.assert_array_equal(full, flags[:, 1].astype(bool))
    assert run.any() and not run.all()


def test_split_tile_ranges_on_ragged_tiles_are_conservative():
    """On ragged tails (Nq 300, kv_valid_len 200 of Nk 250), a tile pair the
    ranges skip holds no pair of equal ids among the rows below Nq and the
    keys below kv_valid_len, every pair they keep is one that the JAX flags
    (on the ids padded with their -1 / -2 sentinels) keep too, and the padded
    id rows repeat the last id."""
    q_ids, kv_ids = _packed(300, 45)[None], _packed(250, 70)[None]
    run, _ = _split_flags(q_ids, kv_ids, 300, 200)
    pad_q = np.pad(q_ids, ((0, 0), (0, 20)), constant_values=-1)
    pad_k = np.pad(kv_ids[:, :200], ((0, 0), (0, 56)), constant_values=-2)
    flags = np.asarray(_seg_block_flags(jnp.asarray(pad_q, jnp.int32),
                                        jnp.asarray(pad_k, jnp.int32), 64, 128))
    assert run.shape == (1, 5, 2) and not (run & ~flags[:, 0].astype(bool)).any()
    for i in range(5):
        for j in range(2):
            qs = q_ids[0, 64 * i:min(300, 64 * i + 64)]
            ks = kv_ids[0, 128 * j:min(200, 128 * j + 128)]
            assert run[0, i, j] == np.isin(qs, ks).any()
    seg = flash_fwd.sm90_segments((torch.from_numpy(q_ids).int(), torch.from_numpy(kv_ids).int()),
                                  300, 200, q_tile=64, kv_tile=128, pad_q=True)
    assert seg[0].shape == (1, 320) and (seg[0][0, 300:] == int(q_ids[0, -1])).all()
    assert seg[1].shape == (1, 256) and (seg[1][0, 200:] == int(kv_ids[0, 199])).all()


# ---------------------------------------------------------------------------
# The plain version against jax.vjp of the JAX flash_attention.


def _jx(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


def _case_ids(kind, B, Nq, Nk, rng):
    """(q_ids, kv_ids) numpy int32: random contiguous documents (one array
    when Nq == Nk), independent random documents on each side, or the dead
    rows of tests/test_segments.py (query rows of a segment no key carries)."""
    if kind is None:
        return None
    if kind == "random":
        ids = np.cumsum(rng.random((B, max(Nq, Nk))) < 4 / Nq, axis=1).astype(np.int32)
        return ids[:, :Nq], ids[:, :Nk]
    if kind == "tuple":
        return tuple(np.cumsum(rng.random((B, n)) < 4 / n, axis=1).astype(np.int32)
                     for n in (Nq, Nk))
    seg_q = np.zeros((B, Nq), np.int32)
    seg_q[:, Nq // 2:] = 7
    return seg_q, np.zeros((B, Nk), np.int32)


# (B, Hq, Hkv, Nq, Nk, D, kv_valid_len, ids, options): ragged tiles on both
# sides (Nq 127 / 129, Nk 65 / 77), head dims run in a wider box (40, 96) and
# D 64, GQA 4/2; random, tuple and dead-row ids; the cap at 5.0 (small enough
# that its Jacobian matters), alone, with a window, with ids, with both.
CAP = 5.0
PLAIN_CASES = {
    "random ids Nq127 D40 GQA causal": (2, 4, 2, 127, 127, 40, 127, "random",
                                        dict(causal=True)),
    "random ids Nq129 D64": (1, 2, 2, 129, 129, 64, 129, "random", {}),
    "tuple ids Nq129 Nk77 D96": (2, 4, 2, 129, 77, 96, 77, "tuple", {}),
    "tuple ids Nq127 Nk65 causal kv_valid_len 60": (1, 4, 2, 127, 65, 64, 60, "tuple",
                                                    dict(causal=True)),
    "dead rows Nq129 Nk65 D40": (1, 2, 2, 129, 65, 40, 65, "dead", {}),
    "ids + window": (2, 2, 2, 129, 129, 64, 129, "random", dict(window=(37, 5))),
    "cap Nq127 Nk65 D40 causal": (1, 4, 2, 127, 65, 40, 65, None, dict(causal=True,
                                                                      softcap=CAP)),
    "cap + window GQA D64": (1, 4, 2, 129, 129, 64, 129, None,
                             dict(causal=True, window=(40, -1), softcap=CAP)),
    "cap + tuple ids D96": (1, 2, 2, 129, 77, 96, 77, "tuple", dict(softcap=CAP)),
    "cap + ids + window GQA": (2, 4, 2, 127, 127, 64, 127, "random",
                               dict(causal=True, window=(50, -1), softcap=CAP)),
}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_split_bwd_reference_matches_jax(case):
    """split_bwd_reference (fed the port's forward LSE and Δ) against jax.vjp
    of the JAX flash_attention (its Pallas K1, K5 and K6 in interpret mode):
    dQ, and dK / dV summed over each KV head's query heads (as _FlashCore
    sums the kernel's per-query-head rows); keys past kv_valid_len get
    exactly 0, and a dead row's dQ too."""
    B, Hq, Hkv, Nq, Nk, D, valid, kind, opts = PLAIN_CASES[case]
    rng = np.random.default_rng(94)
    q, k, v = make_qkv(95, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    q, k = 3 * q, 3 * k  # peaked rows: the cap's tanh leaves its linear range
    do = make_qkv(96, B, Hq, Nq, D)[0]
    ids = _case_ids(kind, B, Nq, Nk, rng)
    softcap = opts.get("softcap")
    mask = {n: opts[n] for n in ("causal", "window") if n in opts}
    kw = dict(scale=D ** -0.5, kv_valid_len=valid, softcap=softcap, **mask,
              segment_ids=None if ids is None else tuple(torch.from_numpy(x) for x in ids))
    o, lse = flash_fwd.fwd_reference(q, k, v, **kw)
    dq, dk, dv = flash_bwd.split_bwd(q, k, v, do, lse, (do * o).sum(-1), **kw)
    assert dk.shape == (B, Hq, Nk, D)
    dk, dv = (x.view(B, Hkv, Hq // Hkv, Nk, D).sum(2) for x in (dk, dv))
    jseg = None if ids is None else _jx(ids[0], ids[1][:, :valid])
    _, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(
        a, b, c, segment_ids=jseg, logit_softcap=softcap, **mask),
        *_jx(q, k[:, :, :valid], v[:, :, :valid]))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk[:, :, :valid], want[1], tol, "dk")
    assert_close(dv[:, :, :valid], want[2], tol, "dv")
    assert (dk[:, :, valid:] == 0).all() and (dv[:, :, valid:] == 0).all()
    dead = lse <= 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
    assert (dq[dead] == 0).all()
    if kind == "dead":
        assert dead.any()
