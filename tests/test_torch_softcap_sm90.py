"""The logit softcap on K1's Hopper routes and every bias on the bias route's
backward -- the plain versions at the new routes' shapes against the JAX
package, the packing of the three C entries' arguments with the cap, and the
routes of ``flash_fwd.fwd`` and ``_FlashCore.backward`` on a simulated card
-- on CPU.

The kernels run only on the card (``python3 chip_smoke.py`` holds them
against ``fwd_reference`` and ``bias_bwd_reference`` there, in
``phase_window_check`` and ``phase_bias_check``). Here the same numpy inputs
go through the port's plain versions and the JAX ``flash_attention`` /
``flash_attention_with_lse``, whose Pallas K1, K5 and K6 run in interpret
mode, as the JAX package's own tests run them. Budgets FWD_TOL[f32] (1e-4
abs + 1e-4 rel) and BWD_TOL[f32] (1e-3 abs + 5e-4 rel). Q and K are scaled
by 3, so that the scores leave the cap's linear range. A kv_valid_len below
Nk is given to JAX as K / V (and the bias and ids) cut to their first
kv_valid_len keys, and the port's gradients past it must be exactly 0.

On the simulated card the wrappers get meta tensors (shapes and strides
without data), their device checks are switched off and a stand-in library
records every C entry they call, so the route each call takes is seen
without a GPU.
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
from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

CAP = 5.0  # small enough that the scaled scores saturate its tanh


def _jx(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


def _bias(kind, B, Hq, Nq, Nk, rng):
    """A numpy f32 bias: "full" [B, Hq, Nq, Nk], "heads" [1, Hq, Nq, Nk],
    "rows" [B, 1, Nq, Nk], "keys" [B, 1, 1, Nk] with batch row 1's last 16
    keys at the mask value."""
    if kind == "keys":
        bias = rng.standard_normal((B, 1, 1, Nk), dtype=np.float32)
        bias[1, ..., Nk - 16:] = DEFAULT_MASK_VALUE
        return bias
    shape = {"full": (B, Hq, Nq, Nk), "heads": (1, Hq, Nq, Nk), "rows": (B, 1, Nq, Nk)}[kind]
    return rng.standard_normal(shape, dtype=np.float32)


def _reduce_to(dbias, shape):
    dims = tuple(d for d in range(3) if shape[d] == 1 and dbias.shape[d] != 1)
    return dbias.sum(dim=dims, keepdim=True) if dims else dbias


# ---------------------------------------------------------------------------
# bias_bwd_reference with the cap against jax.vjp of the JAX flash_attention.

# (B, Hq, Hkv, Nq, Nk, D, kv_valid_len, causal, bias kind, cap): ragged tiles
# on both sides (Nq 127 / 129, Nk 63 / 77), the head dims the kernel runs in
# a wider box (40, 96), GQA 4/2, causal and not, a KV tail, every bias
# broadcast; cap 5 on scores scaled by 3 (the cap saturates, so a dbias
# taken after the Jacobian is far off), and cap 30.
BWD_CASES = {
    "Nq127 Nk63 D40 GQA causal": (2, 4, 2, 127, 63, 40, 63, True, "full", CAP),
    "Nq129 Nk77 D96": (1, 2, 2, 129, 77, 96, 77, False, "full", CAP),
    "Nq129 Nk63 D40 GQA heads bias": (1, 4, 2, 129, 63, 40, 63, False, "heads", CAP),
    "Nq127 Nk77 D96 GQA causal kv_valid_len 70": (1, 4, 2, 127, 77, 96, 70, True, "rows", CAP),
    "key mask D64": (2, 2, 2, 64, 77, 64, 77, False, "keys", CAP),
    "cap 30 D128 causal": (1, 2, 1, 129, 129, 128, 129, True, "full", 30.0),
}


def _vjp_case(B, Hq, Hkv, Nq, Nk, D, valid, causal, bias, cap, seed):
    """The port's bias_bwd_reference (dbias wanted, fed its forward's LSE and
    Δ) and jax.vjp's (dQ, dK, dV, dbias) on the same numpy inputs."""
    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    q, k = 3 * q, 3 * k
    do = make_qkv(seed + 1, B, Hq, Nq, D)[0]
    kw = dict(scale=D ** -0.5, causal=causal, kv_valid_len=valid, bias=torch.from_numpy(bias),
              softcap=cap)
    o, lse = flash_fwd.fwd_reference(q, k, v, **kw)
    got = flash_bwd.bias_bwd_reference(q, k, v, do, lse, (do * o).sum(-1), want_dbias=True,
                                       **kw)
    _, vjp = jax.vjp(lambda a, b, c, d: flashattn_tpu.flash_attention(
        a, b, c, bias=d, causal=causal, logit_softcap=cap),
        *_jx(q, k[:, :, :valid], v[:, :, :valid], bias[..., :valid]))
    return got, [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))], lse


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_capped_bias_bwd_reference_matches_jax(case):
    """dQ, dK / dV (per KV head) and dbias (reduced over the bias's
    broadcast dims) against jax.vjp of the JAX flash_attention with the bias
    and the cap (its Pallas K5 / K6 in interpret mode); keys past
    kv_valid_len get exactly 0, a dead row's dQ and dbias too."""
    B, Hq, Hkv, Nq, Nk, D, valid, causal, kind, cap = BWD_CASES[case]
    bias = _bias(kind, B, Hq, Nq, Nk, np.random.default_rng(100))
    (dq, dk, dv, dbias), want, lse = _vjp_case(B, Hq, Hkv, Nq, Nk, D, valid, causal, bias, cap,
                                               101)
    assert dk.shape == (B, Hkv, Nk, D) and dbias.shape == (B, Hq, Nq, Nk)
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk[:, :, :valid], want[1], tol, "dk")
    assert_close(dv[:, :, :valid], want[2], tol, "dv")
    assert_close(_reduce_to(dbias, bias.shape)[..., :valid], want[3], tol, "dbias")
    assert (dk[:, :, valid:] == 0).all() and (dv[:, :, valid:] == 0).all()
    assert (dbias[..., valid:] == 0).all()
    dead = lse <= 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
    assert (dq[dead] == 0).all() and (dbias[dead] == 0).all()


def test_dbias_comes_before_the_jacobian():
    """At cap 5 on scores scaled by 3 the cap saturates: dbias = dL, the
    gradient of the capped logit, matches JAX's, and dL (1 - t^2) -- dbias
    taken after the Jacobian -- is far outside the budget."""
    B, Hq, Hkv, Nq, Nk, D = 1, 2, 2, 129, 77, 96
    bias = _bias("full", B, Hq, Nq, Nk, np.random.default_rng(102))
    q, k, v = make_qkv(103, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    q, k = 3 * q, 3 * k
    (_, _, _, dbias), want, _ = _vjp_case(B, Hq, Hkv, Nq, Nk, D, Nk, False, bias, CAP, 103)
    s = torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5
    jac = 1.0 - torch.tanh(s / CAP) ** 2
    assert (jac < 0.5).float().mean() > 0.2  # the cap bends a fifth of the scores or more
    assert_close(dbias, want[3], BWD_TOL[torch.float32], "dbias")
    tol = BWD_TOL[torch.float32]
    wrong = (dbias * jac).numpy()
    assert (np.abs(wrong - want[3]) > tol.atol + tol.rtol * np.abs(want[3])).any()


def test_decode_fold_bias_bwd_matches_jax():
    """The GQA decode fold's backward (Nq 2, Hq 8, Hkv 2, bias [B, 1, Nq,
    Nk]): bias_bwd_reference on the folded call -- q [B, Hkv, rep * Nq, D],
    the bias's rows repeated per query head -- unfolded (dQ) and with the
    repeated rows summed back (dbias), against jax.vjp of the unfolded JAX
    call."""
    B, Hq, Hkv, Nq, Nk, D = 2, 8, 2, 2, 77, 64
    rep = Hq // Hkv
    bias = _bias("rows", B, Hq, Nq, Nk, np.random.default_rng(104))
    q, k, v = make_qkv(105, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    q, k = 3 * q, 3 * k
    do = make_qkv(106, B, Hq, Nq, D)[0]
    fold = lambda x: x.reshape(B, Hkv, rep * Nq, D)  # noqa: E731
    fbias = torch.from_numpy(bias).repeat(1, 1, rep, 1)
    kw = dict(scale=D ** -0.5, bias=fbias, softcap=CAP)
    o, lse = flash_fwd.fwd_reference(fold(q), k, v, **kw)
    dq, dk, dv, dbias = flash_bwd.bias_bwd_reference(fold(q), k, v, fold(do), lse,
                                                     (fold(do) * o).sum(-1), want_dbias=True,
                                                     **kw)
    dbias = dbias.sum(1, keepdim=True).view(B, 1, rep, Nq, Nk).sum(2)
    _, vjp = jax.vjp(lambda a, b, c, d: flashattn_tpu.flash_attention(
        a, b, c, bias=d, logit_softcap=CAP), *_jx(q, k, v, bias))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    tol = BWD_TOL[torch.float32]
    assert_close(dq.reshape(B, Hq, Nq, D), want[0], tol, "dq")
    assert_close(dk, want[1], tol, "dk")
    assert_close(dv, want[2], tol, "dv")
    assert_close(dbias, want[3], tol, "dbias")


# ---------------------------------------------------------------------------
# fwd_reference with the cap at the new routes' shapes against the JAX K1.


def _packed(n, doc):
    return np.arange(n) // doc


# (B, Hq, Hkv, Nq, Nk, D, kv_valid_len, options): D 40 and 96 (the dense and
# bias instantiations' wider boxes), window edges inside a tile, segment ids
# across the tiles, a ragged Nq, a bias with the cap, causal GQA.
FWD_CASES = {
    "D40 causal GQA": (2, 4, 2, 127, 127, 40, 127, dict(causal=True)),
    "D96 ragged Nq": (1, 2, 2, 129, 77, 96, 77, {}),
    "window edges in a tile": (1, 2, 2, 129, 129, 64, 129, dict(window=(37, 5))),
    "causal window D128": (1, 2, 1, 127, 127, 128, 127, dict(causal=True, window=(63, -1))),
    "segments across tiles D40": (2, 2, 2, 129, 129, 40, 129, dict(causal=True,
                                                                   segment_ids=45)),
    "bias D96 kv_valid_len 65": (2, 2, 2, 127, 77, 96, 65, dict(bias="full")),
    "bias D40 causal GQA": (1, 4, 2, 129, 129, 40, 129, dict(causal=True, bias="rows")),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_capped_fwd_reference_matches_jax(case):
    """fwd_reference with cap 5 against the JAX flash_attention_with_lse
    (Pallas K1 in interpret mode): O and the live rows' LSE, dead rows' O
    exactly 0."""
    B, Hq, Hkv, Nq, Nk, D, valid, opts = FWD_CASES[case]
    opts = dict(opts)
    doc, kind = opts.pop("segment_ids", None), opts.pop("bias", None)
    q, k, v = make_qkv(110, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    q, k = 3 * q, 3 * k
    seg = None if doc is None else np.stack([_packed(Nq, doc), _packed(Nq, doc + 7)])[:B]
    bias = None if kind is None else _bias(kind, B, Hq, Nq, Nk, np.random.default_rng(111))
    o, lse = flash_fwd.fwd_reference(
        q, k, v, scale=D ** -0.5, kv_valid_len=valid, softcap=CAP,
        segment_ids=None if seg is None else (torch.from_numpy(seg).int(),) * 2,
        bias=None if bias is None else torch.from_numpy(bias), **opts)
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *_jx(q, k[:, :, :valid], v[:, :, :valid]), logit_softcap=CAP, **opts,
        bias=None if bias is None else jnp.asarray(bias[..., :valid]),
        segment_ids=None if seg is None else _jx(seg, seg[:, :valid]))
    live = lse > 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse[live], np.asarray(lse_want)[live.numpy()], FWD_TOL[torch.float32], "lse")
    assert (o[~live] == 0).all()


# ---------------------------------------------------------------------------
# The C entries' argument packing with the cap, through ctypes stand-ins.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


def _bnhd(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16) for x in xs)


@pytest.mark.parametrize("segments", [False, True])
def test_dense_launch_packs_the_cap(segments):
    """fa_fwd_sm90 on BNHD views with GQA, a window, cap 30 and (or not)
    segment ids: the cap right after the scale, every other argument where
    the C entry has it."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 140, 40
    q, k, v = _bnhd(*make_qkv(112, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o, lse = torch.empty_like(q), torch.empty((B, Hq, Nq))
    ids = (torch.arange(Nq).repeat(B, 1) // 50, torch.arange(Nk).repeat(B, 1) // 50)
    seg = flash_fwd.sm90_segments(ids, Nq, 130) if segments else None
    seen = []
    lib = types.SimpleNamespace(fa_fwd_sm90=_recorder("fa_fwd_sm90", native.FWD_SM90_ARGTYPES,
                                                      seen))
    rc = flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, seg, scale=0.125, kv_valid_len=130,
                                      causal=True, window=(64, -1), softcap=30.0, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.FWD_SM90_ARGTYPES) == 36
    assert args[:5] == tuple(x.data_ptr() for x in (q, k, v, o, lse))
    assert args[5:9] == ((None,) * 4 if seg is None else tuple(x.data_ptr() for x in seg))
    assert args[9:20] == (B, Hq, Hkv, Nq, D, 130, 1, 64, -1, 0, 0)
    assert args[20:22] == (0.125, 30.0)
    assert args[22:25] == (Nq * Hq * D, D, Hq * D)
    assert args[34] == (Nq if segments else 0) and args[35] == 4096


@pytest.mark.parametrize("causal", [False, True])
def test_bias_launch_packs_the_cap(causal):
    """fa_fwd_bias_sm90 on BNHD views with GQA at D 96 and a [B, 1, 1, Nk]
    bias with cap 30: D as given (the kernel runs it in its D 128 boxes), the
    cap right after the scale, the bias's strides after the tensors'."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 128, 96
    q, k, v = _bnhd(*make_qkv(113, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o, lse = torch.empty_like(q), torch.empty((B, Hq, Nq))
    bias, strides = flash_fwd.kernel_bias(torch.zeros((B, 1, 1, Nk)))
    seen = []
    lib = types.SimpleNamespace(fa_fwd_bias_sm90=_recorder(
        "fa_fwd_bias_sm90", native.FWD_BIAS_SM90_ARGTYPES, seen))
    rc = flash_fwd._launch_bias_sm90(lib, q, k, v, o, lse, bias, strides, None, scale=0.125,
                                     kv_valid_len=100, causal=causal, window=None,
                                     softcap=30.0, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.FWD_BIAS_SM90_ARGTYPES) == 40
    assert args[:6] == tuple(x.data_ptr() for x in (q, k, v, o, lse, bias))
    assert args[10:17] == (B, Hq, Hkv, Nq, D, 100, int(causal))
    assert args[21:23] == (0.125, 30.0)
    assert args[23:26] == (Nq * Hq * D, D, Hq * D)
    assert args[35:38] == (Nk, 0, 0) and args[39] == 4096


@pytest.mark.parametrize("want_dbias", [False, True])
def test_bias_bwd_launch_packs_the_cap(want_dbias):
    """fa_bwd_bias_sm90 on BNHD views with GQA at D 40 and a [B, 1, Nq, Nk]
    bias with cap 5: dbias null when not wanted, the cap right after the
    scale, every stride after it."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 128, 40
    q, k, v = _bnhd(*make_qkv(114, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 128))
    bias, strides = flash_fwd.sm90_bias(torch.zeros((B, 1, Nq, Nk)))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hkv, Nk, D)), torch.empty((B, Hkv, Nk, D))
    dbias = torch.empty((B, Hq, Nq, Nk)) if want_dbias else None
    seen = []
    lib = types.SimpleNamespace(fa_bwd_bias_sm90=_recorder(
        "fa_bwd_bias_sm90", native.BWD_BIAS_SM90_ARGTYPES, seen))
    rc = flash_bwd._launch_bias_bwd(lib, q, k, v, do, stats, stats, bias, strides, dq, dk, dv,
                                    dbias, scale=0.125, causal=True, kv_valid_len=100,
                                    nq_pad=128, softcap=CAP, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0][1]
    assert len(args) == len(native.BWD_BIAS_SM90_ARGTYPES) == 46
    assert args[10] == (dbias.data_ptr() if want_dbias else None)
    assert args[15:28] == (B, Hq, Hkv, Nq, Nk, D, 100, 1, -1, -1, 0, 0, 128)
    assert args[28:30] == (0.125, CAP)
    assert args[30:33] == (Nq * Hq * D, D, Hq * D)
    assert args[42:45] == (Nq * Nk, 0, Nk) and args[45] == 4096


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


# (B, Hq, Hkv, Nq, Nk, D, options, the C entries of the forward and the
# backward): the soft-capped calls take K1's dense route and the split route
# (alone, with a window, with ids, at D 40 and 96); a capped bias and a bias
# at D 40 / 96 take K1's bias route and its backward; the GQA decode fold
# with a bias (and the cap) the decode kernel and the bias route's backward.
ROUTE_CASES = {
    "softcap D 128": (2, 8, 4, 300, 300, 128, dict(causal=True, logit_softcap=50.0),
                      ["fa_fwd_sm90", "fa_bwd_split_sm90"]),
    "softcap + window D 96": (1, 8, 4, 300, 300, 96, dict(causal=True, window=(100, -1),
                                                          logit_softcap=50.0),
                              ["fa_fwd_sm90", "fa_bwd_split_sm90"]),
    "softcap + ids D 40": (2, 4, 4, 300, 300, 40, dict(segment_ids=True, logit_softcap=30.0),
                           ["fa_fwd_sm90", "fa_bwd_split_sm90"]),
    "capped bias": (2, 8, 4, 300, 300, 128, dict(causal=True, bias="heads", logit_softcap=50.0),
                    ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
    "D 96 bias": (2, 8, 4, 300, 300, 96, dict(bias="keys"),
                  ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
    "D 40 bias": (2, 8, 8, 300, 250, 40, dict(causal=True, bias="full"),
                  ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
    "D 40 capped bias": (1, 4, 2, 200, 200, 40, dict(bias="keys", logit_softcap=5.0),
                         ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]),
    "decode fold with a bias": (2, 8, 2, 2, 512, 128, dict(bias="rows"),
                                ["fa_decode", "fa_bwd_bias_sm90"]),
    "decode fold, capped bias": (2, 8, 2, 2, 512, 64, dict(bias="rows", logit_softcap=50.0),
                                 ["fa_decode", "fa_bwd_bias_sm90"]),
}


def _meta_bias(kind, B, Hq, Nq, Nk):
    shape = {"full": (B, Hq, Nq, Nk), "heads": (1, Hq, Nq, Nk), "rows": (B, 1, Nq, Nk),
             "keys": (B, 1, 1, Nk)}[kind]
    return torch.zeros(shape, device="meta").requires_grad_(True)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_flash_core_routes_on_a_simulated_card(card, case):
    B, Hq, Hkv, Nq, Nk, D, opts, entries = ROUTE_CASES[case]
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(B, Hq, Hkv, Nq, Nk, D))
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, Nq), dtype=torch.int32, device="meta")
    leaves = [q, k, v]
    if "bias" in kw:
        kw["bias"] = _meta_bias(kw["bias"], B, Hq, Nq, Nk)
        leaves.append(kw["bias"])
    before = (flash_fwd.fwd.launches_softcap, flash_bwd.bias_bwd.launches_dbias)
    o = flashattn_tpu_torch.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, leaves, torch.empty_like(o))
    assert [name for name, _ in card] == entries
    assert [g.shape for g in grads] == [x.shape for x in leaves]
    capped = "logit_softcap" in kw
    assert flash_fwd.fwd.launches_softcap == before[0] + capped
    args = card[0][1]
    if entries[0] == "fa_fwd_sm90":
        assert args[21] == kw["logit_softcap"]  # the cap, after the scale
    elif entries[0] == "fa_fwd_bias_sm90":
        assert args[22] == kw.get("logit_softcap", 0.0)
    if entries[1] == "fa_bwd_bias_sm90":
        bwd = card[1][1]
        assert bwd[29] == kw.get("logit_softcap", 0.0)
        assert flash_bwd.bias_bwd.launches_dbias == before[1] + 1  # the bias requires grad


OPTIONS = {"none": {}, "causal": dict(causal=True), "window": dict(window=(50, 10)),
           "ids": dict(segment_ids=True), "softcap": dict(logit_softcap=20.0),
           "softcap + window": dict(causal=True, window=(70, -1), logit_softcap=20.0),
           "softcap + ids": dict(segment_ids=True, logit_softcap=20.0),
           "bias": dict(bias="full"), "capped bias": dict(bias="keys", logit_softcap=20.0)}


@pytest.mark.parametrize("D", [8, 40, 64, 96, 128])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_no_bf16_call_up_to_d128_reaches_fwd_tile(card, name, D):
    """No bf16 forward at D <= 128 reaches K1's quantized route
    (fa_fwd_quant_sm90, where the mma.sync fwd_tile.cuh's fa_fwd was): each
    option's call takes one bf16 Hopper route."""
    B, Hq, Hkv, N = 2, 4, 2, 200
    q, k, v = _meta_qkv(B, Hq, Hkv, N, N, D)
    kw = dict(OPTIONS[name])
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = (torch.zeros((B, N), dtype=torch.int32, device="meta"),) * 2
    if "bias" in kw:
        kw["bias"] = _meta_bias(kw["bias"], B, Hq, N, N).detach()
    flash_fwd.fwd(q, k, v, scale=D ** -0.5, softcap=kw.pop("logit_softcap", None), **kw)
    want = "fa_fwd_bias_sm90" if "bias" in kw else "fa_fwd_sm90"
    assert [c for c, _ in card] == [want]


@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_no_bf16_call_without_a_bias_reaches_fwd_tile(card, name, D):
    """Above D 128 no bf16 forward reaches the quantized route: each
    option's call takes K1's dense route's D 256 form, or with a bias the
    bias route's D 256 form, each counted as such."""
    B, Hq, Hkv, N = 2, 4, 2, 200
    q, k, v = _meta_qkv(B, Hq, Hkv, N, N, D)
    kw = dict(OPTIONS[name])
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = (torch.zeros((B, N), dtype=torch.int32, device="meta"),) * 2
    if "bias" in kw:
        kw["bias"] = _meta_bias(kw["bias"], B, Hq, N, N).detach()
    before = flash_fwd.fwd.launches_dense_d256, flash_fwd.fwd.launches_bias_d256
    flash_fwd.fwd(q, k, v, scale=D ** -0.5, softcap=kw.pop("logit_softcap", None), **kw)
    want = "fa_fwd_bias_sm90" if "bias" in kw else "fa_fwd_sm90"
    assert [c for c, _ in card] == [want]
    assert (flash_fwd.fwd.launches_dense_d256, flash_fwd.fwd.launches_bias_d256) == (
        before[0] + (want == "fa_fwd_sm90"), before[1] + (want == "fa_fwd_bias_sm90"))


@pytest.mark.parametrize("fn", ["dkv", "dq"])
def test_split_kernels_with_a_bias_name_the_route(card, fn):
    """On the card K5 and K6 keep no kernel: with a bias they raise
    NotImplementedError naming bias_bwd, and launch nothing."""
    q, k, v = _meta_qkv(1, 2, 2, 64, 64, 96)
    lse = torch.empty((1, 2, 64), device="meta")
    bias = torch.zeros((1, 1, 64, 64), device="meta")
    with pytest.raises(NotImplementedError, match="bias_bwd"):
        getattr(flash_bwd, fn)(q, k, v, q, lse, lse, scale=0.1, bias=bias, softcap=5.0)
    assert card == []
