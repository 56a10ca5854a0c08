"""K5 + K6's bias route -- the rule that sends the backward of K1's bias
route to one Hopper kernel (``bias_bwd_route``), its plain version
(``bias_bwd_reference``), the packing of the kernel's C arguments and the
routing of ``_FlashCore.backward`` -- against the JAX package on CPU.

The kernel itself runs only on the card (``python3 chip_smoke.py`` holds it
against ``bias_bwd_reference`` there). Here the same numpy inputs go through
``bias_bwd_reference`` (fed the port's forward LSE and Δ) and ``jax.vjp`` of
the JAX ``flash_attention``, whose backward with a bias is its two Pallas
kernels ``_dkv_kernel`` and ``_dq_kernel`` in interpret mode, as the JAX
package's tests run them. Budget BWD_TOL[f32] (1e-3 abs + 5e-4 rel) for f32
inputs, BWD_TOL[bf16] where the port runs in bf16. A kv_valid_len below Nk is
given to JAX as K / V and the bias cut to their first kv_valid_len keys; the
port's gradients past them must be exactly 0.
"""

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
from flashattn_tpu_torch.integrations import (
    FlashMultiHeadDotProductAttention,
    make_attention_mask,
)
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, assert_close, make_qkv

N = 2048  # path A's sequence


def _route(head_dim=128, bias_shape=(4, 1, N, N), dtype=torch.bfloat16):
    # A meta tensor: the rule reads the bias's shape only.
    bias = None if bias_shape is None else torch.empty(bias_shape, device="meta")
    return flash_bwd.bias_bwd_route(head_dim=head_dim, bias=bias, dtype=dtype)


# The calls the route takes, every backward with a bias in bf16 at D <= 256
# (D 136 and 256 on its D 256 form):
# path A's two arms, the causal LM's learned [1, 16, N, N] bias, D 64 with a
# padding bias, D 96 and 40 and 8 (run in the D 128 / 64 boxes), a
# row-broadcast key mask, a ragged Nq, an Nk that is not a multiple of 4
# (the wrapper pads the bias's rows: sm90_bias), and the decode fold's
# [B, 1, rep * Nq, Nk] bias. Causal, a window, q / kv offsets, segment ids,
# the rows per KV head and the softcap are not the rule's to read: it takes
# every such call.
ROUTE_TAKES = {"path A mask": {}, "path A learned": dict(bias_shape=(4, 16, N, N)),
               "causal GQA": dict(bias_shape=(1, 16, N, N)),
               "D 64": dict(head_dim=64, bias_shape=(2, 1, 1536, 1536)),
               "D 96": dict(head_dim=96), "D 40": dict(head_dim=40), "D 8": dict(head_dim=8),
               "row-broadcast": dict(bias_shape=(4, 1, 1, N)),
               "ragged Nq": dict(bias_shape=(2, 16, 1000, N)),
               "Nk 2046": dict(bias_shape=(4, 1, N, N - 2)),
               "decode-shaped": dict(bias_shape=(2, 1, 8, N)),
               "f32 path A": dict(dtype=torch.float32),
               "f32 D 136": dict(head_dim=136, dtype=torch.float32),
               "f32 D 64": dict(head_dim=64, dtype=torch.float32, bias_shape=(1, 16, N, N)),
               "D 136": dict(head_dim=136), "D 256": dict(head_dim=256, bias_shape=(4, 8, N, N))}
# Those it refuses: head dims above 256 (f32 too), fp16 calls, and no
# bias at all (K3's or the split route's).
ROUTE_REFUSES = {"no bias": dict(bias_shape=None),
                 "f32": dict(head_dim=264, dtype=torch.float32),
                 "fp16": dict(dtype=torch.float16), "D 264": dict(head_dim=264)}


@pytest.mark.parametrize("case", list(ROUTE_TAKES))
def test_bias_bwd_route_takes(case):
    assert _route(**ROUTE_TAKES[case])


@pytest.mark.parametrize("case", list(ROUTE_REFUSES))
def test_bias_bwd_route_refuses(case):
    assert not _route(**ROUTE_REFUSES[case])


def _padding(lengths, nq, nk):
    keep_q = np.arange(nq)[None] < np.asarray(lengths)[:, None]
    keep_k = np.arange(nk)[None] < np.asarray(lengths)[:, None]
    pair = keep_q[:, None, :, None] & keep_k[:, None, None, :]
    return np.where(pair, 0.0, DEFAULT_MASK_VALUE).astype(np.float32)


def _bias(kind, B, Hq, Nq, Nk, rng):
    if kind == "padding":
        return _padding([Nq, Nq * 5 // 8], Nq, Nk)
    if kind == "keys":
        bias = rng.standard_normal((B, 1, 1, Nk), dtype=np.float32)
        bias[1, ..., Nk - 16:] = DEFAULT_MASK_VALUE
        return bias
    shape = {"full": (B, Hq, Nq, Nk), "heads": (1, Hq, Nq, Nk), "rows": (B, 1, Nq, Nk)}[kind]
    return rng.standard_normal(shape, dtype=np.float32)


# (B, Hq, Hkv, Nq, Nk, D, kv_valid_len, causal, bias kind, want dbias): the
# route's shape families cut narrow -- path A's key-padding bias with dead
# rows (no dbias, as its mask arm) and its learned [B, H, N, N] arm, the
# causal LM with GQA and a head-broadcast [1, Hq, N, N] bias, a row-broadcast
# [B, 1, 1, Nk] key mask, a batch-broadcast [B, 1, Nq, Nk] bias with Nq != Nk,
# and a ragged Nq with kv_valid_len < Nk, causal, at D 128.
REF_CASES = {"padding": (2, 2, 2, 64, 64, 64, 64, False, "padding", False),
             "learned": (2, 2, 2, 64, 64, 64, 64, False, "full", True),
             "causal GQA": (1, 4, 2, 64, 64, 128, 64, True, "heads", True),
             "keys": (2, 2, 2, 40, 64, 64, 64, False, "keys", True),
             "rows": (2, 4, 2, 72, 40, 64, 40, False, "rows", True),
             "ragged": (1, 2, 1, 40, 64, 128, 48, True, "full", True)}


def _reduce_to(dbias, shape):
    dims = tuple(d for d in range(3) if shape[d] == 1 and dbias.shape[d] != 1)
    return dbias.sum(dim=dims, keepdim=True) if dims else dbias


@pytest.mark.parametrize("case", list(REF_CASES))
def test_bias_bwd_reference_matches_jax_kernels(case):
    """The route's plain version -- dQ, dK / dV per KV head, dbias reduced
    over the bias's broadcast dims -- against jax.vjp of the JAX
    flash_attention (its Pallas K5 / K6 in interpret mode); dead rows get no
    gradient, keys past kv_valid_len none."""
    B, Hq, Hkv, Nq, Nk, D, valid, causal, kind, want_dbias = REF_CASES[case]
    q, k, v = make_qkv(60, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(61, B, Hq, Nq, D)[0]
    bias = _bias(kind, B, Hq, Nq, Nk, np.random.default_rng(62))
    assert _route(head_dim=D, bias_shape=bias.shape)
    kw = dict(scale=D ** -0.5, causal=causal, kv_valid_len=valid, bias=torch.from_numpy(bias))
    o, lse = flash_fwd.fwd_reference(q, k, v, **kw)
    dq, dk, dv, dbias = flash_bwd.bias_bwd_reference(q, k, v, do, lse, (do * o).sum(-1),
                                                     want_dbias=want_dbias, **kw)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert (dbias is not None) == want_dbias

    def f(q_, k_, v_, b_):
        return flashattn_tpu.flash_attention(q_, k_, v_, bias=b_, causal=causal)

    jx = [jnp.asarray(x) for x in (q.numpy(), k[:, :, :valid].numpy(),
                                   v[:, :, :valid].numpy(), bias[..., :valid])]
    o_jax, vjp = jax.vjp(f, *jx)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]
    tol = BWD_TOL[torch.float32]
    assert_close(dq, want[0], tol, "dq")
    assert_close(dk[:, :, :valid], want[1], tol, "dk")
    assert_close(dv[:, :, :valid], want[2], tol, "dv")
    assert (dk[:, :, valid:] == 0).all() and (dv[:, :, valid:] == 0).all()
    dead = lse <= 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
    assert (dq[dead] == 0).all()
    if want_dbias:
        assert dbias.shape == (B, Hq, Nq, Nk)
        assert_close(_reduce_to(dbias, bias.shape)[..., :valid], want[3], tol, "dbias")
        assert (dbias[..., valid:] == 0).all() and (dbias[dead] == 0).all()
    if kind == "padding":
        assert dead.any()


def _fake_library():
    """A stand-in for the kernel library: a ctypes function with the C
    entry's argument types, so ctypes converts the arguments as it would for
    the real ``fa_bwd_bias_sm90``, and records what it receives."""
    seen = []
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *native.BWD_BIAS_SM90_ARGTYPES)
    fn = proto(lambda *args: seen.append(args) or 0)
    return types.SimpleNamespace(fa_bwd_bias_sm90=fn), seen


@pytest.mark.parametrize("want_dbias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_launch_packs_the_c_arguments(causal, want_dbias):
    """The wrapper's call of fa_bwd_bias_sm90 on BNHD views with GQA and a
    [B, 1, Nq, Nk] bias: every pointer (dbias null when not wanted, no
    segment ids), dim, the band (causal, no window, no offsets), the LSE
    rows' pitch, the scale, every stride (the bias's 0 on its head) and the
    stream in the C entry's order."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 128, 64
    q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2).to(torch.bfloat16)
               for x in make_qkv(63, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 128))
    bias, strides = flash_fwd.sm90_bias(torch.zeros((B, 1, Nq, Nk)))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hkv, Nk, D)), torch.empty((B, Hkv, Nk, D))
    dbias = torch.empty((B, Hq, Nq, Nk)) if want_dbias else None
    lib, seen = _fake_library()
    rc = flash_bwd._launch_bias_bwd(lib, q, k, v, do, stats, stats, bias, strides, dq, dk, dv,
                                    dbias, scale=0.125, causal=causal, kv_valid_len=100,
                                    nq_pad=128, softcap=None, stream=4096)
    assert rc == 0 and len(seen) == 1
    args = seen[0]
    assert len(args) == len(native.BWD_BIAS_SM90_ARGTYPES) == 46
    assert args[:10] == tuple(x.data_ptr() for x in (q, k, v, do, stats, stats, bias, dq, dk, dv))
    assert args[10] == (dbias.data_ptr() if want_dbias else None)
    assert args[11:15] == (None,) * 4  # no segment ids
    assert args[15:28] == (B, Hq, Hkv, Nq, Nk, D, 100, int(causal), -1, -1, 0, 0, 128)
    assert args[28:30] == (0.125, 0.0)  # the scale, no softcap
    assert args[30:33] == (Nq * Hq * D, D, Hq * D)  # q: BNHD, (batch, head, seq)
    assert args[33:36] == (Nk * Hkv * D, D, Hkv * D)
    assert args[36:39] == args[33:36] and args[39:42] == args[30:33]  # dO: a clone of q
    assert args[42:45] == (Nq * Nk, 0, Nk)  # bias [B, 1, Nq, Nk]: head broadcast
    assert args[45] == 4096


def test_padded_rows_pads_lse_to_the_kernel_tile():
    """LSE / Δ rows padded with zeros to a multiple of the kernel's 64-row Q
    tile (its bulk copies read whole tiles); an aligned tensor is passed as
    it is."""
    x = torch.randn((2, 3, 100))
    padded = flash_bwd._padded_rows(x, 128)
    assert padded.shape == (2, 3, 128) and torch.equal(padded[..., :100], x)
    assert (padded[..., 100:] == 0).all()
    aligned = torch.randn((2, 3, 128))
    assert flash_bwd._padded_rows(aligned, 128) is aligned


def _spy_backward(monkeypatch):
    """Count the backward kernels' wrapper calls; bias_bwd keeps its CPU body
    (the plain version: the stand-in for the kernel here)."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("bias_bwd", "dkv", "dq"):
        monkeypatch.setattr(flash_bwd, name, spy(name, getattr(flash_bwd, name)))
    return calls


@pytest.mark.parametrize("causal", [False, True])
def test_flash_core_backward_takes_the_route(causal, monkeypatch):
    """flash_attention's backward on the route -- bf16, D 64, GQA 4/2, a
    trainable [1, Hq, Nq, Nk] bias -- calls bias_bwd once and neither K5 nor
    K6; its gradients and the bias's, summed over the batch, agree with
    jax.vjp of the JAX flash_attention on the f32 inputs within BWD_TOL[bf16]."""
    calls = _spy_backward(monkeypatch)
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 64, 64, 64
    q, k, v = make_qkv(64, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(65, B, Hq, Nq, D)[0]
    bias = np.random.default_rng(66).standard_normal((1, Hq, Nq, Nk), dtype=np.float32)
    leaves = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    leaves.append(torch.from_numpy(bias).requires_grad_(True))
    o = flashattn_tpu_torch.flash_attention(*leaves[:3], bias=leaves[3], causal=causal)
    got = torch.autograd.grad(o, leaves, do.to(torch.bfloat16))
    assert calls == ["bias_bwd"]
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    _, vjp = jax.vjp(lambda a, b, c, d: flashattn_tpu.flash_attention(a, b, c, bias=d,
                                                                      causal=causal),
                     *(jnp.asarray(x) for x in (q.numpy(), k.numpy(), v.numpy(), bias)))
    want = vjp(jnp.asarray(do.numpy()))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert_close(g.float(), np.asarray(w), BWD_TOL[torch.bfloat16], name)


@pytest.mark.parametrize("arm", ["mask", "learned"])
def test_attention_module_backward_takes_the_route(arm, monkeypatch):
    """Every backward FlashMultiHeadDotProductAttention makes on path A (a
    key-padding mask, and the mask plus a learned [1, H, N, N] bias) at a
    small width -- 2 heads of 64 in bf16, N 64 -- goes to bias_bwd, never to
    K5 / K6, and the learned bias gets its gradient."""
    calls = _spy_backward(monkeypatch)
    B, L, H, F = 2, 64, 2, 128
    module = FlashMultiHeadDotProductAttention(H, F, impl="fused", dtype=torch.bfloat16,
                                               device="cpu",
                                               generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(67).standard_normal((B, L, F), dtype=np.float32))
    valid = torch.arange(L)[None] < torch.tensor([L, 40])[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    rel = None
    if arm == "learned":
        rel = torch.from_numpy(np.random.default_rng(68).standard_normal((1, H, L, L),
                                                                        dtype=np.float32))
        rel.requires_grad_(True)
    for _ in range(2):
        module(x.to(torch.bfloat16), mask=mask, bias=rel).float().sum().backward()
    assert calls == ["bias_bwd", "bias_bwd"]
    assert rel is None or (rel.grad is not None and torch.isfinite(rel.grad).all())


def test_cpu_bias_bwd_never_reaches_the_kernel(monkeypatch):
    """On CPU tensors bias_bwd runs its plain version: no library, no launch."""
    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(native, "kernels", no_library)
    q, k, v = (x.to(torch.bfloat16) for x in make_qkv(69, 2, 2, 64, 64))
    bias = torch.from_numpy(_padding([64, 30], 64, 64))
    o, lse = flash_fwd.fwd(q, k, v, scale=0.125, bias=bias)
    before = (flash_bwd.bias_bwd.launches, flash_bwd.bias_bwd.launches_dbias)
    out = flash_bwd.bias_bwd(q, k, v, q, lse, (q.float() * o.float()).sum(-1), scale=0.125,
                             bias=bias, want_dbias=True)
    assert (flash_bwd.bias_bwd.launches, flash_bwd.bias_bwd.launches_dbias) == before
    assert all(torch.isfinite(x).all() for x in out)


def test_bias_bwd_off_the_cpu_takes_no_plain_path():
    """A tensor on another device (the meta device) raises: no silent
    fallback to the plain version."""
    q = torch.empty(1, 2, 64, 64, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(1, 2, 64, device="meta")
    bias = torch.empty(1, 1, 64, 64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        flash_bwd.bias_bwd(q, q, q, q, lse, lse, scale=0.1, bias=bias)


def test_bias_bwd_needs_a_bias():
    q, k, v = make_qkv(70, 1, 2, 32, 64)
    lse = torch.zeros(1, 2, 32)
    with pytest.raises(ValueError, match="needs a bias"):
        flash_bwd.bias_bwd(q, k, v, q, lse, lse, scale=0.1, bias=None)
