"""f32 with a bias on the card: K1's f32 route (its BIAS family) and the f32
backward (its BIAS family, dbias on request) -- the host glue on the CPU.

The kernels run only on the card (``python3 chip_smoke.py``:
``phase_f32_bias_check`` holds them against their plain versions,
``phase_f32_bias_train`` drives f32 path A). Here: the routes' takes and
refusals; on a simulated card (meta tensors, the device checks off, a
stand-in library with the C entries' argtypes recording every call) the C
arguments of ``fa_fwd_f32`` / ``fa_bwd_f32`` with the bias, its strides and
dbias, dK / dV per KV head, the launch counters and dbias zero-filled
exactly where ``dbias_skips`` says; every call of the f32 attention module
taking the f32 bias routes; and f32 path A's plain function (the card gate's
reference, ``chip_smoke._plain_mhdpa``) against flax's
``MultiHeadDotProductAttention`` on shared numpy weights (the JAX tests'
budgets: 2e-5 on outputs, 5e-4 on gradients).
"""

import contextlib
import ctypes
import functools
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import flashattn_tpu_torch
from flashattn_tpu_torch.integrations import FlashMultiHeadDotProductAttention, make_attention_mask
from flashattn_tpu_torch.models.convert import mhdpa_from_flax
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native

F32 = torch.float32


def _cuda_q(D, dtype=F32):
    """A stand-in for a CUDA query [1, 4, 64, D]: what the kernel checks read."""
    return types.SimpleNamespace(shape=(1, 4, 64, D), dtype=dtype,
                                 device=types.SimpleNamespace(type="cuda"))


# ---------------------------------------------------------------------------
# The routes' takes and refusals.

# (D, options) that K1's checks and the backward's route take for an f32 q
# with a bias: every option of the f32 route, D off 64 (run in the D 128
# boxes) and D 8.
TAKES = {"plain": (128, {}), "ids": (64, dict(segment_ids=(1, 1))),
         "window": (128, dict(windowed=True)), "offsets": (128, dict(offsets=True)),
         "everything": (64, dict(segment_ids=(1, 1), windowed=True, offsets=True)),
         "D 72": (72, {}), "D 8": (8, dict(windowed=True))}


@pytest.mark.parametrize("case", list(TAKES))
def test_f32_bias_passes_k1_checks_and_the_backward_route(case):
    D, opts = TAKES[case]
    kw = {**dict(segment_ids=None, k_scale=None, windowed=False, offsets=False), **opts}
    flash_fwd._check_kernel_args(_cuda_q(D), bias=object(), **kw)
    flash_bwd.check_kernel_dims(_cuda_q(D), "K5 + K6 bias route")
    assert flash_fwd.f32_route(dtype=F32)
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=F32)


@pytest.mark.parametrize("D", [136, 192, 256])
@pytest.mark.parametrize("opts", [{}, dict(segment_ids=(1, 1), windowed=True, offsets=True)],
                         ids=["plain", "everything"])
def test_f32_bias_above_d128_is_refused_naming_f32_rows_item_5(D, opts):
    kw = {**dict(segment_ids=None, k_scale=None, windowed=False, offsets=False), **opts}
    with pytest.raises(NotImplementedError, match="f32 rows item 5"):
        flash_fwd._check_kernel_args(_cuda_q(D), bias=object(), **kw)
    assert not flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=F32)
    with pytest.raises(NotImplementedError, match="f32 rows item 5"):
        flash_bwd.check_kernel_dims(_cuda_q(D), "K5 + K6 bias route")


def test_f32_quantized_kv_is_refused_naming_f32_rows_item_2():
    with pytest.raises(NotImplementedError, match="f32 rows item 2"):
        flash_fwd._check_kernel_args(_cuda_q(128), segment_ids=None, bias=object(),
                                     k_scale=object(), windowed=False)


# ---------------------------------------------------------------------------
# The simulated card.


class _Calls(list):
    """The C entries called, as (name, arguments), and in ``bias`` the bias
    and dbias tensors each f32 launch was given."""

    def __init__(self):
        super().__init__()
        self.bias = []


def _recorder(name, argtypes, calls):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: calls.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' device checks are off
    and a stand-in library records the name and arguments of every C entry
    called (ctypes converts them by the entries' argtypes; a meta tensor's
    address is 0, which ctypes passes as None), and ``calls.bias`` the
    bias / dbias tensors each f32 launch was given."""
    calls = _Calls()
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_bias_sm90": native.BWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES,
             "fa_fwd_f32": native.FWD_F32_ARGTYPES, "fa_bwd_f32": native.BWD_F32_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    for name in ("fa_fwd", "fa_decode"):
        setattr(lib, name, lambda *args, name=name: calls.append((name, args)) or 0)
    for mod, name in ((flash_fwd, "_launch_dense_sm90"), (flash_bwd, "_launch_split")):
        def spy(*args, real=getattr(mod, name), **kw):
            calls.bias.append((kw.get("bias"), kw.get("dbias")))
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta(B, Hq, Hkv, Nq, Nk, D):
    q = torch.empty((B, Nq, Hq, D), dtype=F32, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=F32, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


def _counters():
    return (flash_fwd.fwd.launches_f32, flash_fwd.fwd.launches_f32_bias,
            flash_fwd.fwd.launches_bias, flash_bwd.bias_bwd.launches,
            flash_bwd.bias_bwd.launches_f32, flash_bwd.bias_bwd.launches_dbias,
            flash_bwd._f32_bwd_launch.launches)


# (B, Hq, Hkv, Nq, Nk, D, options, bias shape, whether the bias needs a
# gradient): f32 flash_attention with a bias on the card, every option the
# f32 route takes; a decode-shaped call (bf16 would take the decode kernel),
# GQA, a bias without a gradient.
ROUTED = {
    "path A mask": (4, 2, 2, 128, 128, 64, {}, (4, 1, 128, 128), False),
    "learned": (1, 4, 2, 128, 128, 128, {}, (1, 4, 128, 128), True),
    "causal + offsets": (1, 4, 1, 100, 200, 64, dict(causal=True, q_offset=100, kv_offset=0),
                         (1, 4, 1, 200), True),
    "window + ids + cap": (2, 4, 2, 130, 130, 72, dict(window=(16, 16), segment_ids=True,
                                                       logit_softcap=30.0),
                           (2, 1, 130, 130), True),
    "decode-shaped": (2, 8, 8, 1, 300, 128, {}, (2, 1, 1, 300), True),
}


@pytest.mark.parametrize("case", list(ROUTED))
def test_f32_bias_calls_reach_the_f32_kernels_with_their_bias(card, case):
    """One fa_fwd_f32 and one fa_bwd_f32 call, nothing else: the forward's
    bias pointer and strides (sm90_bias': rows padded to 4 columns) before
    the stream, the backward's bias, dbias (None without a gradient) and
    strides; dK / dV come back per KV head; the counters count one f32 bias
    launch each way (with dbias where wanted)."""
    B, Hq, Hkv, Nq, Nk, D, opts, bshape, learn = ROUTED[case]
    q, k, v = (x.requires_grad_(True) for x in _meta(B, Hq, Hkv, Nq, Nk, D))
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, Nq), dtype=torch.int32, device="meta")
    bias = torch.zeros(bshape, device="meta", requires_grad=learn)
    before = _counters()
    o = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias, **kw)
    leaves = (q, k, v, bias) if learn else (q, k, v)
    grads = torch.autograd.grad(o, leaves, torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_f32", "fa_bwd_f32"]
    assert [g.shape for g in grads] == [x.shape for x in leaves]
    fwd_args, bwd_args = card[0][1], card[1][1]
    assert len(fwd_args) == 41 and len(bwd_args) == 47
    pad = Nk + -Nk % 4
    strides = tuple(0 if n == 1 else s for n, s in zip(bshape[:3], (
        bshape[1] * bshape[2] * pad, bshape[2] * pad, pad)))
    (fwd_bias, no_dbias), (bwd_bias, dbias) = card.bias
    assert fwd_bias.shape == bwd_bias.shape == bshape and no_dbias is None
    assert fwd_bias.stride()[-2] == pad  # the forward's 16-byte rows (sm90_bias)
    assert (dbias is not None) == learn and (not learn or dbias.shape == (B, Hq, Nq, Nk))
    assert fwd_args[37:40] == strides
    assert bwd_args[43:46] == tuple(0 if n == 1 else s for n, s in zip(bshape[:3], (
        bshape[1] * bshape[2] * Nk, bshape[2] * Nk, Nk)))
    assert fwd_args[22] == bwd_args[28] == kw.get("logit_softcap", 0.0)
    assert tuple(a - b for a, b in zip(_counters(), before)) == (1, 1, 1, 1, 1, int(learn), 1)


def test_bias_bwd_on_f32_sums_dk_dv_per_kv_head(card):
    """The f32 body writes dK / dV per query head; bias_bwd returns them per
    KV head, as the bf16 bias kernel does."""
    q, k, v = _meta(1, 8, 2, 64, 64, 64)
    lse = torch.empty((1, 8, 64), device="meta")
    bias = torch.zeros((1, 8, 64, 64), device="meta")
    dq, dk, dv, dbias = flash_bwd.bias_bwd(q, k, v, q, lse, lse, scale=0.125, bias=bias,
                                           want_dbias=True)
    assert dq.shape == q.shape and dk.shape == dv.shape == (1, 2, 64, 64)
    assert dbias.shape == (1, 8, 64, 64)
    assert [name for name, _ in card] == ["fa_bwd_f32"]


def test_no_launch_without_keys(card):
    """kv_valid_len 0: no key attends, nothing launches, every gradient and
    dbias is zero."""
    q, k, v = (torch.randn(1, 2, 16, 64) for _ in "qkv")
    lse = torch.zeros((1, 2, 16))
    bias = torch.zeros((1, 2, 16, 16))
    q, k, v, lse, bias = (x.to("meta") for x in (q, k, v, lse, bias))
    before = _counters()
    flash_bwd.bias_bwd(q, k, v, q, lse, lse, scale=0.125, bias=bias, want_dbias=True,
                       kv_valid_len=0)
    assert card == [] and _counters() == before


class _Allocs:
    """torch as flash_bwd sees it, recording which of ``zeros`` / ``empty``
    allocated the [B, Hq, Nq, Nk] dbias."""

    def __init__(self, shape):
        self.shape, self.seen = shape, []

    def __getattr__(self, name):
        return getattr(torch, name)

    def zeros(self, shape, **kw):
        if tuple(shape) == self.shape:
            self.seen.append("zeros")
        return torch.zeros(shape, **kw)

    def empty(self, shape, **kw):
        if tuple(shape) == self.shape:
            self.seen.append("empty")
        return torch.empty(shape, **kw)


# (options, whether the f32 body may leave dbias pairs unwritten): the Q
# tiles a band or the ids skip and the CTAs past kv_valid_len.
ZERO_FILL = {"plain": (dict(), False), "causal": (dict(causal=True), True),
             "window": (dict(window=(16, 16)), True),
             "left bound only": (dict(window=(8, -1)), True),
             "segment ids": (dict(segment_ids=True), True),
             "kv tail": (dict(kv_valid_len=200), True),
             "offsets, no band": (dict(q_offset=64), False)}


@pytest.mark.parametrize("case", list(ZERO_FILL))
def test_f32_dbias_is_zero_filled_where_pairs_go_unwritten(card, monkeypatch, case):
    opts, zeroed = ZERO_FILL[case]
    B, Hq, Hkv, N, D = 2, 4, 2, 256, 64
    allocs = _Allocs((B, Hq, N, N))
    monkeypatch.setattr(flash_bwd, "torch", allocs)
    q, k, v = _meta(B, Hq, Hkv, N, N, D)
    lse = torch.empty((B, Hq, N), device="meta")
    kw = dict(opts)
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = (torch.zeros((B, N), dtype=torch.int32, device="meta"),) * 2
    bias = torch.empty((B, Hq, N, N), device="meta")
    flash_bwd.bias_bwd(q, k, v, q, lse, lse, scale=0.125, bias=bias, want_dbias=True, **kw)
    assert allocs.seen == ["zeros" if zeroed else "empty"]
    assert [name for name, _ in card] == ["fa_bwd_f32"]
    assert card.bias[0][0] is not None and card.bias[0][1] is not None
    assert flash_bwd.dbias_skips(causal=kw.get("causal", False), window=kw.get("window"),
                                 segment_ids=kw.get("segment_ids"),
                                 kv_valid_len=kw.get("kv_valid_len", N), nk=N) == zeroed


# ---------------------------------------------------------------------------
# The f32 attention module (path A) and its plain function.


@pytest.mark.parametrize("arm", ["mask", "learned"])
def test_every_call_of_the_f32_module_takes_the_f32_bias_routes(arm, monkeypatch):
    """FlashMultiHeadDotProductAttention at its default float32, impl
    "fused", on path A's two arms at a small width (2 heads of 64, N 64),
    forward and backward: every K1 call is an f32 call with a bias that the
    card's checks pass, and every backward goes to bias_bwd on f32 (its
    route true), with dbias exactly when the bias is learned."""
    fwd_calls, bwd_calls = [], []
    real_fwd, real_bwd = flash_fwd.fwd, flash_bwd.bias_bwd

    def fwd_spy(q, k, v, **kw):
        flash_fwd._check_kernel_args(
            _cuda_q(q.shape[-1], q.dtype), segment_ids=kw.get("segment_ids"),
            bias=kw.get("bias"), k_scale=None, windowed=False)
        fwd_calls.append((flash_fwd.f32_route(dtype=q.dtype), kw.get("bias") is not None))
        return real_fwd(q, k, v, **kw)

    def bwd_spy(q, *args, **kw):
        bwd_calls.append((q.dtype, flash_bwd.bias_bwd_route(
            head_dim=q.shape[-1], bias=kw["bias"], dtype=q.dtype), kw["want_dbias"]))
        return real_bwd(q, *args, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", fwd_spy)
    monkeypatch.setattr(flash_bwd, "bias_bwd", bwd_spy)
    B, L, H, F = 2, 64, 2, 128
    module = FlashMultiHeadDotProductAttention(H, F, impl="fused", device="cpu",
                                               generator=torch.Generator().manual_seed(0))
    assert next(module.parameters()).dtype == F32
    x = torch.from_numpy(np.random.default_rng(40).standard_normal((B, L, F), dtype=np.float32))
    valid = torch.arange(L)[None] < torch.tensor([L, 40])[:, None]
    mask = make_attention_mask(valid, valid, dtype=torch.bool)
    rel = None
    if arm == "learned":
        rel = torch.from_numpy(np.random.default_rng(41).standard_normal(
            (1, H, L, L), dtype=np.float32)).requires_grad_(True)
    for _ in range(2):
        module(x, mask=mask, bias=rel).sum().backward()
    assert fwd_calls == [(True, True)] * 2
    assert bwd_calls == [(F32, True, arm == "learned")] * 2


@pytest.mark.parametrize("padded", [False, True])
def test_f32_path_a_plain_function_matches_flax(padded):
    """chip_smoke._plain_mhdpa -- the plain f32 function that f32 path A's
    gate holds the module against -- on the module's weights carried from
    flax (mhdpa_from_flax), with a key-padding mask folded into its bias
    beside a learned [1, H, N, N] bias, against flax's
    MultiHeadDotProductAttention with that bias bound into
    nn.dot_product_attention: the output on the valid rows within 2e-5, the
    bias's and every parameter's gradient within 5e-4 (the loss counts the
    valid rows); and the module itself (its fused path, the plain versions
    on the CPU) within the same budgets of the plain function."""
    rng = np.random.default_rng(27)
    x = rng.standard_normal((2, 64, 32), dtype=np.float32)
    rel = 0.5 * rng.standard_normal((1, 2, 64, 64), dtype=np.float32)
    valid = np.arange(64)[None] < np.array([[64], [40 if padded else 64]])
    mask = nn.make_attention_mask(valid, valid) if padded else None

    def ref(b):
        return nn.MultiHeadDotProductAttention(
            num_heads=2, attention_fn=functools.partial(nn.dot_product_attention, bias=b))

    params = jax.tree_util.tree_map(np.asarray, ref(rel).init(jax.random.PRNGKey(28),
                                                              jnp.asarray(x)))

    def loss_jax(p, b):
        y = ref(b).apply(p, x, mask=mask)
        return ((y ** 2) * valid[..., None]).sum()

    g_params, g_rel = jax.grad(loss_jax, argnums=(0, 1))(params, jnp.asarray(rel))
    y_want = np.asarray(ref(rel).apply(params, x, mask=mask))
    mod = mhdpa_from_flax(params, num_heads=2, impl="fused", device="cpu")
    tvalid = torch.from_numpy(valid)
    keep = make_attention_mask(tvalid, tvalid, dtype=torch.bool)
    outs = {}
    for name in ("plain", "module"):
        mod.zero_grad()
        rel_t = torch.from_numpy(rel).requires_grad_(True)
        if name == "plain":
            y = chip_smoke._plain_mhdpa(mod, torch.from_numpy(x),
                                        torch.where(keep, 0.0, DEFAULT_MASK_VALUE) + rel_t)
        else:
            y = mod(torch.from_numpy(x), mask=keep if padded else None, bias=rel_t)
        ((y ** 2) * tvalid[..., None]).sum().backward()
        outs[name] = (y.detach(), rel_t.grad, {n: p.grad.clone()
                                               for n, p in mod.named_parameters()})
    y, g, grads = outs["plain"]
    assert float(np.abs(y.numpy()[valid] - y_want[valid]).max()) < 2e-5
    assert float(np.abs(g.numpy() - np.asarray(g_rel)).max()) < 5e-4
    for proj, leaves in g_params["params"].items():
        for leaf, want in leaves.items():
            assert float(np.abs(grads[f"{proj}.{leaf}"].numpy() - np.asarray(want)).max()) < 5e-4
    ym, gm, gradsm = outs["module"]
    assert float((ym - y)[tvalid].abs().max()) < 2e-5
    assert float((gm - g).abs().max()) < 5e-4
    assert all(float((gradsm[n] - grads[n]).abs().max()) < 5e-4 for n in grads)
