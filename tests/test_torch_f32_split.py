"""The f32 routes' arithmetic -- three bf16 pieces per f32 operand, six bf16
products per f32 product -- on CPU, and the f32 calls' scratch and split on
a simulated card.

K1's f32 route and the f32 backward (``csrc/flash_fwd_f32.cu``,
``csrc/flash_bwd_f32.cu``) multiply the bf16 pieces that the split, which
their C entries launch first, writes (``csrc/split_bf16x3.cu``): x ≈ x0 + x1 + x2, a·b ≈ a0b0 + a0b1 + a1b0 +
a0b2 + a1b1 + a2b0 summed in f32, the arithmetic of the JAX kernels'
``Precision.HIGHEST`` on the TPU. The kernels run only on the card
(``python3 chip_smoke.py``, ``phase_f32_check``); here:

* the plain split (``f32_split.split_reference``, the kernel's plain version,
  bit for bit on the card): bf16 pieces, each at most 2^-8 of the one before,
  whose sum is x within 2^-24 |x| (plus half of bf16's smallest subnormal,
  2^-134, where the pieces fall below bf16's normal range);
* a plain emulation of the six products against the f64 product, at least as
  accurate as 3xTF32 (the arithmetic of the mma.sync bodies these kernels
  replaced) on the same inputs;
* a forward and backward computed with that arithmetic (S, P V, dP, dV, dK,
  dQ) against the JAX K1 and ``jax.vjp`` of the JAX ``flash_attention`` (its
  Pallas kernels in interpret mode, as the JAX tests run them on CPU), q and k
  at 4x unit scale: within FWD_TOL / BWD_TOL[f32] with three pieces, outside
  them with one piece (plain bf16), so the budgets are shown to bite;
* the scratch that a C entry splits into, read back part by part by
  ``f32_split.operands`` (as ``chip_smoke.py`` reads the card's), and on a
  simulated card (meta tensors, the device checks off, a stand-in library)
  the f32 forward and backward each making one C call with the scratch its
  split writes, one split launch counted beside each kernel's (the two C
  entries' own packing: ``tests/test_torch_dtypes.py``).

Runs in ~30 s: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_f32_split.py``.
"""

import contextlib
import ctypes
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, check_close, make_qkv

# What the split leaves of x: 2^-24 |x|, and below bf16's normal range (2^-126)
# half of its smallest subnormal (2^-133), which the last piece cannot resolve.
SPLIT_REL = 2.0 ** -24
SPLIT_ABS = 2.0 ** -134
# Finite f32 whose first piece stays finite: below bf16's largest value, 3.39e38.
BF16_SAFE = float(np.float32(3.38e38))
GROW = 4.0  # q and k at 4x unit scale: logits reach ~30, a dropped product shows
# (A piece, B piece) of the six products, and of a single bf16 product.
SIX = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
ONE = ((0, 0),)


def _pieces(x: torch.Tensor, n: int = 3) -> list[torch.Tensor]:
    """The first ``n`` bf16 pieces of ``x`` [..., D] as f32 tensors, by the
    plain split."""
    flat = x.reshape(1, 1, -1, x.shape[-1])
    out = f32_split.split_reference(flat)[:n, 0, 0, :, :x.shape[-1]]
    return [p.float().reshape(x.shape) for p in out]


def _check_split(x: torch.Tensor) -> None:
    x0, x1, x2 = _pieces(x)
    err = (x0 + x1 + x2 - x).abs()
    assert bool((err <= SPLIT_REL * x.abs() + SPLIT_ABS).all()), err.max()
    assert bool((x1.abs() <= 2.0 ** -8 * x0.abs()).all())
    assert bool((x2.abs() <= 2.0 ** -8 * x1.abs()).all())


SPECIAL = [0.0, -0.0, 1.0, -1.0, 2.0, 0.5, 2.0 ** -20, 2.0 ** 100, -(2.0 ** -100), 1e38, -3e38,
           3.3895e38, 1e-30, -1e-37, 1.2e-38, 1e-40, -1.4e-45, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24,
           np.float32(np.pi), -np.float32(np.e) * 1e20]


def test_split_special_values():
    """Zeros of both signs, powers of two, f32's largest and smallest
    exponents, subnormals and values one ulp off a power of two."""
    x = torch.tensor(SPECIAL, dtype=torch.float32)
    _check_split(x)
    x0, x1, x2 = _pieces(x)
    assert bool((x0[:2] == 0).all()) and bool(torch.signbit(x0[1]))  # -0 keeps its sign
    assert torch.equal(x0[2:6], x[2:6])  # powers of two: one piece, exact
    assert bool((x1[2:6] == 0).all()) and bool((x2[2:6] == 0).all())


def test_split_random_values_reconstruct_x():
    """Normal draws at unit, 4x and tiny scales, through the [B, H, N, D]
    layout with a ragged D (zeros past D in the 64-column box)."""
    rng = np.random.default_rng(7)
    for scale in (1.0, 4.0, 1e-30, 1e30):
        x = torch.from_numpy(rng.standard_normal((2, 3, 17, 40)).astype(np.float32) * scale)
        _check_split(x)
        pieces = f32_split.split_reference(x)
        assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, 2, 3, 17, 64)
        assert bool((pieces[..., 40:] == 0).all())


@settings(max_examples=200, deadline=None, database=None)
@given(st.floats(min_value=-BF16_SAFE, max_value=BF16_SAFE, allow_nan=False, width=32))
def test_split_any_finite_value(v):
    """Any finite f32 below bf16's largest value."""
    _check_split(torch.tensor([v], dtype=torch.float32))


def test_pieces_layout_and_scratch():
    """Piece p of batch b is batch p·B + b of a [3B, H, N, DB] tensor, the
    layout the f32 kernels' TMA maps address; the scratch that their C
    entries split into holds three DB-column pieces of every Q (and dO) row
    and of K's and V's rows."""
    x = make_qkv(8, 2, 3, 5, 24)[0]
    pieces = f32_split.split_reference(x)
    flat = pieces.view(6, 3, 5, 64)
    for p in range(3):
        for b in range(2):
            assert torch.equal(flat[p * 2 + b], pieces[p, b])
    scratch = f32_split.scratch(2 * 3 * 5, 2 * 1 * 7, 24, "cpu")
    assert scratch.dtype == torch.bfloat16 and scratch.numel() == 3 * 64 * (30 + 2 * 14)
    assert f32_split.scratch(10, 4, 72, "cpu").numel() == 3 * 128 * (10 + 8)


@pytest.mark.parametrize("D", [40, 64, 111, 128])
def test_operands_name_the_parts_of_the_scratch(D):
    """The backward's scratch as its C entry fills it -- q's pieces, then k's
    and v's cut to kv_valid_len, then dO's, each laid out as
    split_reference's -- read back part by part by f32_split.operands; a
    shape list that does not fill the scratch raises."""
    B, Hq, Hkv, N, kv_len = 2, 4, 2, 20, 13
    q, k, v = make_qkv(13, B, Hq, N, D, Hkv=Hkv)
    do = make_qkv(14, B, Hq, N, D)[0]
    parts = [f32_split.split_reference(x) for x in (q, k[:, :, :kv_len], v[:, :, :kv_len], do)]
    pieces = f32_split.scratch(2 * B * Hq * N, B * Hkv * kv_len, D, "cpu")
    pieces.copy_(torch.cat([x.reshape(-1) for x in parts]))
    shapes = [(B, Hq, N), (B, Hkv, kv_len), (B, Hkv, kv_len), (B, Hq, N)]
    got = f32_split.operands(pieces, shapes, D)
    assert [x.shape for x in got] == [x.shape for x in parts]
    assert all(torch.equal(a, b) for a, b in zip(got, parts))
    with pytest.raises(ValueError, match="of the scratch"):
        f32_split.operands(pieces, shapes[:3], D)


# ---------------------------------------------------------------------------
# The six-product arithmetic.


def _mm(a: torch.Tensor, b: torch.Tensor, pairs=SIX) -> torch.Tensor:
    """a @ b as the kernels compute it: the bf16 pieces' products of
    ``pairs``, each exact in f32 (a bf16 product has 16 significant bits), summed
    in f32, the small ones first."""
    pa, pb = _pieces(a), _pieces(b.transpose(-1, -2).contiguous())
    out = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    for i, j in pairs:
        out = out + pa[i] @ pb[j].transpose(-1, -2)
    return out


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("scale", [1.0, GROW])
def test_six_products_beat_3xtf32(scale):
    """Against the f64 product of the same f32 matrices, the six bf16
    products are at least as accurate as 3xTF32, and within f32's own
    summation bound K 2^-24 (|A| |B|)."""
    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.standard_normal((96, 128)).astype(np.float32) * scale)
    b = torch.from_numpy(rng.standard_normal((128, 80)).astype(np.float32) * scale)
    exact = a.double() @ b.double()
    err6 = (_mm(a, b).double() - exact).abs()
    err3 = (_mm_3xtf32(a, b).double() - exact).abs()
    assert err6.max() <= err3.max(), (err6.max(), err3.max())
    assert bool((err6 <= 128 * 2.0 ** -24 * (a.abs().double() @ b.abs().double())).all())


def _attention(q, k, v, do, *, causal: bool, pairs):
    """O and (dQ, dK, dV) for q, k, v [B, H, N, D] (one KV head per query
    head) with every product taken as ``_mm`` over ``pairs``: S = Q Kᵀ, O = P
    V / l; with the LSE, P again, dP = dO Vᵀ, dS = P (dP − Δ) scale, dV = Pᵀ
    dO, dK = dSᵀ Q, dQ = dS K -- the f32 kernels' products, in f32."""
    scale = q.shape[-1] ** -0.5
    s = _mm(q, k.transpose(-1, -2), pairs) * scale
    if causal:
        n, m = s.shape[-2:]
        s = s.masked_fill(torch.ones(n, m, dtype=torch.bool).triu(1), -torch.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = _mm(p, v, pairs)
    delta = (do * o).sum(-1, keepdim=True)
    dp = _mm(do, v.transpose(-1, -2), pairs)
    ds = p * (dp - delta) * scale
    return o, (_mm(ds, k, pairs), _mm(ds.transpose(-1, -2), q, pairs),
               _mm(p.transpose(-1, -2), do, pairs))


def _jax_attention(q, k, v, do, *, causal: bool):
    o, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(a, b, c, causal=causal),
                     *(np.asarray(x.numpy()) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(np.asarray(do.numpy()))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_six_product_attention_matches_jax_and_one_product_does_not(causal):
    """The forward and backward in the six-product arithmetic hold
    FWD_TOL / BWD_TOL[f32] against the JAX kernels at 4x scale; the same
    computation on one bf16 product (plain bf16 operands) fails them."""
    q, k, v = make_qkv(11, 1, 2, 96, 64)
    do = make_qkv(12, 1, 2, 96, 64)[0]
    q, k = GROW * q, GROW * k
    o_want, grads_want = _jax_attention(q, k, v, do, causal=causal)
    o, grads = _attention(q, k, v, do, causal=causal, pairs=SIX)
    ok, msg = check_close(o, o_want, FWD_TOL[torch.float32], "o")
    assert ok, msg
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_want):
        ok, msg = check_close(g, w, BWD_TOL[torch.float32], name)
        assert ok, msg
    o1, grads1 = _attention(q, k, v, do, causal=causal, pairs=ONE)
    assert not check_close(o1, o_want, FWD_TOL[torch.float32], "o")[0]
    assert not any(check_close(g, w, BWD_TOL[torch.float32], "g")[0]
                   for g, w in zip(grads1, grads_want))


# ---------------------------------------------------------------------------
# The f32 calls on a simulated card, through ctypes stand-ins of the C
# entries with their argtypes.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


def _f32_counters():
    """The f32 wrappers' launch counters: K1's split and kernel, then the
    backward's."""
    return (flash_fwd.fwd.launches_split, flash_fwd.fwd.launches_f32,
            flash_bwd._f32_bwd_launch.launches_split, flash_bwd._f32_bwd_launch.launches)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' device checks are off,
    a stand-in library with the f32 entries' argtypes records each call, and
    the scratch each f32 call allocates is recorded too."""
    calls, scratch = [], []
    typed = {"fa_fwd_f32": native.FWD_F32_ARGTYPES, "fa_bwd_f32": native.BWD_F32_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    make = f32_split.scratch
    monkeypatch.setattr(f32_split, "scratch",
                        lambda *a: scratch.append(make(*a)) or scratch[-1])
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls, scratch


@pytest.mark.parametrize("packed", [False, True], ids=["causal", "packed"])
def test_f32_calls_split_once_before_each_kernel(card, packed):
    """An f32 flash_attention forward and backward on the simulated card:
    one C call each (fa_fwd_f32, then fa_bwd_f32: K3's or the split route's
    call), each given a scratch for the pieces of q, k, v (and dO) -- k's and
    v's rows only up to kv_valid_len --, and one split launch counted for
    each beside the kernel's."""
    calls, scratch = card
    B, Hq, Hkv, N, D = 2, 4, 2, 256, 80
    q = torch.empty((B, N, Hq, D), device="meta").transpose(1, 2).requires_grad_(True)
    k, v = (torch.empty((B, N, Hkv, D), device="meta").transpose(1, 2) for _ in "kv")
    ids = torch.zeros((B, N), dtype=torch.int32, device="meta") if packed else None
    before = _f32_counters()
    o = flashattn_tpu_torch.flash_attention(q, k, v, causal=True, segment_ids=ids)
    o.backward(torch.empty_like(o))
    assert [name for name, _ in calls] == ["fa_fwd_f32", "fa_bwd_f32"]
    assert tuple(a - b for a, b in zip(_f32_counters(), before)) == (1, 1, 1, 1)
    rows, kv_rows = B * Hq * N, B * Hkv * N
    assert [x.numel() for x in scratch] == [3 * 128 * (rows + 2 * kv_rows),
                                            3 * 128 * (2 * rows + 2 * kv_rows)]
    qs, kvs = (B, Hq, N), (B, Hkv, N)  # the parts operands() reads back on the card
    assert len(f32_split.operands(scratch[0], [qs, kvs, kvs], D)) == 3
    assert len(f32_split.operands(scratch[1], [qs, kvs, kvs, qs], D)) == 4
    fwd_args, bwd_args = calls[0][1], calls[1][1]
    assert len(fwd_args) == 41 and fwd_args[14] == D and fwd_args[23:26] == (N * Hq * D, D, Hq * D)
    assert len(bwd_args) == 47 and bwd_args[19] == D and bwd_args[14:17] == (B, Hq, Hkv)
    assert fwd_args[36] is None and bwd_args[41:43] == (None, None)  # no bias, no dbias
