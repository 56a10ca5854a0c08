"""f32 at head dims 136-256 -- K1's f32 route's D 256 form
(``csrc/flash_fwd_f32.cu``, ``fwd_f32_wide_kernel``: 64 Q rows a CTA) and
the f32 backward's (``csrc/flash_bwd_f32.cu``, ``bwd_f32_kernel<256, ...>``:
a cluster of two CTAs that split D), with their bias families -- against
the JAX package on CPU.

The kernels run only on the card (``python3 chip_smoke.py``:
``phase_f32_wide_check`` holds them against their plain versions there,
``phase_f32_wide_train`` trains the f32 LM and f32 path A with heads of 256).
Here:

* the f32 plain versions at D 136 / 192 / 256 -- ``flash_attention`` on CPU
  tensors, its plain K1 then K3's, the split route's or the bias backward's
  plain version -- against the JAX ``flash_attention`` and ``jax.vjp`` (its
  Pallas kernels in interpret mode) on the same numpy inputs: causal, a
  window, segment ids, offsets, the cap, GQA, Nq 1, every option at once;
  the eight broadcast shapes of a bias and the key-padding bias with dead
  rows, with dbias and without; a ragged kv_valid_len against the JAX
  function on the valid keys. Budgets FWD_TOL / BWD_TOL[f32];
* the walk of the D 256 form's two consumers (``chip_smoke.f32_bwd_walk``):
  dQ / dK / dV / dbias against JAX where the walk skips Q tiles by the ids,
  leaves KV tiles unvisited or gives a KV tile one Q tile, dbias exactly 0
  on the skipped pairs in both and ``dbias_skips`` true exactly then;
* the split's pieces at D 136 in the 256 box (``f32_split``);
* the routes on a simulated card (meta tensors, the device checks off, a
  stand-in library recording each C entry): f32 at D 136-256 reaches
  ``fa_fwd_f32`` and ``fa_bwd_f32`` and counts one D 256 launch of each,
  never a bf16 entry; f32 at D 264 raises naming "K1 options";
* the C arguments of a D 256 f32 launch through stand-ins with the entries'
  argtypes, the pieces' scratch at the 256 box;
* the f32 LM with 2 heads of 256 (d_model 512, 2 layers, 32 tokens) against
  the JAX ``lm_loss`` and ``jax.grad`` on weights carried by
  ``models/convert.py``, plain, capped and packed: loss within 1e-5, every
  gradient within BWD_TOL[f32];
* the f32 torch.nn module with 2 heads of 256 against the flax module, with
  two key-padding masks, on the rows that have keys.
"""

import contextlib
import ctypes
import dataclasses
import itertools
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import flashattn_tpu
import flashattn_tpu_torch
from flashattn_tpu.integrations import flax_linen
from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu_torch.integrations import make_attention_mask
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import _flatten, mhdpa_from_flax, transformer_from_jax
from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_bwd_fused, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32 = torch.float32
F32_FWD, F32_BWD = FWD_TOL[F32], BWD_TOL[F32]


def _ids(seed, B, N):
    """Sorted packed ids [B, N]: three runs of random lengths."""
    rng = np.random.default_rng(seed)
    out = np.zeros((B, N), np.int32)
    for row in out:
        for c in np.sort(rng.choice(np.arange(1, N), 2, replace=False)):
            row[c:] += 1
    return out


def _bias(kind, seed, B, Hq, Nq, Nk):
    """An f32 numpy bias: "padding" the key-padding bias [B, 1, Nq, Nk] of
    lengths (Nq, Nq / 2) (the second row's queries past Nq / 2 see no key:
    dead rows), else a normal bias with the (batch, head, row) dims that
    ``kind`` flags, 1 on the others."""
    if kind == "padding":
        lengths = np.array([Nq, Nq // 2])[:B]
        keep_q = np.arange(Nq)[None] < lengths[:, None]
        keep_k = np.arange(Nk)[None] < lengths[:, None]
        pair = keep_q[:, None, :, None] & keep_k[:, None, None, :]
        return np.where(pair, 0.0, DEFAULT_MASK_VALUE).astype(np.float32)
    shape = tuple(n if f else 1 for n, f in zip((B, Hq, Nq), kind)) + (Nk,)
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# (name, B, Hq, Hkv, Nq, Nk, D, bias kind or None, options): D 136 and 192 run
# in the kernels' 256 box.
CASES = [
    ("D 256 causal GQA 4/2", 1, 4, 2, 64, 64, 256, None, dict(causal=True)),
    ("D 192 window", 1, 2, 2, 80, 80, 192, None, dict(window=(16, 8))),
    ("D 136 segment ids", 2, 2, 1, 64, 64, 136, None, dict(segment_ids=True)),
    ("D 256 causal offsets", 1, 2, 1, 48, 80, 256, None,
     dict(causal=True, q_offset=48, kv_offset=16)),
    ("D 192 cap 5", 1, 2, 2, 64, 64, 192, None, dict(logit_softcap=5.0)),
    ("D 256 Nq 1", 2, 4, 2, 1, 80, 256, None, {}),
    ("D 136 everything", 2, 2, 1, 64, 64, 136, None,
     dict(causal=True, window=(40, -1), segment_ids=True, logit_softcap=5.0)),
    ("D 192 padding bias, dead rows", 2, 2, 2, 48, 48, 192, "padding", {}),
    ("D 136 bias, everything", 2, 2, 1, 64, 64, 136, (1, 1, 1),
     dict(causal=True, window=(40, -1), segment_ids=True, logit_softcap=5.0)),
]
# Every broadcast shape of the bias [B|1, H|1, Nq|1, Nk] at D 256.
BROADCASTS = [("D 256 bias " + "".join("BHQ"[i] if f else "1" for i, f in enumerate(dims)),
               2, 2, 2, 32, 32, 256, dims, {})
              for dims in itertools.product((0, 1), repeat=3)]


def _inputs(case):
    name, B, Hq, Hkv, Nq, Nk, D, kind, opts = case
    seed = sum(map(ord, name))
    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(seed + 1, B, Hq, Nq, D)[0]
    kw = dict(opts)
    if kw.get("segment_ids"):
        kw["segment_ids"] = _ids(seed + 3, B, Nq)
    bias = None if kind is None else _bias(kind, seed + 2, B, Hq, Nq, Nk)
    return q, k, v, do, bias, kw


def _jax(q, k, v, do, bias, kw):
    """The JAX flash_attention's O and jax.vjp's (dQ, dK, dV[, dbias])."""
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    args = [jnp.asarray(x.numpy()) for x in (q, k, v)]
    if bias is None:
        o, vjp = jax.vjp(lambda a, b, c: flashattn_tpu.flash_attention(a, b, c, **jkw), *args)
    else:
        o, vjp = jax.vjp(lambda a, b, c, d: flashattn_tpu.flash_attention(a, b, c, bias=d, **jkw),
                         *args, jnp.asarray(bias))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


def _port(q, k, v, do, bias, kw, *, dbias: bool):
    """The port's flash_attention on the CPU and its gradients (dbias too
    when ``dbias``: the bias a leaf)."""
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    tbias = None if bias is None else torch.from_numpy(bias).requires_grad_(dbias)
    if dbias:
        leaves.append(tbias)
    o = flashattn_tpu_torch.flash_attention(*leaves[:3], bias=tbias, **tkw)
    return o.detach(), torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("case", CASES + BROADCASTS, ids=[c[0] for c in CASES + BROADCASTS])
def test_f32_wide_matches_jax(case):
    """O within FWD_TOL[f32] and dQ, dK, dV (and, with a bias, dbias summed
    over its broadcast dims, as both return it) within BWD_TOL[f32]; with a
    bias the backward also without dbias (the bias no leaf), its dQ, dK, dV
    the same; dead rows' O and dQ exactly 0."""
    q, k, v, do, bias, kw = _inputs(case)
    want_o, want_g = _jax(q, k, v, do, bias, kw)
    o, grads = _port(q, k, v, do, bias, kw, dbias=bias is not None)
    assert o.dtype == F32
    assert_close(o, want_o, F32_FWD, "O")
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads, want_g):
        assert tuple(got.shape) == want.shape, name
        assert_close(got, want, F32_BWD, name)
    if bias is not None:
        _, plain = _port(q, k, v, do, bias, kw, dbias=False)
        for name, got, want in zip(("dq", "dk", "dv"), plain, want_g):
            assert_close(got, want, F32_BWD, f"{name} without dbias")
    if case[7] == "padding":
        dead = torch.from_numpy(bias[:, 0].max(-1) <= DEFAULT_MASK_VALUE)
        dead = dead[:, None].expand(-1, q.shape[1], -1)
        assert dead.any() and (o[dead] == 0).all() and (grads[0][dead] == 0).all()


# The D 256 form's walk (chip_smoke.f32_bwd_walk; each cluster's two
# consumers take its KV tile's visits in turn): (name, B, Hq, Hkv, Nq, Nk, D,
# options). Ids whose 32-row Q tiles and 64-key KV tiles alternate 0 / 1
# skip every other Q tile (every row still sees keys); causal keys past Nq
# leave whole KV tiles unvisited; Nq 20 gives each KV tile one Q tile.
WALKS = [("D 256 ids skipping every other Q tile", 2, 2, 1, 150, 160, 256, dict(ids=True)),
         ("D 192 causal, KV tiles no Q tile meets", 1, 2, 2, 100, 300, 192,
          dict(causal=True)),
         ("D 256 one Q tile a KV tile", 2, 2, 2, 20, 300, 256, {})]


@pytest.mark.parametrize("case", WALKS, ids=[c[0] for c in WALKS])
def test_f32_wide_walk_matches_jax_and_leaves_skipped_pairs_zero(case):
    """With a full [B, Hq, Nq, Nk] bias: dQ, dK, dV and dbias of the port's
    flash_attention (CPU, the plain bias route) against jax.vjp of the JAX
    flash_attention within BWD_TOL[f32]; dbias exactly 0, in both, on every
    pair of the (Q tile, KV tile) pairs the f32 body leaves unvisited, and
    dbias_skips asks for the zero fill exactly when there are such pairs."""
    name, B, Hq, Hkv, Nq, Nk, D, opts = case
    q, k, v = make_qkv(51, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(52, B, Hq, Nq, D)[0]
    bias = np.random.default_rng(53).standard_normal((B, Hq, Nq, Nk), dtype=np.float32)
    kw = dict(causal=opts.get("causal", False))
    qt, kt = flash_bwd.F32_BWD_Q_TILE, flash_bwd.F32_BWD_KV_TILE
    if opts.get("ids"):
        kw["segment_ids"] = tuple(
            np.broadcast_to((np.arange(n) // t % 2).astype(np.int32), (B, n)).copy()
            for n, t in ((Nq, qt), (Nk, kt)))
    want = _jax(q, k, v, do, bias, kw)[1]
    _, got = _port(q, k, v, do, bias, kw, dbias=True)
    for n, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert_close(g, w, F32_BWD, n)
    seg = kw.get("segment_ids")
    seg = None if seg is None else tuple(torch.from_numpy(x) for x in seg)
    walk = chip_smoke.f32_bwd_walk(Nq, Nk, causal=kw["causal"], segment_ids=seg)
    skipped = (~walk).repeat_interleave(qt, 1)[:, :Nq].repeat_interleave(kt, 2)[:, :, :Nk]
    skipped = skipped[:, None].expand(B, Hq, Nq, Nk)
    assert (got[3][skipped] == 0).all() and (torch.from_numpy(want[3].copy())[skipped] == 0).all()
    assert flash_bwd.dbias_skips(causal=kw["causal"], window=None, segment_ids=seg,
                                 kv_valid_len=Nk, nk=Nk) == bool(skipped.any())


@pytest.mark.parametrize("D", [136, 256])
@pytest.mark.parametrize("route", ["K3", "split"])
def test_ragged_kv_valid_len_matches_jax_on_the_valid_keys(D, route):
    """kv_valid_len 50 of Nk 64, GQA 4/2: the plain K1 and the plain K3 (or,
    with the cap, the split route) against the JAX function on K / V cut to
    the 50 valid keys; the cut keys' dK / dV exactly 0."""
    B, Hq, Hkv, Nq, Nk, kvl = 2, 4, 2, 40, 64, 50
    q, k, v = make_qkv(D + 7, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(D + 8, B, Hq, Nq, D)[0]
    cap = 5.0 if route == "split" else None
    kw = dict(scale=D ** -0.5, kv_valid_len=kvl, causal=True, softcap=cap)
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    args = (q, k, v, do, lse, (do * o).sum(-1))
    if route == "split":
        dq, dk, dv = flash_bwd.split_bwd(*args, **kw)
    else:
        kw.pop("softcap")
        dq, dk, dv = flash_bwd_fused.bwd(*args, **kw)
    dk, dv = (x.view(B, Hkv, Hq // Hkv, Nk, D).sum(2) for x in (dk, dv))
    jkw = dict(causal=True, **({} if cap is None else dict(logit_softcap=cap)))
    want_o, want_g = _jax(q, k[:, :, :kvl], v[:, :, :kvl], do, None, jkw)
    assert_close(o, want_o, F32_FWD, "O")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk[:, :, :kvl], dv[:, :, :kvl]), want_g):
        assert_close(got, want, F32_BWD, name)
    assert (dk[:, :, kvl:] == 0).all() and (dv[:, :, kvl:] == 0).all()


@pytest.mark.parametrize("D", [136, 192, 256])
def test_the_split_takes_the_256_box(D):
    """Above D 128 the pieces come in the 256 box: three bf16 pieces whose
    sum is x to f32's rounding, zeros past D, and the scratch of a call
    sized for that box."""
    x = make_qkv(D, 1, 2, 24, D)[0] * 3.0
    pieces = f32_split.split_reference(x)
    assert f32_split.d_box(D) == 256 and pieces.shape == (3, 1, 2, 24, 256)
    assert (pieces[..., D:] == 0).all()
    err = (pieces.float().sum(0)[..., :D] - x).abs() / x.abs().clamp_min(1e-30)
    assert float(err.max()) <= 2.0 ** -22
    assert f32_split.scratch(10, 7, D, "cpu").numel() == 3 * 256 * (10 + 2 * 7)


# ---------------------------------------------------------------------------
# The routes on a simulated card.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


BF16_ENTRIES = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
                "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES,
                "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
                "fa_bwd_bias_sm90": native.BWD_BIAS_SM90_ARGTYPES}


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: K1's checks and the backward's
    device test are off (the backward keeps its head-dim and dtype checks,
    ``flash_bwd.check_kernel_dims``), and the stand-in library records the
    name and arguments of every C entry called, the bf16 ones too."""
    calls = []
    typed = {**BF16_ENTRIES, "fa_fwd_f32": native.FWD_F32_ARGTYPES,
             "fa_bwd_f32": native.BWD_F32_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    for name in ("fa_fwd_quant_sm90", "fa_decode"):
        setattr(lib, name, lambda *args, name=name: calls.append((name, args)) or 0)
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    dims = flash_bwd.check_kernel_dims
    monkeypatch.setattr(flash_bwd, "check_kernel_args", dims)
    monkeypatch.setattr(flash_bwd_fused, "check_kernel_args", dims)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta_qkv(B, Hq, Hkv, Nq, Nk, D, dtype=F32):
    q = torch.empty((B, Nq, Hq, D), dtype=dtype, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=dtype, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


# (D, N, options): K3, the split route (the cap, ids), the bias route (with
# and without dbias), decode-shaped, GQA.
ROUTES = {"causal D 256": (256, 300, dict(causal=True)),
          "window D 192": (192, 300, dict(causal=True, window=(100, -1))),
          "softcap D 256": (256, 300, dict(causal=True, logit_softcap=50.0)),
          "packed D 136": (136, 200, dict(causal=True, segment_ids=True)),
          "bias D 256": (256, 200, dict(bias="leaf")),
          "bias without dbias D 160": (160, 200, dict(bias="const", causal=True)),
          "decode-shaped D 256": (256, 1, {})}


@pytest.mark.parametrize("case", list(ROUTES))
def test_f32_wide_head_dims_reach_the_f32_d256_forms(card, case):
    """Forward and backward through flash_attention: exactly fa_fwd_f32 then
    fa_bwd_f32, each counted once as its D 256 form (and the bias backward's
    launch as an f32 one, with dbias when the bias is a leaf), no bf16
    entry; the head dim in each call's D argument."""
    D, N, opts = ROUTES[case]
    B, Hq, Hkv = 2, 8, 4
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(B, Hq, Hkv, N, 300, D))
    kw = dict(opts)
    leaves = [q, k, v]
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = (torch.zeros((B, N), dtype=torch.int32, device="meta"),
                             torch.zeros((B, 300), dtype=torch.int32, device="meta"))
    bias_kind = kw.pop("bias", None)
    if bias_kind is not None:
        kw["bias"] = torch.empty((1, Hq, N, 300), device="meta")
        if bias_kind == "leaf":
            kw["bias"].requires_grad_(True)
            leaves.append(kw["bias"])
    counters = lambda: (flash_fwd.fwd.launches_f32_d256,  # noqa: E731
                        flash_bwd._f32_bwd_launch.launches_d256, flash_fwd.fwd.launches_f32,
                        flash_bwd._f32_bwd_launch.launches, flash_bwd.bias_bwd.launches_dbias)
    before = counters()
    o = flashattn_tpu_torch.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(o, leaves, torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_f32", "fa_bwd_f32"]
    assert not set(BF16_ENTRIES) & {name for name, _ in card}
    assert card[0][1][14] == D and card[1][1][19] == D  # the head dim each C entry takes
    assert [g.shape for g in grads] == [x.shape for x in leaves]
    dbias = int(bias_kind == "leaf")
    assert counters() == (before[0] + 1, before[1] + 1, before[2] + 1, before[3] + 1,
                          before[4] + dbias)


def test_the_d128_f32_calls_do_not_count_as_d256(card):
    q, k, v = (x.requires_grad_(True) for x in _meta_qkv(1, 4, 2, 128, 128, 128))
    before = flash_fwd.fwd.launches_f32_d256, flash_bwd._f32_bwd_launch.launches_d256
    o = flashattn_tpu_torch.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert [name for name, _ in card] == ["fa_fwd_f32", "fa_bwd_f32"]
    assert (flash_fwd.fwd.launches_f32_d256, flash_bwd._f32_bwd_launch.launches_d256) == before


def _fake_cuda(D, dtype=F32):
    return types.SimpleNamespace(shape=(1, 4, 64, D), dtype=dtype,
                                 device=types.SimpleNamespace(type="cuda"))


@pytest.mark.parametrize("D", [136, 192, 256])
def test_f32_wide_passes_the_card_checks(D):
    """K1's checks and the backward's pass f32 at D 136-256 with a bias, ids,
    a window and offsets; every backward route takes it."""
    flash_fwd._check_kernel_args(_fake_cuda(D), segment_ids=(1, 1), bias=object(),
                                 k_scale=None, windowed=True, offsets=True)
    flash_bwd.check_kernel_args(_fake_cuda(D), "K5 + K6 bias route")
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=F32)
    assert flash_bwd.split_sm90_route(head_dim=D, bias=None, dtype=F32, segment_ids=(1, 1),
                                      softcap=None)


@pytest.mark.parametrize("where", ["K1", "K3", "split", "bias"])
def test_f32_d264_raises_naming_k1_options(where):
    """f32 at D 264, as bf16 there: every CUDA entry refuses it, naming ROADMAP
    queue 2's K1 options."""
    match = "ROADMAP queue 2, K1 options: head dims above 256"
    with pytest.raises(NotImplementedError, match=match):
        if where == "K1":
            flash_fwd._check_kernel_args(_fake_cuda(264), segment_ids=None, bias=None,
                                         k_scale=None, windowed=False)
        else:
            name = {"K3": "K3", "split": "K5 + K6 split route", "bias": "K5 + K6 bias route"}
            flash_bwd.check_kernel_args(_fake_cuda(264), name[where])


# ---------------------------------------------------------------------------
# The C arguments of a D 256 f32 launch.


def _bnhd(*xs):
    return tuple(x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs)


def test_f32_d256_forward_packs_the_c_arguments():
    """fa_fwd_f32 at D 192 (the D 256 form) on BNHD views with GQA, the cap,
    ids at the f32 route's 128-row tiles (its D 256 form reads them too) and
    a bias: the pieces' scratch in the 256 box."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 200, 150, 192
    q, k, v = _bnhd(*make_qkv(60, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    o, lse = torch.empty_like(q), torch.empty((B, Hq, Nq))
    pieces = f32_split.scratch(B * Hq * Nq, B * Hkv * 140, D, "cpu")
    assert pieces.numel() == 3 * 256 * (B * Hq * Nq + 2 * B * Hkv * 140)
    ids = (torch.arange(Nq).repeat(B, 1) // 50, torch.arange(Nk).repeat(B, 1) // 50)
    seg = flash_fwd.sm90_segments(ids, Nq, 140, q_tile=flash_fwd.F32_Q_TILE,
                                  kv_tile=flash_fwd.F32_KV_TILE)
    assert seg[2].shape == (B, 2, 2)  # 128-row Q tiles
    bias, strides = flash_fwd.sm90_bias(torch.zeros((B, 1, 1, Nk)))
    seen = []
    lib = types.SimpleNamespace(fa_fwd_f32=_recorder("fa_fwd_f32", native.FWD_F32_ARGTYPES,
                                                     seen))
    rc = flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, seg, scale=0.07, kv_valid_len=140,
                                      causal=True, window=None, softcap=50.0, stream=4096,
                                      pieces=pieces, bias=bias, bias_strides=strides)
    assert rc == 0 and [name for name, _ in seen] == ["fa_fwd_f32"]
    args = seen[0][1]
    assert len(args) == len(native.FWD_F32_ARGTYPES)
    assert args[:6] == tuple(x.data_ptr() for x in (q, k, v, o, lse, pieces))
    assert args[6:10] == tuple(x.data_ptr() for x in seg)
    assert args[10:21] == (B, Hq, Hkv, Nq, D, 140, 1, -1, -1, 0, 0)
    assert args[21] == pytest.approx(0.07) and args[22] == 50.0
    assert args[23:26] == (Nq * Hq * D, D, Hq * D)
    # Nk 150 is not a multiple of 4: sm90_bias pads the rows to 152 columns.
    assert args[36:40] == (bias.data_ptr(), 152, 0, 0) and args[40] == 4096


def test_f32_d256_backward_packs_the_c_arguments():
    """fa_bwd_f32 at D 256 on BNHD views with GQA, a window, offsets, ids at
    the f32 body's tiles and a bias with dbias: the scratch in the 256 box."""
    B, Hq, Hkv, Nq, Nk, D = 2, 4, 2, 96, 130, 256
    q, k, v = _bnhd(*make_qkv(61, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv))
    do = q.clone()
    stats = torch.zeros((B, Hq, 96))
    dq = torch.zeros((B, Hq, Nq, D))
    dk, dv = torch.empty((B, Hq, Nk, D)), torch.empty((B, Hq, Nk, D))
    pieces = f32_split.scratch(2 * B * Hq * Nq, B * Hkv * 120, D, "cpu")
    assert pieces.numel() == 3 * 256 * (2 * B * Hq * Nq + 2 * B * Hkv * 120)
    ids = (torch.arange(Nq).repeat(B, 1) // 40, torch.arange(Nk).repeat(B, 1) // 40)
    seg = flash_fwd.sm90_segments(ids, Nq, 120, q_tile=flash_bwd.F32_BWD_Q_TILE,
                                  kv_tile=flash_bwd.F32_BWD_KV_TILE, pad_q=True)
    bias = torch.zeros((1, Hq, Nq, Nk))
    dbias = torch.empty((B, Hq, Nq, Nk))
    _, strides = flash_fwd.kernel_bias(bias)
    seen = []
    lib = types.SimpleNamespace(fa_bwd_f32=_recorder("fa_bwd_f32", native.BWD_F32_ARGTYPES,
                                                     seen))
    rc = flash_bwd._launch_split(lib, q, k, v, do, stats, stats, dq, dk, dv, seg, scale=0.25,
                                 causal=False, kv_valid_len=120, window=(64, 7), softcap=None,
                                 nq_pad=96, stream=4096, q_offset=96, kv_offset=-64,
                                 pieces=pieces, bias=bias, dbias=dbias, bias_strides=strides)
    assert rc == 0 and [name for name, _ in seen] == ["fa_bwd_f32"]
    args = seen[0][1]
    assert len(args) == len(native.BWD_F32_ARGTYPES)
    assert args[:10] == tuple(x.data_ptr()
                              for x in (q, k, v, do, stats, stats, dq, dk, dv, pieces))
    assert args[10:14] == tuple(x.data_ptr() for x in seg)
    assert args[14:24] == (B, Hq, Hkv, Nq, Nk, D, 120, 0, 64, 7)
    assert args[24:27] == (96, -64, 96)
    assert args[41:46] == (bias.data_ptr(), dbias.data_ptr(), 0, Nq * Nk, Nk)
    assert args[46] == 4096


# ---------------------------------------------------------------------------
# The f32 LM with heads of 256 and the f32 module against the JAX package.

WIDTH = dict(vocab_size=128, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1, d_head=256,
             d_ff=256)
JCFG = jax_lm.TransformerConfig(**WIDTH, dtype=jnp.float32)
PCFG = lm.TransformerConfig(**WIDTH, dtype=torch.float32)
TOKENS = np.random.default_rng(43).integers(0, 128, (2, 33)).astype(np.int32)
SEG = np.array([[0] * 10 + [1] * 23, [0] * 17 + [1] * 16], dtype=np.int32)
LM_VARIANTS = {"plain": ({}, None), "softcap": (dict(logit_softcap=2.0), None),
               "packed": ({}, SEG)}


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray,
                                  jax_lm.init_transformer(jax.random.PRNGKey(5), JCFG))


@pytest.mark.parametrize("variant", list(LM_VARIANTS))
def test_f32_lm_with_heads_of_256_matches_jax(jax_params, variant):
    opts, seg = LM_VARIANTS[variant]
    jcfg, pcfg = dataclasses.replace(JCFG, **opts), dataclasses.replace(PCFG, **opts)
    jseg = None if seg is None else jnp.asarray(seg)
    loss_want, grads_want = jax.value_and_grad(lambda p: jax_lm.lm_loss(
        p, jnp.asarray(TOKENS), jcfg, segment_ids=jseg))(jax_params)
    grads_want = dict(_flatten(jax.tree_util.tree_map(np.asarray, grads_want)))
    model = transformer_from_jax(jax_params, pcfg, device="cpu")
    assert all(p.dtype == F32 for p in model.parameters())
    loss = lm.lm_loss(model, torch.from_numpy(TOKENS).long(), pcfg,
                      segment_ids=None if seg is None else torch.from_numpy(seg))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert abs(loss.item() - float(loss_want)) < 1e-5
    assert grads.keys() == grads_want.keys()
    for name, g in grads.items():
        assert_close(g, grads_want[name], F32_BWD, name)


@pytest.mark.parametrize("lengths", [(40, 25), (17, 33)], ids=["40 + 25", "17 + 33"])
def test_f32_module_with_heads_of_256_matches_flax(lengths):
    """FlashMultiHeadDotProductAttention at its default float32 with 2 heads
    of 256 and a key-padding mask of ``lengths`` (the mask becomes a bias:
    K1's f32 route and the f32 bias backward at D 256 on the card) against
    the flax module on the same weights: the output on the rows that have
    keys within 2e-5, every parameter's gradient within 5e-4 (the
    integration tests' budgets)."""
    rng = np.random.default_rng(sum(lengths))
    N = 40
    x = rng.standard_normal((2, N, 32), dtype=np.float32)
    valid = np.arange(N)[None] < np.array(lengths)[:, None]
    ref = flax_linen.FlashMultiHeadDotProductAttention(num_heads=2, qkv_features=512)
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(34), x))
    mask = nn.make_attention_mask(valid, valid)

    def loss_jax(p):
        y = ref.apply(p, x, mask=mask)
        return ((y ** 2) * valid[..., None]).sum(), y

    (_, y_want), g_want = jax.value_and_grad(loss_jax, has_aux=True)(params)
    mod = mhdpa_from_flax(params, num_heads=2, impl="fused", device="cpu")
    assert mod.query.kernel.shape[-1] == 256 and mod.query.kernel.dtype == F32
    tmask = make_attention_mask(torch.from_numpy(valid), torch.from_numpy(valid),
                                dtype=torch.bool)
    y = mod(torch.from_numpy(x), mask=tmask)
    assert y.dtype == F32
    ((y ** 2) * torch.from_numpy(valid)[..., None]).sum().backward()
    assert float(np.abs(y.detach().numpy()[valid] - np.asarray(y_want)[valid]).max()) < 2e-5
    grads = dict(mod.named_parameters())
    for proj, leaves in g_want["params"].items():
        for leaf, want in leaves.items():
            diff = np.abs(grads[f"{proj}.{leaf}"].grad.numpy() - np.asarray(want)).max()
            assert diff < 5e-4, f"{proj}.{leaf}"
