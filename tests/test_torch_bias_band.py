"""A bias together with a window, segment ids or q / kv offsets: the port's
``flash_attention`` and its plain bias routes against the JAX package on
CPU, and the host glue of the Hopper bias routes on a simulated card.

On the card these calls take K1's bias route (``fwd_bias_sm90_kernel``, the
band as runtime ints, SEG with segment ids) and K5 + K6's
(``bwd_bias_sm90_kernel``), one launch each; ``python3 chip_smoke.py``'s
``phase_bias_band_check`` holds the kernels against their plain versions.
Here the same numpy inputs go through the port's plain versions (CPU
tensors) and the JAX ``flash_attention`` (its Pallas K1 / K5 / K6 in
interpret mode, as the JAX package's tests run them), forward and
``jax.vjp``: O within FWD_TOL[f32]; dQ, dK, dV and dbias (summed over the
bias's broadcast dims, as both return it) within BWD_TOL[f32]. Dead rows
come from a key-padding bias (every key at the mask value), and dbias is
exactly 0 on the pairs the band or the ids drop. The torch.nn module with a
window and a padding mask is held against the flax module
(``window=``, weights carried across by ``mhdpa_from_flax``). On the
simulated card (meta tensors, the device checks off, a stand-in library
recording each C entry's arguments): the routes take these calls, the
arguments reach ``fa_fwd_bias_sm90`` / ``fa_bwd_bias_sm90`` in their
argtypes' order with ``sm90_segments``' tensors, and dbias is allocated
zeroed wherever the band, the ids or the KV tail leave pairs unvisited.
"""

import contextlib
import ctypes
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
from flashattn_tpu.integrations import flax_linen
import flashattn_tpu_torch
from flashattn_tpu_torch.integrations import make_attention_mask
from flashattn_tpu_torch.models.convert import mhdpa_from_flax
from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import BWD_TOL, FWD_TOL, assert_close, make_qkv

F32_FWD, F32_BWD = FWD_TOL[torch.float32], BWD_TOL[torch.float32]


def _ids(seed, B, N, n_segs=3):
    """Sorted packed ids [B, N] with n_segs runs of random lengths."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(B):
        row = np.zeros(N, np.int32)
        for c in np.sort(rng.choice(np.arange(1, N), n_segs - 1, replace=False)):
            row[c:] += 1
        rows.append(row)
    return np.stack(rows)


def _bias(kind, seed, B, Hq, Nq, Nk):
    """f32 numpy biases: "padding" a key-padding bias [B, 1, Nq, Nk] of
    lengths (Nq, 0.6 Nq) (dead rows), "keys" a row-broadcast [B, 1, 1, Nk]
    with batch row 1's last 16 keys at the mask value, "learned" a normal
    [1, Hq, Nq, Nk], "full" a normal [B, Hq, Nq, Nk]."""
    rng = np.random.default_rng(seed)
    if kind == "padding":
        lengths = np.array([Nq, int(0.6 * Nq)])[:B]
        keep_q = np.arange(Nq)[None] < lengths[:, None]
        keep_k = np.arange(Nk)[None] < lengths[:, None]
        pair = keep_q[:, None, :, None] & keep_k[:, None, None, :]
        return np.where(pair, 0.0, DEFAULT_MASK_VALUE).astype(np.float32)
    if kind == "keys":
        bias = rng.standard_normal((B, 1, 1, Nk), dtype=np.float32)
        bias[1, ..., Nk - 16:] = DEFAULT_MASK_VALUE
        return bias
    shape = {"learned": (1, Hq, Nq, Nk), "full": (B, Hq, Nq, Nk)}[kind]
    return rng.standard_normal(shape, dtype=np.float32)


# (name, B, Hq, Hkv, Nq, Nk, D, bias kind, options): a window with path A's
# padding bias (dead rows) and a causal window with a row-broadcast key
# mask; segment ids with a full and with a learned bias (causal); causal
# with q / kv offsets (every row sees a key: the JAX reference's gradients
# are its oracle's there), a window with offsets and Nq < Nk; segment ids
# with the softcap, and every option at once.
CASES = [
    ("window, padding bias", 2, 4, 2, 130, 130, 32, "padding", dict(window=(16, 16))),
    ("causal window, key mask", 2, 4, 2, 130, 130, 32, "keys",
     dict(causal=True, window=(24, -1))),
    ("segment ids, full bias", 2, 4, 2, 130, 130, 32, "full", dict(segment_ids="ids")),
    ("segment ids, causal, learned bias", 2, 4, 4, 130, 130, 40, "learned",
     dict(causal=True, segment_ids="ids")),
    ("causal, offsets", 1, 4, 2, 96, 96, 32, "learned", dict(causal=True, q_offset=64)),
    ("window, offsets, Nq < Nk", 1, 4, 2, 96, 160, 32, "full",
     dict(window=(20, 8), q_offset=40, kv_offset=10)),
    ("segment ids, softcap", 2, 4, 2, 130, 130, 32, "keys",
     dict(segment_ids="ids", logit_softcap=5.0)),
    ("all at once", 2, 4, 2, 130, 130, 32, "full",
     dict(causal=True, window=(32, -1), segment_ids="ids", logit_softcap=5.0)),
]


def _inputs(case):
    name, B, Hq, Hkv, Nq, Nk, D, kind, opts = case
    seed = sum(map(ord, name))
    q, k, v = make_qkv(seed, B, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    do = make_qkv(seed + 1, B, Hq, Nq, D)[0]
    bias = _bias(kind, seed + 2, B, Hq, Nq, Nk)
    kw = dict(opts)
    if kw.get("segment_ids") == "ids":
        kw["segment_ids"] = _ids(seed + 3, B, Nq)
    return q, k, v, do, bias, kw


def _jax(q, k, v, do, bias, kw):
    """The JAX flash_attention's O and jax.vjp's (dQ, dK, dV, dbias)."""
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    o, vjp = jax.vjp(lambda a, b, c, d: flashattn_tpu.flash_attention(a, b, c, bias=d, **jkw),
                     *(jnp.asarray(x) for x in (q.numpy(), k.numpy(), v.numpy(), bias)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do.numpy()))]


def _port(q, k, v, do, bias, kw):
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    leaves.append(torch.from_numpy(bias).requires_grad_(True))
    o = flashattn_tpu_torch.flash_attention(*leaves[:3], bias=leaves[3], **tkw)
    return o.detach(), torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bias_with_band_or_ids_matches_jax(case):
    q, k, v, do, bias, kw = _inputs(case)
    o, grads = _port(q, k, v, do, bias, kw)
    want_o, want_g = _jax(q, k, v, do, bias, kw)
    assert_close(o, want_o, F32_FWD, "O")
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), grads, want_g):
        assert tuple(got.shape) == want.shape, name
        assert_close(got, want, F32_BWD, name)
    if case[7] == "padding":  # dead rows: O and their gradients exactly 0
        dead = torch.from_numpy(bias[:, 0].max(-1) <= DEFAULT_MASK_VALUE)
        dead = dead[:, None].expand(-1, q.shape[1], -1)
        assert dead.any() and (o[dead] == 0).all() and (grads[0][dead] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bias_bwd_reference_drops_masked_pairs(case):
    """bias_bwd_reference, the bias route's plain version, with the forward's
    LSE and Δ: its full dbias is exactly 0 on every pair pair_mask drops,
    and, reduced over the bias's broadcast dims, it is the dbias
    flash_attention returns (which test_bias_with_band_or_ids_matches_jax
    holds against JAX); dK / dV come per KV head."""
    q, k, v, do, bias, kw = _inputs(case)
    kw = dict(kw)
    softcap = kw.pop("logit_softcap", None)
    ids = kw.pop("segment_ids", None)
    seg = None if ids is None else (torch.from_numpy(ids),) * 2
    band = dict(causal=kw.get("causal", False), window=kw.get("window"),
                q_offset=kw.get("q_offset", 0), kv_offset=kw.get("kv_offset", 0))
    scale = q.shape[-1] ** -0.5
    bias_t = torch.from_numpy(bias)
    o, lse = flash_fwd.fwd(q, k, v, scale=scale, bias=bias_t, softcap=softcap, segment_ids=seg,
                           **band)
    dq, dk, dv, dbias = flash_bwd.bias_bwd(q, k, v, do, lse, (do * o).sum(-1), scale=scale,
                                           bias=bias_t, softcap=softcap, segment_ids=seg,
                                           want_dbias=True, **band)
    keep = flash_fwd.pair_mask(q.shape[2], k.shape[2], kv_valid_len=k.shape[2],
                               segment_ids=seg, device=q.device, **band)
    assert (dbias[~keep.expand_as(dbias)] == 0).all()
    assert dk.shape == k.shape and dv.shape == v.shape
    full = _port(q, k, v, do, bias, case[8] if ids is None else {**case[8], "segment_ids": ids})
    dims = tuple(d for d in range(3) if bias.shape[d] == 1)
    assert_close(dbias.sum(dim=dims, keepdim=True) if dims else dbias, full[1][3], F32_BWD,
                 "dbias")


def test_module_with_window_and_mask_matches_flax():
    """FlashMultiHeadDotProductAttention with ``window=`` and a key-padding
    mask (the mask becomes a bias, the window a band: flash_attention(bias=,
    window=)) against the flax module with the same window and mask, the
    weights carried across: the output on the valid rows within 2e-5 and
    every parameter's gradient within 5e-4 (tests/test_torch_integration.
    py's budgets)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 80, 32), dtype=np.float32)
    valid = np.arange(80)[None] < np.array([[80], [50]])
    ref = flax_linen.FlashMultiHeadDotProductAttention(num_heads=2, window=(8, 8))
    params = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(22), x))
    mask = nn.make_attention_mask(valid, valid)

    def loss_jax(p):
        y = ref.apply(p, x, mask=mask)
        return ((y ** 2) * valid[..., None]).sum(), y

    (_, y_want), g_want = jax.value_and_grad(loss_jax, has_aux=True)(params)
    mod = mhdpa_from_flax(params, num_heads=2, window=(8, 8), impl="fused", device="cpu")
    tmask = make_attention_mask(torch.from_numpy(valid), torch.from_numpy(valid),
                                dtype=torch.bool)
    y = mod(torch.from_numpy(x), mask=tmask)
    ((y ** 2) * torch.from_numpy(valid)[..., None]).sum().backward()
    assert float(np.abs(y.detach().numpy()[valid] - np.asarray(y_want)[valid]).max()) < 2e-5
    grads = dict(mod.named_parameters())
    for proj, leaves in g_want["params"].items():
        for leaf, want in leaves.items():
            diff = np.abs(grads[f"{proj}.{leaf}"].grad.numpy() - np.asarray(want)).max()
            assert diff < 5e-4, f"{proj}.{leaf}"


# ---------------------------------------------------------------------------
# The host glue on a simulated card.


def _recorder(name, argtypes, calls):
    """A ctypes function with the C entry's argument types (so ctypes
    converts the arguments as it would for the real entry) that records
    them."""
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: calls.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: the wrappers' device checks are off,
    the stand-in library records every C entry's arguments, and the segment
    tensors each bias-route launch was given (``seg``) beside those
    sm90_segments made (meta tensors have no addresses to compare)."""
    calls, segs, launched = [], [], []
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES, "fa_bwd_sm90": native.BWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_bias_sm90": native.BWD_BIAS_SM90_ARGTYPES,
             "fa_bwd_split_sm90": native.BWD_SPLIT_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    for name in ("fa_fwd_quant_sm90", "fa_decode"):
        setattr(lib, name, lambda *args, name=name: calls.append((name, args)) or 0)
    real_segments = flash_fwd.sm90_segments

    def segments(*args, **kw):
        out = real_segments(*args, **kw)
        if out is not None:
            segs.append((kw, out))
        return out

    monkeypatch.setattr(flash_fwd, "sm90_segments", segments)
    monkeypatch.setattr(flash_bwd, "sm90_segments", segments)
    for mod, name, at in ((flash_fwd, "_launch_bias_sm90", 8), (flash_bwd, "_launch_bias_bwd", 13)):
        def spy(*args, real=getattr(mod, name), at=at, **kw):
            launched.append(args[at] if len(args) > at else kw.get("seg"))
            return real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_bwd, "check_kernel_args", lambda q, name: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls, segs, launched


def _meta(B, Hq, Hkv, Nq, Nk, D):
    q = torch.empty((B, Nq, Hq, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, Nk, Hkv, D), dtype=torch.bfloat16, device="meta").transpose(1, 2)
            for _ in "kv")
    return q, k, v


# (options, whether segment ids): the calls the bias routes now take.
ROUTED = {"window": dict(window=(256, 256)),
          "causal window": dict(causal=True, window=(256, -1)),
          "segment ids": dict(segment_ids=True),
          "causal + offsets": dict(causal=True, q_offset=2048, kv_offset=0),
          "ids + window + cap": dict(segment_ids=True, window=(64, -1), logit_softcap=50.0)}


@pytest.mark.parametrize("case", list(ROUTED))
def test_bias_routes_take_band_ids_and_offsets(card, case):
    """flash_attention with a bias and the case's options on the card: K1's
    bias route and K5 + K6's, one call each, their window, offsets and ids
    in the C entries' places: fa_fwd_bias_sm90 gets sm90_segments at 128 /
    64-row tiles, fa_bwd_bias_sm90 at 64 / 128 with the query ids padded."""
    calls, segs, launched = card
    B, Hq, Hkv, N, D = 2, 8, 4, 300, 64
    q, k, v = (x.requires_grad_(True) for x in _meta(B, Hq, Hkv, N, N, D))
    kw = dict(ROUTED[case])
    if kw.pop("segment_ids", False):
        kw["segment_ids"] = torch.zeros((B, N), dtype=torch.int32, device="meta")
    bias = torch.zeros((1, Hq, N, N), device="meta", requires_grad=True)
    assert flash_fwd.bias_route(rows=Hq // Hkv * N, causal=kw.get("causal", False),
                                segment_ids=kw.get("segment_ids"), window=kw.get("window"),
                                head_dim=D, bias=bias, kv_dtype=k.dtype)
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=bias, dtype=q.dtype)
    o = flashattn_tpu_torch.flash_attention(q, k, v, bias=bias, **kw)
    grads = torch.autograd.grad(o, (q, k, v, bias), torch.empty_like(o))
    assert [name for name, _ in calls] == ["fa_fwd_bias_sm90", "fa_bwd_bias_sm90"]
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape, bias.shape]
    fwd_args, bwd_args = calls[0][1], calls[1][1]
    assert len(fwd_args) == len(native.FWD_BIAS_SM90_ARGTYPES) == 40
    assert len(bwd_args) == len(native.BWD_BIAS_SM90_ARGTYPES) == 46
    window = flash_fwd.kernel_window(kw.get("window"))
    offsets = (kw.get("q_offset", 0), kw.get("kv_offset", 0))
    assert fwd_args[15:21] == (N, int(kw.get("causal", False)), *window, *offsets)
    assert bwd_args[21:28] == (N, int(kw.get("causal", False)), *window, *offsets, 320)
    assert fwd_args[22] == bwd_args[29] == kw.get("logit_softcap", 0.0)
    seg = "segment_ids" in kw
    assert [kw_ for kw_, _ in segs] == ([{}, dict(q_tile=64, kv_tile=128, pad_q=True)]
                                       if seg else [])
    if seg:
        (_, fs), (_, bs) = segs
        assert launched[0] is fs and launched[1] is bs
        assert fs[1].shape == (B, 320) and bs[1].shape == (B, 384) and bs[0].shape == (B, 320)
        assert fs[2].shape == (B, 3, 2) and bs[2].shape == (B, 5, 2) and bs[3].shape == (B, 3, 2)
        assert fwd_args[38] == fs[0].stride(0)
    else:
        assert launched == [None, None] and fwd_args[6:10] == bwd_args[11:15] == (None,) * 4


class _Allocs:
    """torch as flash_bwd sees it, recording which of ``zeros`` / ``empty``
    allocated each [B, Hq, Nq, Nk]-shaped tensor (dbias)."""

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


# (options, whether the kernel may leave dbias pairs unvisited): a band
# (causal, a window, one side of one), segment ids and the KV tail do;
# offsets without a band change nothing, and neither does a plain call.
ZERO_FILL = {"plain": (dict(), False), "causal": (dict(causal=True), True),
             "window": (dict(window=(16, 16)), True),
             "right bound only": (dict(window=(-1, 8)), True),
             "segment ids": (dict(segment_ids=True), True),
             "kv tail": (dict(kv_valid_len=200), True),
             "offsets, no band": (dict(q_offset=64), False)}


@pytest.mark.parametrize("case", list(ZERO_FILL))
def test_dbias_is_zero_filled_where_pairs_go_unvisited(card, monkeypatch, case):
    opts, zeroed = ZERO_FILL[case]
    calls = card[0]
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
    assert [name for name, _ in calls] == ["fa_bwd_bias_sm90"] and calls[0][1][10] is None
    assert flash_bwd.dbias_skips(causal=kw.get("causal", False), window=kw.get("window"),
                                 segment_ids=kw.get("segment_ids"),
                                 kv_valid_len=kw.get("kv_valid_len", N), nk=N) == zeroed


def _cuda_q(D, dtype=torch.bfloat16):
    """A stand-in for a CUDA query [1, 4, 64, D]: what _check_kernel_args reads."""
    return types.SimpleNamespace(shape=(1, 4, 64, D), dtype=dtype,
                                 device=types.SimpleNamespace(type="cuda"))


# The card's checks on what was refused: item None, quantized K/V with
# segment ids or a window, refused ("K1 options") until K1's quantized route
# took them, and f32 with a bias above D 128, refused ("f32 rows item 5")
# until the f32 route's D 256 form took it: they pass, and the quantized /
# f32 route takes them. A bf16 bias above D 128 with segment ids, a window or
# offsets, refused until the bias route took D 256, now passes (WIDE_PASSES).
REFUSED = {"int8 + ids": (128, torch.bfloat16, dict(segment_ids=True, k_scale=True), None),
           "int8 + window": (128, torch.bfloat16, dict(windowed=True, k_scale=True), None),
           "f32 + bias": (136, torch.float32, dict(bias=True), None)}
WIDE_PASSES = {"D 160 bias + ids": (160, dict(bias=True, segment_ids=True)),
               "D 160 bias + window": (160, dict(bias=True, windowed=True)),
               "D 160 bias + offsets": (160, dict(bias=True, offsets=True))}


def _card_kw(opts):
    return dict(segment_ids=(1, 1) if opts.get("segment_ids") else None,
                bias=object() if opts.get("bias") else None,
                k_scale=object() if opts.get("k_scale") else None,
                windowed=opts.get("windowed", False), offsets=opts.get("offsets", False))


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_left_on_the_card(case):
    D, dtype, opts, item = REFUSED[case]
    if item is None:
        flash_fwd._check_kernel_args(_cuda_q(D, dtype), **_card_kw(opts))
        if dtype == torch.float32:
            assert flash_fwd.f32_route(dtype=dtype)
            assert flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=dtype)
        else:
            assert flash_fwd.quant_route(head_dim=D, kv_dtype=torch.int8)
        return
    with pytest.raises(NotImplementedError, match=item):
        flash_fwd._check_kernel_args(_cuda_q(D, dtype), **_card_kw(opts))


@pytest.mark.parametrize("case", list(WIDE_PASSES))
def test_a_wide_bias_with_a_band_passes_the_card_checks(case):
    """A bf16 bias at D 160 with segment ids, a window or offsets passes
    K1's checks, and the bias routes take it, forward and backward."""
    D, opts = WIDE_PASSES[case]
    flash_fwd._check_kernel_args(_cuda_q(D), **_card_kw(opts))
    assert flash_fwd.bias_route(rows=64, causal=False, segment_ids=None, window=None,
                                head_dim=D, bias=object(), kv_dtype=torch.bfloat16)
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=torch.bfloat16)


@pytest.mark.parametrize("D", [64, 72, 128, 136])
def test_f32_bias_with_everything_passes_the_card_checks_up_to_d128(D):
    """An f32 bias with ids, a window and offsets passes K1's and the
    backward's checks at D <= 128 (the f32 route's BIAS family) and, since
    its D 256 form, above (refused until then, naming f32 rows item 5)."""
    q = _cuda_q(D, torch.float32)
    kw = dict(segment_ids=(1, 1), bias=object(), k_scale=None, windowed=True, offsets=True)
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=torch.float32)
    flash_fwd._check_kernel_args(q, **kw)
    flash_bwd.check_kernel_dims(q, "K5 + K6 bias route")


@pytest.mark.parametrize("D", [64, 128, 136, 256])
def test_bias_with_everything_passes_the_card_checks_up_to_d128(D):
    """A bf16 bias with ids, a window and offsets passes K1's checks at
    every D up to 256 (the bias route; its D 256 form above 128, which it
    was refused until), and the backward's; in f32 too (refused above D 128,
    naming f32 rows item 5, until the f32 route's D 256 form)."""
    kw = dict(segment_ids=(1, 1), bias=object(), k_scale=None, windowed=True, offsets=True)
    flash_fwd._check_kernel_args(_cuda_q(D), **kw)
    flash_bwd.check_kernel_dims(_cuda_q(D), "K5 + K6 bias route")
    assert flash_bwd.bias_bwd_route(head_dim=D, bias=object(), dtype=torch.bfloat16)
    flash_fwd._check_kernel_args(_cuda_q(D, torch.float32), **kw)
    flash_bwd.check_kernel_dims(_cuda_q(D, torch.float32), "K5 + K6 bias route")
