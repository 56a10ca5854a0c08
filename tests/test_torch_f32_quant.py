"""An f32 q over int8 / fp8 K/V (the f32 LM served from an 8-bit cache) --
K1's decode route's and quantized route's f32-q forms -- on the CPU.

* Parity: the port's ``flash_attention_quantized`` with an f32 q (causal, a
  bias, the GQA decode fold) against the JAX ``flash_attention_quantized``,
  whose Pallas K1 runs in interpret mode with its f32 products at
  Precision.HIGHEST (FWD_TOL[f32]); ``decode_reference`` at the fold's shape,
  with 1, 3 and 7 splits, against the JAX ``flash_attention_quantized``;
  ``decode_step`` of the f32 tiny LM on an 8-bit cache against the JAX step.
  Widths are tests/test_models.py's, inputs numpy draws from fixed seeds.
* On a simulated card (meta tensors, the device checks off, a stand-in
  library whose entries take the C entries' argtypes): every decode-shaped
  f32-q call on int8 / fp8 K/V reaches ``fa_decode_f32`` once (no split
  launch); every other one ``fa_fwd_quant_f32`` once, with q's pieces'
  scratch and one split counted -- ids, a window, offsets, a bias, D 40 /
  64 / 96 / 128 / 136 / 256, BNHD views; the f32 LM's ``decode_step`` on
  each 8-bit cache reaches ``fa_decode_f32`` alone, once a layer. A softcap
  with quantized K/V still raises ``ValueError``, D above 256 still raises
  naming "K1 options".

The kernels run only on the card: ``python3 chip_smoke.py`` holds them
against their plain versions there (``phase_decode_f32``,
``phase_quant_check``).
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu.ops import quant as jax_quant
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import transformer_from_jax
from flashattn_tpu_torch.ops import f32_split, flash_fwd, quant
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close

DTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
F32 = torch.float32


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))


def _jax_qkv(qkv):
    """The port's QuantizedKV as the JAX package's, every value kept."""
    def payload(x):
        if x.dtype == torch.float8_e4m3fn:
            return jnp.asarray(x.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        return jnp.asarray(x.numpy())
    return jax_quant.QuantizedKV(payload(qkv.k_q), jnp.asarray(qkv.k_scale.numpy()),
                                 payload(qkv.v_q), jnp.asarray(qkv.v_scale.numpy()))


# (B, Hq, Hkv, Nq, Nk, D, causal, bias): a causal prompt with GQA 4/2, a
# per-row bias without the cap, the decode fold's call (Nq 1, GQA 4/2, a
# head-broadcast key mask), a ragged D 40 prompt with a full bias.
PARITY_CASES = {"causal GQA": (2, 4, 2, 96, 96, 32, True, None),
                "row bias": (1, 4, 4, 64, 80, 64, False, "rows"),
                "decode fold + key mask": (2, 4, 2, 1, 112, 32, False, "keys"),
                "D 40 full bias": (1, 2, 1, 40, 70, 40, False, "full")}


@pytest.mark.parametrize("case", list(PARITY_CASES))
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_f32_q_matches_jax_flash_attention_quantized(name, case):
    """An f32 q keeps f32 in both packages (the JAX kernel's mm_dtype is f32
    at Precision.HIGHEST); the port's plain K1 on the same 8-bit K/V and
    scales agrees with the JAX Pallas K1 in interpret mode at FWD_TOL[f32]."""
    B, Hq, Hkv, Nq, Nk, D, causal, bias_kind = PARITY_CASES[case]
    q, k, v = _randn(10, B, Hq, Nq, D), _randn(11, B, Hkv, Nk, D), _randn(12, B, Hkv, Nk, D)
    qkv = quant.quantize_kv(k, v, DTYPES[name][1], allow_slow_fp8=True)
    bias = {None: None, "rows": _randn(13, B, 1, Nq, Nk), "keys": _randn(14, 1, 1, 1, Nk),
            "full": _randn(15, B, Hq, Nq, Nk)}[bias_kind]
    got = quant.flash_attention_quantized(q, qkv, causal=causal, bias=bias)
    want = jax_quant.flash_attention_quantized(
        jnp.asarray(q.numpy()), _jax_qkv(qkv), causal=causal,
        bias=None if bias is None else jnp.asarray(bias.numpy()))
    assert got.dtype == F32 and want.dtype == jnp.float32
    assert_close(got, np.asarray(want), FWD_TOL[F32], "vs jax")


@pytest.mark.parametrize("splits", [1, 3, 7])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_f32_decode_reference_matches_jax(name, splits):
    """The decode kernel's plain version (its split / merge algebra) with an
    f32 q on 8-bit K/V, at the GQA fold's launch (q [B, Hkv, rep, D]),
    against the JAX flash_attention_quantized on the unfolded query."""
    B, Hq, Hkv, Nk, D = 2, 4, 2, 200, 64
    q, k, v = _randn(20, B, Hq, 1, D), _randn(21, B, Hkv, Nk, D), _randn(22, B, Hkv, Nk, D)
    qkv = quant.quantize_kv(k, v, DTYPES[name][1], allow_slow_fp8=True)
    o, lse = flash_fwd.decode_reference(q.reshape(B, Hkv, Hq // Hkv, D), qkv.k_q, qkv.v_q,
                                        scale=D ** -0.5, k_scale=qkv.k_scale,
                                        v_scale=qkv.v_scale, splits=splits)
    want = jax_quant.flash_attention_quantized(jnp.asarray(q.numpy()), _jax_qkv(qkv))
    assert o.dtype == F32 and lse.dtype == F32
    assert_close(o.reshape(B, Hq, 1, D), np.asarray(want), FWD_TOL[F32], "vs jax")


WIDTH = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32,
             d_ff=128)


@pytest.fixture(scope="module")
def f32_lm():
    jcfg = jax_lm.TransformerConfig(**WIDTH, dtype=jnp.float32)
    params = jax_lm.init_transformer(jax.random.PRNGKey(3), jcfg)
    pcfg = lm.TransformerConfig(**WIDTH, dtype=F32)
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg, device="cpu")
    return jcfg, params, pcfg, model


def test_f32_lm_int8_decode_matches_jax(f32_lm):
    """The f32 tiny LM decoding 4 steps from an int8 cache: the port's
    decode_step (an f32 q over the 8-bit live slots) against the JAX step on
    its int8 cache, logits within 1e-3 (tests/test_torch_decode.py's bound
    for a quantized cache)."""
    jcfg, params, pcfg, model = f32_lm
    tokens = np.random.default_rng(4).integers(0, 128, (2, 4)).astype(np.int32)
    jcache = jax_lm.init_kv_cache(jcfg, 2, 8, quant_dtype=jnp.int8)
    pcache = lm.init_kv_cache(pcfg, 2, 8, quant_dtype=torch.int8, device="cpu")
    for t in range(tokens.shape[1]):
        want, jcache = jax_lm.decode_step(params, jcache, jnp.asarray(tokens[:, t]), jcfg)
        got, pcache = lm.decode_step(model, pcache, torch.from_numpy(tokens[:, t]).long(), pcfg)
        assert got.dtype == F32
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-3


# ---------------------------------------------------------------------------
# The simulated card.


def _recorder(name, argtypes, calls):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: calls.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones: K1's device checks are off, and the
    stand-in library records the name and typed arguments of every C entry
    called (each takes its argtypes, so a packing that does not fit them
    raises)."""
    calls = []
    typed = {"fa_fwd_quant_f32": native.FWD_QUANT_F32_ARGTYPES,
             "fa_fwd_quant_sm90": native.FWD_QUANT_SM90_ARGTYPES,
             "fa_fwd_f32": native.FWD_F32_ARGTYPES, "fa_fwd_sm90": native.FWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES,
             "fa_decode": native.DECODE_ARGTYPES, "fa_decode_f32": native.DECODE_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(flash_fwd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


def _meta(B, Hq, Hkv, Nq, Nk, D, dtype, bnhd=False):
    """Meta q (f32), 8-bit k / v and f32 scales, BNHD views or BHND."""
    if bnhd:
        q = torch.empty((B, Nq, Hq, D), dtype=F32, device="meta").transpose(1, 2)
        k, v = (torch.empty((B, Nk, Hkv, D), dtype=dtype, device="meta").transpose(1, 2)
                for _ in "kv")
        ks, vs = (torch.empty((B, Nk, Hkv), device="meta").transpose(1, 2) for _ in "kv")
    else:
        q = torch.empty((B, Hq, Nq, D), dtype=F32, device="meta")
        k, v = (torch.empty((B, Hkv, Nk, D), dtype=dtype, device="meta") for _ in "kv")
        ks, vs = (torch.empty((B, Hkv, Nk), device="meta") for _ in "kv")
    return q, k, v, ks, vs


def _counters():
    f = flash_fwd.fwd
    return {"decode_f32": f.launches_decode_f32, "decode": f.launches_decode,
            "merge": f.launches_merge, "quant_f32": f.launches_quant_f32,
            "quant_sm90": f.launches_quant_sm90, "f32": f.launches_f32,
            "split": f.launches_split, "int8": f.launches_int8, "fp8": f.launches_fp8,
            "window": f.launches_window}


def _moved(before):
    return {n: c - before[n] for n, c in _counters().items() if c != before[n]}


# (B, Hq, Hkv, Nk, D, bias): decode_step's call at a cache of 8192 held at
# half (GQA 16/8, folded: 2 rows a KV head), a key-mask bias, D 64, one split.
DECODE_CASES = {"decode_step's call": (8, 16, 8, 4097, 128, False),
                "key mask": (2, 8, 4, 1000, 128, True),
                "D 64": (2, 8, 2, 700, 64, False),
                "one split": (1, 4, 4, 200, 128, False)}


@pytest.mark.parametrize("case", list(DECODE_CASES))
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_shaped_f32_calls_reach_fa_decode_f32(card, name, case):
    """A decode-shaped f32-q call on 8-bit K/V (through
    flash_attention_quantized: the GQA fold) reaches fa_decode_f32 once and
    no other entry: the dtype code, the fold's rows as Hq' = Hkv, the
    decode splits, no split launch; O f32; counted as the decode kernel's
    f32-q form with its dtype (and its merge where there is more than one
    split)."""
    B, Hq, Hkv, Nk, D, with_bias = DECODE_CASES[case]
    dt = DTYPES[name][1]
    q, k, v, ks, vs = _meta(B, Hq, Hkv, 1, Nk, D, dt, bnhd=True)
    qkv = quant.QuantizedKV(k, ks, v, vs)
    bias = torch.empty((1, 1, 1, Nk), device="meta") if with_bias else None
    before = _counters()
    o = quant.flash_attention_quantized(q.transpose(1, 2), quant.QuantizedKV(
        *(x.transpose(1, 2) for x in qkv)), bias=bias, layout="BNHD")
    assert [n for n, _ in card] == ["fa_decode_f32"]
    args = card[0][1]
    assert len(args) == len(native.DECODE_ARGTYPES) == 43
    splits, split_len = flash_fwd.decode_splits(B, Hkv, Nk)
    assert args[10:19] == (flash_fwd.KV_DTYPE_CODE[dt], B, Hkv, Hkv, Hq // Hkv, D, Nk, splits,
                           split_len)
    assert args[-1] == 77
    assert o.dtype == F32 and o.shape == (B, 1, Hq, D)
    assert _moved(before) == {"decode_f32": 1, name: 1, **({"merge": 1} if splits > 1 else {})}


# (B, Hq, Hkv, Nq, Nk, D, BNHD, options): the f32 LM's prefill, ids at D 40
# (rows padded), a window with offsets at D 96, a bias with a KV tail at D
# 136, a bias with ids and a window at D 256 (64 Q rows a CTA), a BNHD
# cache at D 64, a decode-shaped call at D 256 (the decode kernel lacks it),
# a causal Nq 1 (causal: not decode-shaped).
GLUE_CASES = {
    "LM prefill, int8": (1, 16, 8, 256, 256, 128, torch.int8, False, dict(causal=True)),
    "D 40 ids, fp8": (2, 4, 2, 130, 130, 40, torch.float8_e4m3fn, False, dict(ids=True)),
    "D 96 window + offsets, int8": (1, 4, 2, 200, 180, 96, torch.int8, False,
                                    dict(causal=True, window=(63, -1), q_offset=64)),
    "D 136 bias, fp8": (1, 4, 4, 100, 90, 136, torch.float8_e4m3fn, False,
                        dict(bias=True, kv_valid_len=77)),
    "D 256 bias + ids + window, int8": (2, 8, 4, 128, 128, 256, torch.int8, False,
                                        dict(bias=True, ids=True, window=(100, 20))),
    "BNHD D 64, fp8": (2, 8, 2, 150, 150, 64, torch.float8_e4m3fn, True, dict(causal=True)),
    "decode-shaped D 256, int8": (2, 8, 4, 1, 300, 256, torch.int8, False, {}),
    "causal Nq 1, int8": (2, 8, 4, 1, 300, 128, torch.int8, False, dict(causal=True)),
}


@pytest.mark.parametrize("case", list(GLUE_CASES))
def test_f32_quantized_calls_reach_fa_fwd_quant_f32(card, case):
    """Every f32-q call on 8-bit K/V that is not decode-shaped reaches
    fa_fwd_quant_f32 once and no other entry: q f32 with its strides as
    they are (its pieces come from the C entry's split), the pieces' scratch
    (3 x the D box x B Hq Nq bf16) after lse, K / V as the TMA maps read
    them, the scales as they are, the dtype code, dims, band ints, offsets,
    O f32 in q's strides, the bias's strides, the ids' batch stride; counted
    as the route's f32-q form with one split (q's alone), the dtype and the
    window -- never as the f32 route or the bf16-q quantized route."""
    B, Hq, Hkv, Nq, Nk, D, dt, bnhd, opts = GLUE_CASES[case]
    q, k, v, ks, vs = _meta(B, Hq, Hkv, Nq, Nk, D, dt, bnhd)
    kw = dict(opts)
    if kw.pop("ids", False):
        kw["segment_ids"] = (torch.zeros((B, Nq), dtype=torch.int32, device="meta"),
                             torch.zeros((B, Nk), dtype=torch.int32, device="meta"))
    if kw.pop("bias", False):
        kw["bias"] = torch.empty((B, 1, Nq, Nk), device="meta")
    kvl = kw.get("kv_valid_len", Nk)
    allocs = []
    real_scratch = f32_split.scratch
    before = _counters()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(f32_split, "scratch",
                   lambda *a: allocs.append(a) or real_scratch(*a))
        o, lse = flash_fwd.fwd(q, k, v, scale=0.1, k_scale=ks, v_scale=vs, **kw)
    assert [n for n, _ in card] == ["fa_fwd_quant_f32"]
    args = card[0][1]
    assert len(args) == len(native.FWD_QUANT_F32_ARGTYPES) == 49
    assert allocs == [(B * Hq * Nq, 0, D, q.device)]
    window = kw.get("window")
    assert args[13:21] == (flash_fwd.KV_DTYPE_CODE[dt], B, Hq, Hkv, Nq, D, kvl,
                           int(kw.get("causal", False)))
    qo, ko = flash_fwd.band_offsets(kw.get("causal", False), window, kw.get("q_offset", 0),
                                    kw.get("kv_offset", 0))
    assert args[21:25] == (*flash_fwd.kernel_window(window), qo, ko)
    assert args[25] == pytest.approx(0.1)
    assert args[26:29] == tuple(q.stride()[:3]) and args[35:38] == tuple(o.stride()[:3])
    assert args[41:44] == args[44:47] == tuple(ks.stride())
    assert args[47] == (Nq if "segment_ids" in kw else 0) and args[48] == 77
    assert o.dtype == F32 and o.shape == q.shape and lse.shape == (B, Hq, Nq)
    name = "int8" if dt == torch.int8 else "fp8"
    windowed = flash_fwd.kernel_window(window) != (-1, -1)
    assert _moved(before) == {"quant_f32": 1, "split": 1, name: 1,
                              **({"window": 1} if windowed else {})}


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_f32_lm_decode_step_reaches_fa_decode_f32_alone(card, name):
    """The f32 tiny LM with heads of 64 (the decode kernel's smallest; at
    32 the quantized route takes the call) decoding from an 8-bit cache (meta
    weights and cache: the shapes and routes only): one fa_decode_f32 a
    layer, no split, no f32 route, no bf16-q kernel."""
    cfg = lm.TransformerConfig(**dict(WIDTH, d_head=64), dtype=F32)
    model = lm.Transformer(cfg, device="meta")
    cache = lm.init_kv_cache(cfg, 2, 16, quant_dtype=torch.int8, device="meta")
    if name == "fp8":
        for key in ("k", "v"):
            cache[key] = [x.to(torch.float8_e4m3fn) for x in cache[key]]
    cache["length"] = 5
    before = _counters()
    logits, _ = lm.decode_step(model, cache, torch.zeros(2, dtype=torch.long, device="meta"), cfg)
    assert [n for n, _ in card] == ["fa_decode_f32"] * cfg.n_layers
    assert logits.dtype == F32
    assert _moved(before) == {"decode_f32": cfg.n_layers, name: cfg.n_layers}


def test_f32_route_leaves_quantized_kv_to_the_f32_q_forms():
    """f32_route takes an f32 q over f32 K/V and leaves int8 / fp8 K/V to the
    decode and quantized routes, which take them under an f32 q."""
    assert flash_fwd.f32_route(dtype=F32, kv_dtype=F32)
    assert flash_fwd.f32_route(dtype=F32)
    for dt in (torch.int8, torch.float8_e4m3fn):
        assert not flash_fwd.f32_route(dtype=F32, kv_dtype=dt)
        assert flash_fwd.quant_route(head_dim=128, kv_dtype=dt)
    assert not flash_fwd.f32_route(dtype=torch.bfloat16, kv_dtype=torch.bfloat16)


def test_softcap_with_quantized_kv_still_raises_for_an_f32_q():
    q, k, v = _randn(30, 1, 2, 4, 32), _randn(31, 1, 2, 8, 32), _randn(32, 1, 2, 8, 32)
    qkv = quant.quantize_kv(k, v, torch.int8)
    with pytest.raises(ValueError, match="logit_softcap"):
        flash_fwd.fwd(q, qkv.k_q, qkv.v_q, scale=0.1, k_scale=qkv.k_scale,
                      v_scale=qkv.v_scale, softcap=30.0)


@pytest.mark.parametrize("D", [264, 512])
def test_f32_q_above_d256_still_names_k1_options(D):
    """K1's checks on the card: an f32 q over quantized K/V passes at every D
    up to 256 and still raises above it, naming the ROADMAP's K1 options."""
    q = types.SimpleNamespace(shape=(1, 4, 64, D), dtype=F32,
                              device=types.SimpleNamespace(type="cuda"))
    args = dict(segment_ids=None, bias=None, k_scale=object(), windowed=False)
    with pytest.raises(NotImplementedError, match="K1 options"):
        flash_fwd._check_kernel_args(q, **args)
    q.shape = (1, 4, 64, 256)
    flash_fwd._check_kernel_args(q, **args)
