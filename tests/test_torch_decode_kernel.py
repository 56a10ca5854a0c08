"""K1's decode route -- the rule that sends a call to the split-KV decode
kernel (``decode_route``), its split count and length
(``decode_splits``), its plain split / merge version (``decode_reference``) --
and ``decode_step``'s live-slot views, against the JAX package on CPU.

The kernel itself runs only on the card (``python3 chip_smoke.py`` holds it
against ``decode_reference`` there); here the same numpy inputs go through
``decode_reference`` with split counts 1, 3 and 7 and through the JAX
``flash_attention_with_lse`` / ``flash_attention_quantized`` (Pallas in
interpret mode, as the JAX package's tests run it). Budgets: FWD_TOL[f32]
(1e-4 abs + 1e-4 rel) for f32 queries over bf16-free inputs, as
test_torch_bias.py and test_torch_quant.py hold f32 queries (the split /
merge computes the same sums in another order); a masked batch row exactly
O = 0 and LSE = ln2 x mask to f32 rounding. ``decode_step`` over the live
slots against the JAX step over the whole cache: logits within 1e-4, the
bound of tests/test_torch_decode.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattn_tpu
from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu.ops import quant as jax_quant
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import kv_cache_from_jax, transformer_from_jax
from flashattn_tpu_torch.ops import flash_fwd, quant
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close, make_qkv

# The LM's decode attention cut to size: B2, Hq 4 over Hkv 2 (folded to 2
# rows per KV head), D 64, Nk 1000 (not a multiple of the 64-key tile), 600
# slots live.
B, HQ, HKV, D, NK, LIVE = 2, 4, 2, 64, 1000, 600
SCALE = D ** -0.5
DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
DEAD_LSE = math.log(2.0) * DEFAULT_MASK_VALUE


def _slot_bias(batch=1):
    bias = np.where(np.arange(NK) < LIVE, 0.0, -1e9).astype(np.float32)
    return np.broadcast_to(bias, (batch, 1, 1, NK)).copy()


def _fold(q):
    """[B, Hq, 1, D] -> [B, Hkv, rep, D]: the GQA fold's launch."""
    return q.reshape(q.shape[0], HKV, HQ // HKV, q.shape[-1])


def _unfold(o, lse):
    return o.reshape(B, HQ, 1, -1), lse.reshape(B, HQ, 1)


def _jax(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


def _jax_qkv(qkv):
    """The port's QuantizedKV as the JAX package's, every value kept."""
    def payload(x):
        if x.dtype == torch.float8_e4m3fn:
            return jnp.asarray(x.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        return jnp.asarray(x.numpy())
    return jax_quant.QuantizedKV(payload(qkv.k_q), jnp.asarray(qkv.k_scale.numpy()),
                                 payload(qkv.v_q), jnp.asarray(qkv.v_scale.numpy()))


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_decode_reference_matches_jax(splits):
    """bf16-free f32 inputs with the cache-slot bias: the split / merge
    algebra on the folded query against the JAX forward with its LSE."""
    q, k, v = make_qkv(30, B, HQ, 1, D, Nk=NK, Hkv=HKV)
    bias = _slot_bias()
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(*_jax(q, k, v),
                                                              bias=jnp.asarray(bias))
    o, lse = _unfold(*flash_fwd.decode_reference(_fold(q), k, v, scale=SCALE,
                                                 bias=torch.from_numpy(bias), splits=splits))
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_decode_reference_quantized_matches_jax(name, splits):
    """int8 / fp8 K/V with per-token scales and the slot bias (the k_scale on
    the score column, the v_scale on P) against the JAX
    flash_attention_quantized on the same payloads and scales."""
    q, k, v = make_qkv(31, B, HQ, 1, D, Nk=NK, Hkv=HKV)
    qkv = quant.quantize_kv(k, v, DTYPES[name], allow_slow_fp8=True)
    bias = _slot_bias()
    want = jax_quant.flash_attention_quantized(jnp.asarray(q.numpy()), _jax_qkv(qkv),
                                               bias=jnp.asarray(bias))
    o, _ = flash_fwd.decode_reference(_fold(q), qkv.k_q, qkv.v_q, scale=SCALE,
                                      bias=torch.from_numpy(bias), k_scale=qkv.k_scale,
                                      v_scale=qkv.v_scale, splits=splits)
    assert_close(o.reshape(B, HQ, 1, D), np.asarray(want), FWD_TOL[torch.float32])


@pytest.mark.parametrize("splits", [1, 7])
def test_decode_reference_softcap_matches_jax(splits):
    """The softcap (cap 2 bends these scores) before the slot bias."""
    q, k, v = make_qkv(32, B, HQ, 1, D, Nk=NK, Hkv=HKV)
    q = 3.0 * q
    bias = _slot_bias()
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *_jax(q, k, v), bias=jnp.asarray(bias), logit_softcap=2.0)
    o, lse = _unfold(*flash_fwd.decode_reference(_fold(q), k, v, scale=SCALE, softcap=2.0,
                                                 bias=torch.from_numpy(bias), splits=splits))
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


@pytest.mark.parametrize("splits", [1, 3, 7])
def test_decode_reference_dead_batch_row(splits):
    """A bias at the mask value on every slot of batch row 1: that row is dead
    in every split, so the merge drops all its partials: O exactly 0 and LSE
    ln2 x mask, as JAX gives; row 0 as JAX gives."""
    q, k, v = make_qkv(33, B, HQ, 1, D, Nk=NK, Hkv=HKV)
    bias = _slot_bias(batch=B)
    bias[1] = DEFAULT_MASK_VALUE
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(*_jax(q, k, v),
                                                              bias=jnp.asarray(bias))
    o, lse = _unfold(*flash_fwd.decode_reference(_fold(q), k, v, scale=SCALE,
                                                 bias=torch.from_numpy(bias), splits=splits))
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert torch.allclose(lse[1], torch.full_like(lse[1], DEAD_LSE), rtol=1e-6, atol=0)
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse, np.asarray(lse_want), FWD_TOL[torch.float32], "lse")


# (B, Hq, Hkv, Nq, Nk, kv_valid_len): two Q tiles' worth of folded rows (20),
# a KV tail, a single key, no key at all.
REF_SHAPES = [(2, 4, 2, 10, 300, 300), (1, 2, 2, 1, 700, 450), (2, 2, 1, 1, 1, 1),
              (1, 2, 2, 1, 64, 0)]


@pytest.mark.parametrize("shape", REF_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_reference_equals_fwd_reference(shape):
    """The split / merge algebra (kernel splits) equals the dense plain K1,
    with a random [B, 1, Nq, Nk] bias, over kv_valid_len keys."""
    b, hq, hkv, nq, nk, valid = shape
    q, k, v = make_qkv(34, b, hq, nq, 64, Nk=nk, Hkv=hkv)
    bias = torch.from_numpy(np.random.default_rng(35).standard_normal((b, 1, nq, nk),
                                                                     dtype=np.float32))
    kw = dict(scale=SCALE, kv_valid_len=valid, bias=bias)
    o, lse = flash_fwd.decode_reference(q, k, v, **kw)
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
    assert_close(o, o_want, FWD_TOL[torch.float32], "o")
    assert_close(lse, lse_want, FWD_TOL[torch.float32], "lse")


WIDTH = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=64,
             d_ff=128)


@pytest.mark.parametrize("kind", ["bf16", "softcap", "int8", "fp8", "window"])
def test_decode_route_takes_every_decode_step_call(kind, monkeypatch):
    """Every K1 call decode_step makes -- on a full-precision cache, with a
    softcap or a window, int8 / fp8 K/V -- is one the decode route takes."""
    calls = []
    real = flash_fwd.fwd

    def spy(q, k, v, **kw):
        calls.append(flash_fwd.decode_route(
            rows=q.shape[1] // k.shape[1] * q.shape[2], causal=kw.get("causal", False),
            segment_ids=kw.get("segment_ids"), window=kw.get("window"),
            head_dim=q.shape[-1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", spy)
    cfg = lm.TransformerConfig(**WIDTH, dtype=torch.float32,
                               logit_softcap=2.0 if kind == "softcap" else None,
                               sliding_window=4 if kind == "window" else None)
    model = lm.init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = lm.init_kv_cache(cfg, 2, 8, torch.int8 if kind in DTYPES else None, device="cpu")
    if kind == "fp8":
        cache["k"] = [x.to(torch.float8_e4m3fn) for x in cache["k"]]
        cache["v"] = [x.to(torch.float8_e4m3fn) for x in cache["v"]]
    for t in range(6):
        lm.decode_step(model, cache, torch.full((2,), t, dtype=torch.long), cfg)
    assert calls == [True] * (6 * cfg.n_layers)


# (rows, causal, segment ids, window, head dim) the route takes: the LM's 2
# folded rows, phase_decode_check's Nq 16 without bias, 32 rows (two Q
# tiles), D 64, a window of no bound on either side.
ROUTE_TAKES = [(2, False, None, None, 128), (16, False, None, None, 128),
               (32, False, None, None, 128), (1, False, None, None, 64),
               (2, False, None, (-1, -1), 128)]
ROUTE_REFUSES = {"causal": (2, True, None, None, 128),
                 "window": (2, False, None, (7, -1), 128),
                 "right window": (2, False, None, (-1, 3), 128),
                 "segment ids": (2, False, (torch.zeros(1, 2), torch.zeros(1, 9)), None, 128),
                 "33 rows": (33, False, None, None, 128), "D 32": (2, False, None, None, 32),
                 "D 96": (2, False, None, None, 96), "D 256": (2, False, None, None, 256)}


@pytest.mark.parametrize("args", ROUTE_TAKES, ids=lambda a: f"rows{a[0]}-D{a[4]}")
def test_decode_route_takes(args):
    rows, causal, seg, window, d = args
    assert flash_fwd.decode_route(rows=rows, causal=causal, segment_ids=seg, window=window,
                                  head_dim=d)


@pytest.mark.parametrize("case", sorted(ROUTE_REFUSES))
def test_decode_route_refuses(case):
    rows, causal, seg, window, d = ROUTE_REFUSES[case]
    assert not flash_fwd.decode_route(rows=rows, causal=causal, segment_ids=seg, window=window,
                                      head_dim=d)


# (B, Hkv, Nk): the LM at Hkv 8 / 16 / 2, one (batch, head) pair over the
# longest cache, a short cache, decode_step's live prefixes, a large batch,
# one key, none.
SPLIT_SHAPES = [(8, 8, 8192), (8, 16, 8192), (8, 2, 8192), (1, 1, 528 * 256), (2, 2, 1000),
                (8, 8, 513), (8, 8, 8191), (64, 8, 8192), (8, 8, 1), (8, 8, 0)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_num_splits_fills_the_grid_without_an_empty_split(shape):
    """Every split holds whole 64-key tiles and at least one key; the grid
    stays within 4 CTAs per SM of the H100's 132 and fills at least 2 per SM
    whenever the keys allow 4 tiles per split; no split under 4 tiles
    unless there is only one."""
    b, hkv, nk = shape
    splits, split_len = flash_fwd.decode_splits(b, hkv, nk)
    assert splits >= 1
    assert split_len % 64 == 0
    if nk == 0:
        assert splits == 1
        return
    assert (splits - 1) * split_len < nk <= splits * split_len
    ctas = b * hkv * splits
    assert splits == 1 or ctas <= 4 * 132
    assert splits == 1 or split_len >= 4 * 64
    pairs = b * hkv
    if pairs <= 2 * 132 and nk >= 4 * 64 * (4 * 132 // pairs):
        assert ctas >= 2 * 132


def test_num_splits_at_the_lms_decode_shape():
    """B8 Hkv8 Nk8192: 8 splits of 1024 keys, 512 CTAs (two waves of two per SM)."""
    assert flash_fwd.decode_splits(8, 8, 8192) == (8, 1024)


# decode_step's live prefix against the JAX step over the whole cache. The
# cache is filled with random K/V in every slot, also past the step's
# position, so a step that attended a slot outside the live prefix would
# decode other logits.
DCFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32,
            d_ff=128)
MAX_LEN = 24


def _random_cache(jcfg, pos, seed):
    cache = jax_lm.init_kv_cache(jcfg, 2, MAX_LEN)
    rng = np.random.default_rng(seed)
    for name in ("k", "v"):
        cache[name] = [jnp.asarray(rng.standard_normal(x.shape, dtype=np.float32))
                       for x in cache[name]]
    cache["length"] = jnp.asarray(pos, jnp.int32)
    return cache


@pytest.mark.parametrize("pos,window", [(0, None), (11, None), (MAX_LEN - 1, None), (15, 8)],
                         ids=["pos0", "mid", "last", "window"])
def test_decode_step_live_slots_match_jax(pos, window):
    """One step at position ``pos`` (first, middle, last slot; and with a
    window of 8 that binds): the port's step over the live slots against the
    JAX step over all MAX_LEN slots with its -1e9 mask, within 1e-4."""
    jcfg = jax_lm.TransformerConfig(**DCFG, dtype=jnp.float32, sliding_window=window)
    pcfg = lm.TransformerConfig(**DCFG, dtype=torch.float32, sliding_window=window)
    params = jax_lm.init_transformer(jax.random.PRNGKey(0), jcfg)
    model = transformer_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg, device="cpu")
    jcache = _random_cache(jcfg, pos, seed=pos)
    pcache = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    token = np.array([3, 77], np.int32)
    want, _ = jax_lm.decode_step(params, jcache, jnp.asarray(token), jcfg)
    got, pcache = lm.decode_step(model, pcache, torch.from_numpy(token).long(), pcfg)
    assert pcache["length"] == pos + 1
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4


@pytest.mark.parametrize("quant_dtype", [None, torch.int8])
def test_decode_step_passes_views_of_the_live_slots(quant_dtype, monkeypatch):
    """K1 sees K/V (and the scales) of slots [pos - window + 1, pos] only, as
    views of the cache tensors (their storage, no copy), and no bias: every
    slot it sees is live."""
    seen = []
    real = flash_fwd.fwd

    def spy(q, k, v, **kw):
        seen.append((k.shape[2], kw.get("bias"), k.untyped_storage().data_ptr(),
                     None if kw.get("k_scale") is None
                     else kw["k_scale"].untyped_storage().data_ptr()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(flash_fwd, "fwd", spy)
    cfg = lm.TransformerConfig(**DCFG, dtype=torch.float32, sliding_window=5)
    model = lm.init_transformer(cfg, torch.Generator().manual_seed(1), device="cpu")
    cache = lm.init_kv_cache(cfg, 2, 12, quant_dtype, device="cpu")
    for t in range(9):
        lm.decode_step(model, cache, torch.full((2,), t, dtype=torch.long), cfg)
    live = [min(t + 1, 5) for t in range(9) for _ in range(cfg.n_layers)]
    assert [s[0] for s in seen] == live and [s[1] for s in seen] == [None] * len(live)
    k_ptrs = [cache["k"][i].untyped_storage().data_ptr() for i in range(cfg.n_layers)]
    assert [s[2] for s in seen] == k_ptrs * 9
    if quant_dtype is not None:
        s_ptrs = [cache["k_scale"][i].untyped_storage().data_ptr() for i in range(cfg.n_layers)]
        assert [s[3] for s in seen] == s_ptrs * 9


def test_cpu_fwd_takes_the_plain_version_not_the_decode_kernel():
    """On CPU tensors a decode-shaped call runs fwd_reference: no launch."""
    q, k, v = make_qkv(36, B, HKV, 2, D, Nk=NK, Hkv=HKV)
    before = (flash_fwd.fwd.launches, flash_fwd.fwd.launches_decode,
              flash_fwd.fwd.launches_merge)
    o, lse = flash_fwd.fwd(q, k, v, scale=SCALE, bias=torch.from_numpy(_slot_bias()))
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, scale=SCALE,
                                               bias=torch.from_numpy(_slot_bias()))
    assert torch.equal(o, o_want) and torch.equal(lse, lse_want)
    assert (flash_fwd.fwd.launches, flash_fwd.fwd.launches_decode,
            flash_fwd.fwd.launches_merge) == before

