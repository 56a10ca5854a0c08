"""The port's LM serving path -- init_kv_cache, decode_step, kv_cache_from_jax
-- against the JAX package's, in f32 on CPU.

Weights come from the JAX ``init_transformer`` at the tiny config of
tests/test_models.py:27-30 and carry over with ``transformer_from_jax``; the
JAX cache carries over with ``kv_cache_from_jax``. Both then decode the same
numpy tokens: the JAX package with its Pallas kernels in interpret mode, the
port with its K1 wrapper's plain version. Budgets: logits within 1e-4 of the
JAX decode (the JAX test's CPU bound for decode against teacher forcing,
tests/test_models.py:120-131), also for a windowed model
(tests/test_window.py:113-131); an int8 or fp8 cache within 1e-3 of the JAX
package's on the same cache dtype (both quantize K/V that agree to f32
round-off with the same rounding, and attend over the dequantized cache in
f32); a soft-capped model on a full-precision cache within 1e-4 of the JAX
decode; int8 and fp8 against the unquantized cache by the JAX rule
``0.05·max(max|logits|, 1)`` (tests/test_models.py:134-147).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.models import transformer as jax_lm
from flashattn_tpu_torch.models import transformer as lm
from flashattn_tpu_torch.models.convert import kv_cache_from_jax, transformer_from_jax
from flashattn_tpu_torch.ops import flash_fwd

WIDTH = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_head=32,
             d_ff=128)
JCFG = jax_lm.TransformerConfig(**WIDTH, dtype=jnp.float32)
PCFG = lm.TransformerConfig(**WIDTH, dtype=torch.float32)
TOKENS = np.random.default_rng(2).integers(0, 128, (2, 32)).astype(np.int32)
# tests/test_window.py:113-131's windowed model.
WCFG = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_head=16,
            d_ff=64, sliding_window=8)


@pytest.fixture(scope="module")
def jax_params():
    return jax_lm.init_transformer(jax.random.PRNGKey(0), JCFG)


def _port_model(jax_params, cfg=PCFG):
    return transformer_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), cfg,
                                device="cpu")


def _jax_fp8_cache(cfg, batch, max_len):
    """A JAX fp8 cache (its init_kv_cache falls back to int8 on the CPU)."""
    cache = jax_lm.init_kv_cache(cfg, batch, max_len, quant_dtype=jnp.int8)
    for name in ("k", "v"):
        cache[name] = [x.astype(jnp.float8_e4m3fn) for x in cache[name]]
    return cache


def _decode_both(jax_params, model, jcfg, pcfg, jcache, steps, tokens=TOKENS):
    """Decode ``steps`` tokens with both packages from the same cache; returns
    (jax logits, port logits, jax cache, port cache), logits as [steps, B, V]."""
    pcache = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    step = jax.jit(lambda c, t: jax_lm.decode_step(jax_params, c, t, jcfg))
    want, got = [], []
    for t in range(steps):
        lg, jcache = step(jcache, jnp.asarray(tokens[:, t]))
        plg, pcache = lm.decode_step(model, pcache, torch.from_numpy(tokens[:, t]).long(), pcfg)
        want.append(np.asarray(lg))
        got.append(plg.numpy())
    return np.stack(want), np.stack(got), jcache, pcache


def test_decode_matches_jax(jax_params):
    """6 steps: logits within 1e-4, and the cache the port wrote in place
    equals the JAX step's new cache."""
    model = _port_model(jax_params)
    want, got, jcache, pcache = _decode_both(jax_params, model, JCFG, PCFG,
                                             jax_lm.init_kv_cache(JCFG, 2, 32), 6)
    assert got.dtype == np.float32 and got.shape == (6, 2, 128)
    assert np.abs(got - want).max() < 1e-4
    assert pcache["length"] == int(jcache["length"]) == 6
    for name in ("k", "v"):
        for p, j in zip(pcache[name], jcache[name]):
            assert p.shape == (2, 32, 2, 32)
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5, rtol=0)


def test_decode_matches_teacher_forced_forward(jax_params):
    """tests/test_models.py:120-131 on the port alone: decode reproduces the
    causal forward's logits at every position (1e-4)."""
    model = _port_model(jax_params)
    tokens = torch.from_numpy(TOKENS).long()
    with torch.no_grad():
        full = lm.transformer_forward(model, tokens, PCFG)
    cache = lm.init_kv_cache(PCFG, 2, 32, device="cpu")
    errs = []
    for t in range(6):
        logits, cache = lm.decode_step(model, cache, tokens[:, t], PCFG)
        errs.append((logits - full[:, t]).abs().max().item())
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantized_cache_matches_jax(jax_params, qdtype):
    """5 steps on an int8 / fp8 cache: logits within 1e-3 of the JAX
    package's decode on the same cache dtype. The two models' f32 K/V
    projections agree to ~1e-7 relative, not bit for bit, so the scales are
    held to 1e-5 relative and the payloads to one quantization step (an
    int8 step of 1; an e4m3 step of at most 1/8 relative)."""
    model = _port_model(jax_params)
    jcache = (jax_lm.init_kv_cache(JCFG, 2, 16, quant_dtype=jnp.int8) if qdtype == "int8"
              else _jax_fp8_cache(JCFG, 2, 16))
    want, got, jcache, pcache = _decode_both(jax_params, model, JCFG, PCFG, jcache, 5)
    assert np.abs(got - want).max() < 1e-3
    tdt = torch.int8 if qdtype == "int8" else torch.float8_e4m3fn
    for name in ("k", "v"):
        for p, j in zip(pcache[name], jcache[name]):
            assert p.dtype == tdt
            p, j = p.float().numpy(), np.asarray(j).astype(np.float32)
            assert np.all(np.abs(p - j) <= (1.0 if qdtype == "int8" else np.abs(j) / 8))
        for p, j in zip(pcache[name + "_scale"], jcache[name + "_scale"]):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=0, rtol=1e-5)


@pytest.mark.parametrize("qdtype", [torch.int8, torch.float8_e4m3fn])
def test_quantized_cache_tracks_full_precision(jax_params, qdtype):
    """The JAX rule of tests/test_models.py:134-147, on the port alone."""
    model = _port_model(jax_params)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 128, (2, 16))).long()
    cache = lm.init_kv_cache(PCFG, 2, 16, device="cpu")
    # The CPU has no fp8 matrix unit, so init_kv_cache would pick int8:
    # make the fp8 cache by hand, as bench_decode.py forces real fp8.
    qcache = lm.init_kv_cache(PCFG, 2, 16, quant_dtype=torch.int8, device="cpu")
    qcache["k"] = [x.to(qdtype) for x in qcache["k"]]
    qcache["v"] = [x.to(qdtype) for x in qcache["v"]]
    errs = []
    for t in range(5):
        lg, cache = lm.decode_step(model, cache, tokens[:, t], PCFG)
        qlg, qcache = lm.decode_step(model, qcache, tokens[:, t], PCFG)
        errs.append((lg - qlg).abs().max().item())
    scale = lg.abs().max().item()
    assert max(errs) < 0.05 * max(scale, 1.0), (errs, scale)
    assert qcache["k"][0].dtype == qdtype


def test_windowed_decode_matches_jax():
    """tests/test_window.py:113-131's windowed model, 12 steps over a
    24-slot cache (the window of 8 binds from step 8): within 1e-4. The
    window is only the cache-slot bias, so no kernel needs it."""
    jcfg = jax_lm.TransformerConfig(**WCFG, dtype=jnp.float32)
    pcfg = lm.TransformerConfig(**WCFG, dtype=torch.float32)
    params = jax_lm.init_transformer(jax.random.PRNGKey(0), jcfg)
    model = _port_model(params, pcfg)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 24), 0, 64), np.int32)
    want, got, _, _ = _decode_both(params, model, jcfg, pcfg,
                                   jax_lm.init_kv_cache(jcfg, 1, 24), 12, tokens)
    assert np.abs(got - want).max() < 1e-4
    # the window binds: full attention decodes other logits from step 8 on
    full = dataclasses.replace(pcfg, sliding_window=None)
    cache = lm.init_kv_cache(full, 1, 24, device="cpu")
    for t in range(12):
        lg, cache = lm.decode_step(model, cache, torch.from_numpy(tokens[:, t]).long(), full)
    assert np.abs(lg.numpy() - got[-1]).max() > 1e-3


def test_softcap_decode_raises(jax_params):
    """A quantized cache with a softcap raises the JAX package's ValueError;
    a full-precision cache with it decodes (test_softcap_decode_matches_jax
    holds its logits against the JAX decode)."""
    cfg = dataclasses.replace(PCFG, logit_softcap=30.0)
    model = _port_model(jax_params, cfg)
    token = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="quantized KV cache"):
        lm.decode_step(model, lm.init_kv_cache(cfg, 2, 8, quant_dtype=torch.int8, device="cpu"),
                       token, cfg)
    logits, _ = lm.decode_step(model, lm.init_kv_cache(cfg, 2, 8, device="cpu"), token, cfg)
    assert logits.shape == (2, 128) and torch.isfinite(logits).all()


def test_softcap_decode_matches_jax(jax_params):
    """A soft-capped model (cap 2, which bends the tiny model's scores)
    decodes 6 steps on a full-precision cache within 1e-4 of the JAX
    decode_step, through the GQA fold with the cap; without the cap the
    logits differ."""
    jcfg = dataclasses.replace(JCFG, logit_softcap=2.0)
    pcfg = dataclasses.replace(PCFG, logit_softcap=2.0)
    model = _port_model(jax_params, pcfg)
    want, got, _, _ = _decode_both(jax_params, model, jcfg, pcfg,
                                   jax_lm.init_kv_cache(jcfg, 2, 32), 6)
    assert np.abs(got - want).max() < 1e-4
    plain, _, _, _ = _decode_both(jax_params, model, JCFG, PCFG, jax_lm.init_kv_cache(JCFG, 2, 32),
                                  6)
    assert np.abs(plain - want).max() > 1e-3


def test_softcap_window_decode_matches_teacher_forced_forward(jax_params):
    """With a cap and a sliding window of 8 that binds, decode (the window as
    the cache-slot bias) reproduces the fused forward (the window and the cap
    in K1's plain version) at every position, within 1e-4."""
    cfg = dataclasses.replace(PCFG, logit_softcap=2.0, sliding_window=8)
    model = _port_model(jax_params, cfg)
    tokens = torch.from_numpy(TOKENS).long()[:, :12]
    with torch.no_grad():
        full = lm.transformer_forward(model, tokens, cfg)
    cache = lm.init_kv_cache(cfg, 2, 12, device="cpu")
    errs = []
    for t in range(12):
        logits, cache = lm.decode_step(model, cache, tokens[:, t], cfg)
        errs.append((logits - full[:, t]).abs().max().item())
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("quant_dtype", [None, torch.int8])
def test_init_kv_cache_matches_jax_layout(quant_dtype):
    jq = None if quant_dtype is None else jnp.int8
    want = jax.tree_util.tree_map(np.asarray, jax_lm.init_kv_cache(JCFG, 3, 20, quant_dtype=jq))
    got = lm.init_kv_cache(PCFG, 3, 20, quant_dtype=quant_dtype, device="cpu")
    assert got.keys() == want.keys() and got["length"] == 0
    for name in ("k", "v", "k_scale", "v_scale"):
        for p, j in zip(got.get(name, []), want.get(name, [])):
            assert tuple(p.shape) == j.shape and not p.any()
            assert str(p.dtype).split(".")[1] == str(j.dtype)
    assert len(got["k"]) == 2


def test_init_kv_cache_fp8_guard_on_cpu():
    """init_kv_cache asks the fp8 guard, as the JAX one does: int8 on the CPU."""
    with pytest.warns(UserWarning, match="native fp8"):
        cache = lm.init_kv_cache(PCFG, 1, 8, quant_dtype=torch.float8_e4m3fn, device="cpu")
    assert cache["k"][0].dtype == torch.int8 and "k_scale" in cache


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
def test_kv_cache_from_jax_keeps_every_bit(kind):
    cfg = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    cache = (jax_lm.init_kv_cache(cfg, 2, 8) if kind == "bf16"
             else jax_lm.init_kv_cache(cfg, 2, 8, quant_dtype=jnp.int8) if kind == "int8"
             else _jax_fp8_cache(cfg, 2, 8))
    rng = np.random.default_rng(3)
    src = rng.standard_normal(cache["k"][0].shape).astype(np.float32) * 100
    cache["k"][1] = jnp.asarray(src).astype(cache["k"][1].dtype)
    if kind != "bf16":
        cache["k_scale"][1] = jnp.asarray(rng.random(cache["k_scale"][1].shape, np.float32))
    cache["length"] = jnp.asarray(5, jnp.int32)
    got = kv_cache_from_jax(jax.tree_util.tree_map(np.asarray, cache), device="cpu")
    assert got["length"] == 5 and isinstance(got["length"], int)
    want = np.asarray(cache["k"][1])
    assert got["k"][1].dtype == {"bf16": torch.bfloat16, "int8": torch.int8,
                                 "fp8": torch.float8_e4m3fn}[kind]
    if kind == "bf16":
        assert np.array_equal(got["k"][1].float().numpy(), want.astype(np.float32))
    elif kind == "fp8":
        assert np.array_equal(got["k"][1].view(torch.uint8).numpy(), want.view(np.uint8))
    else:
        assert np.array_equal(got["k"][1].numpy(), want)
        assert np.array_equal(got["k_scale"][1].numpy(), np.asarray(cache["k_scale"][1]))


def test_decode_on_cpu_launches_no_kernel_and_fills_the_cache(jax_params):
    """A bf16 decode on the CPU runs the plain K1 (no launch), writes the
    cache in place, and refuses a step past max_len."""
    model = _port_model(jax_params, dataclasses.replace(PCFG, dtype=torch.bfloat16))
    cache = lm.init_kv_cache(model.cfg, 2, 3, quant_dtype=torch.int8, device="cpu")
    before = (flash_fwd.fwd.launches, flash_fwd.fwd.launches_int8)
    k0 = cache["k"][0]
    for t in range(3):
        logits, out = lm.decode_step(model, cache, torch.from_numpy(TOKENS[:, t]).long(),
                                     model.cfg)
        assert out is cache and torch.isfinite(logits).all()
    assert cache["length"] == 3 and cache["k"][0] is k0 and k0[:, 2].any()
    assert (flash_fwd.fwd.launches, flash_fwd.fwd.launches_int8) == before
    with pytest.raises(ValueError, match="full"):
        lm.decode_step(model, cache, torch.zeros(2, dtype=torch.long), model.cfg)
