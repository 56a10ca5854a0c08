"""The GEMM and roofline probes (K9, K10) and the timing harness of the port
against the JAX package on CPU.

Ports tests/test_quant_gemm.py:72-85 (the tiled-matmul probe against ``a @
b``, and its ValueError): the port's ``matmul`` runs its plain version on a
CPU tensor, the JAX ``matmul`` its Pallas kernel in interpret mode. K10's
plain version is held against the JAX ``_roofline_call`` in interpret mode
(size 128, 2 iterations), in bf16 and in f32. On a simulated card (meta
tensors, the device checks off, a stand-in library taking the C entries'
argtypes) f32 inputs reach the f32 forms' entries (``fa_gemm_f32`` with the
pieces' scratch, ``fa_roofline_f32``) and bf16 ones the bf16 entries; K10's
f32 form refuses sizes past its shared memory naming "K10 options".
Budgets: FWD_TOL[f32] for f32 outputs,
FWD_TOL[bf16] for bf16 ones (the same f32 sums rounded once to bf16). The
harness's median-of-differenced-samples rule is checked on a fake clock.
"""

import contextlib
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import gemm as jax_gemm
from flashattn_tpu.ops import roofline as jax_roofline
from flashattn_tpu_torch.ops import gemm, roofline
from flashattn_tpu_torch.utils import native, timing
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("blocks", [(128, 128, 128), (512, 512, 512)])
def test_gemm_probe_matches_jax(blocks):
    a, b = _randn(0, 512, 256), _randn(1, 256, 384)
    bm, bn, bk = blocks
    want = jax_gemm.matmul(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=bn, block_k=bk)
    got = gemm.matmul(torch.from_numpy(a), torch.from_numpy(b), block_m=bm, block_n=bn,
                      block_k=bk)
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])
    assert_close(got, a @ b, FWD_TOL[torch.float32], "vs a @ b")


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
def test_gemm_bf16_inputs_match_jax(out_dtype):
    """bf16 inputs, f32 accumulation, the output in out_dtype (default the
    inputs' dtype), as the JAX probe gives them."""
    a = torch.from_numpy(_randn(2, 256, 128)).to(torch.bfloat16)
    b = torch.from_numpy(_randn(3, 128, 384)).to(torch.bfloat16)
    jdt = None if out_dtype is None else jnp.float32
    want = jax_gemm.matmul(jnp.asarray(a.float().numpy(), jnp.bfloat16),
                           jnp.asarray(b.float().numpy(), jnp.bfloat16), out_dtype=jdt)
    got = gemm.matmul(a, b, out_dtype=out_dtype)
    assert got.dtype == (torch.bfloat16 if out_dtype is None else torch.float32)
    tol = FWD_TOL[got.dtype]
    assert_close(got, np.asarray(want.astype(jnp.float32)), tol)


BAD = {"indivisible": ((100, 128), (128, 128), {}),
       "block not 128-aligned": ((256, 128), (128, 128), {"block_m": 64}),
       "inner dims": ((128, 256), (128, 128), {})}


@pytest.mark.parametrize("case", sorted(BAD))
def test_gemm_rejects_what_jax_rejects(case):
    sa, sb, kw = BAD[case]
    blocks = {"block_m": 128, "block_n": 128, "block_k": 128, **kw}
    with pytest.raises(ValueError):
        jax_gemm.matmul(jnp.zeros(sa), jnp.zeros(sb), **blocks)
    with pytest.raises(ValueError):
        gemm.matmul(torch.zeros(sa), torch.zeros(sb), **blocks)


def test_gemm_takes_no_plain_path_off_the_cpu():
    """A tensor off the CPU launches K9 or raises: f32 inputs (refused until
    K9's f32 form) and bf16 ones on another device have no kernel there, a
    dtype neither bf16 nor f32 and mixed dtypes none at all."""
    a = torch.empty(128, 128, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        gemm.matmul(a, a)
    with pytest.raises(NotImplementedError, match="meta"):
        gemm.matmul(a.to(torch.bfloat16), a.to(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="bfloat16 or float32"):
        gemm.matmul(a.to(torch.float16), a.to(torch.float16))
    with pytest.raises(NotImplementedError, match="one dtype"):
        gemm.matmul(a, a.to(torch.bfloat16))


@pytest.mark.parametrize("iters", [1, 2])
def test_roofline_matches_jax_interpret(iters):
    """K10's plain version (N_CHAINS chains of ``c <- a @ b + 1e-30 c``,
    summed, in bf16) against the JAX ``_roofline_call`` in interpret mode,
    whose recurrence is ``c <- (a + 1e-30 c) @ b``: the same numbers."""
    a = torch.from_numpy(_randn(4, 128, 128)).to(torch.bfloat16)
    b = torch.from_numpy(_randn(5, 128, 128)).to(torch.bfloat16)
    want = jax_roofline._roofline_call(
        jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(b.float().numpy(), jnp.bfloat16),
        iters=iters, size=128, interpret=True)
    got = roofline.roofline_call(a, b, iters=iters, size=128)
    assert got.dtype == torch.bfloat16 and roofline.N_CHAINS == jax_roofline.N_CHAINS
    assert_close(got, np.asarray(want.astype(jnp.float32)), FWD_TOL[torch.bfloat16])


def test_roofline_validation():
    a = torch.zeros(128, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be"):
        roofline.roofline_call(a, a, iters=1, size=64)
    with pytest.raises(ValueError, match="iters"):
        roofline.roofline_call(a, a, iters=0, size=128)
    m = torch.empty(96, 96, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match="multiples of 64|meta"):
        roofline.roofline_call(m, m, iters=1, size=96)


def test_peak_probes_need_the_card():
    """The measurements default to the card and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes would measure it")
    for probe in (roofline.measure_mxu_peak_tflops, roofline.measure_xla_matmul_peak_tflops):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            probe(size=64)


def test_time_chained_stats_differences_two_chains(monkeypatch):
    """On a clock that advances 1 ms per step (and not otherwise), the
    differenced per-step time is exactly 1 ms with zero spread; a short chain
    grows 4x at a time until the differenced span reaches 50 ms."""
    now = [0.0]
    monkeypatch.setattr(timing.time, "perf_counter", lambda: now[0])

    def chain_start(carry, *consts):
        now[0] += 1e-3
        return carry + consts[0]

    stats = timing.time_chained_stats(chain_start, torch.zeros(()), consts=(torch.ones(()),),
                                      iters=64, warmup_iters=8, repeats=3)
    assert stats["per_iter"] == pytest.approx(1e-3) and stats["spread"] == pytest.approx(0.0)
    assert len(stats["samples"]) == 3
    # 10 steps between the chains: 10 ms < 50 ms, so the chains grow to (10, 40), then (40, 160).
    assert timing.time_chained(chain_start, torch.zeros(()), consts=(torch.ones(()),),
                               iters=10, warmup_iters=0, repeats=1) == pytest.approx(1e-3)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("blocks", [(128, 128, 128), (256, 128, 128)])
def test_gemm_f32_inputs_match_jax_interpret(blocks, out_dtype):
    """f32 inputs (K9's f32 form on the card: six bf16 products per f32
    product) against the JAX probe's Pallas kernel in interpret mode, the
    output f32 by default or bf16 through out_dtype, as the JAX probe gives
    them."""
    a, b = _randn(6, 256, 384), _randn(7, 384, 128)
    bm, bn, bk = blocks
    jdt = None if out_dtype is None else jnp.bfloat16
    want = jax_gemm.matmul(jnp.asarray(a), jnp.asarray(b), block_m=bm, block_n=bn, block_k=bk,
                           out_dtype=jdt)
    got = gemm.matmul(torch.from_numpy(a), torch.from_numpy(b), block_m=bm, block_n=bn,
                      block_k=bk, out_dtype=out_dtype)
    assert got.dtype == (out_dtype or torch.float32)
    assert_close(got, np.asarray(want.astype(jnp.float32)), FWD_TOL[got.dtype])


@pytest.mark.parametrize("iters", [1, 2])
def test_roofline_f32_matches_jax_interpret(iters):
    """K10's plain version on f32 a, b against the JAX ``_roofline_call``
    with dtype f32 in interpret mode (its products at Precision.HIGHEST)."""
    a, b = _randn(8, 128, 128), _randn(9, 128, 128)
    want = jax_roofline._roofline_call(jnp.asarray(a), jnp.asarray(b), iters=iters, size=128,
                                       interpret=True)
    got = roofline.roofline_call(torch.from_numpy(a), torch.from_numpy(b), iters=iters, size=128)
    assert got.dtype == torch.float32
    assert_close(got, np.asarray(want), FWD_TOL[torch.float32])


def _recorder(name, argtypes, calls):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: calls.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones (the probes' device checks off); the
    stand-in library records each entry called with its typed arguments."""
    calls = []
    typed = {"fa_gemm_bf16": native.GEMM_ARGTYPES, "fa_gemm_f32": native.GEMM_F32_ARGTYPES,
             "fa_roofline_bf16": native.ROOFLINE_ARGTYPES,
             "fa_roofline_f32": native.ROOFLINE_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    monkeypatch.setattr(native, "kernels", lambda: lib)
    for mod in (gemm, roofline):
        monkeypatch.setattr(mod, "_check_device", lambda a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    return calls


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_routes_by_input_dtype(card, dtype, out_dtype):
    """f32 inputs reach fa_gemm_f32 once, with the bf16 scratch of a's and b's
    three pieces (3 (M K + K N) elements) after out, counted as K9's f32 form
    and its split; bf16 inputs fa_gemm_bf16, without one. M, N, K and the
    output's dtype code as the C entries take them."""
    M, K, N = 256, 384, 128
    a = torch.empty((M, K), dtype=dtype, device="meta")
    b = torch.empty((K, N), dtype=dtype, device="meta")
    sizes = []
    real_empty = torch.empty
    before = (gemm.matmul.launches, gemm.matmul.launches_f32, gemm.matmul.launches_split)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "empty", lambda *s, **kw: sizes.append((s, kw.get("dtype")))
                   or real_empty(*s, **kw))
        out = gemm.matmul(a, b, out_dtype=out_dtype)
    f32 = dtype == torch.float32
    assert [n for n, _ in card] == ["fa_gemm_f32" if f32 else "fa_gemm_bf16"]
    args = card[0][1]
    assert args[-5 if f32 else -5:] == (M, N, K, int(out.dtype == torch.float32), 77)
    assert out.dtype == (out_dtype or dtype) and out.shape == (M, N)
    assert ((((3 * (M * K + K * N),), torch.bfloat16) in sizes) == f32)
    assert (gemm.matmul.launches - before[0], gemm.matmul.launches_f32 - before[1],
            gemm.matmul.launches_split - before[2]) == (1, int(f32), int(f32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roofline_routes_by_dtype(card, dtype):
    """K10 on f32 reaches fa_roofline_f32 (its f32 form, f32 out), on bf16
    fa_roofline_bf16, with the size and the iterations."""
    a = torch.empty((256, 256), dtype=dtype, device="meta")
    before = (roofline.roofline_call.launches, roofline.roofline_call.launches_f32)
    out = roofline.roofline_call(a, a, iters=3, size=256)
    name = "fa_roofline_f32" if dtype == torch.float32 else "fa_roofline_bf16"
    assert [n for n, _ in card] == [name] and card[0][1][3:] == (256, 3, 77)
    assert out.dtype == dtype
    assert (roofline.roofline_call.launches - before[0],
            roofline.roofline_call.launches_f32 - before[1]) == (1, int(dtype == torch.float32))


def test_roofline_f32_refuses_sizes_past_its_panels(card):
    """K10's f32 form keeps its panels' three pieces in shared memory up to
    F32_MAX_SIZE (512); past it the refusal names the ROADMAP's K10 options,
    while bf16 still takes sizes up to MAX_SIZE."""
    a = torch.empty((576, 576), device="meta")
    with pytest.raises(NotImplementedError, match="K10 options"):
        roofline.roofline_call(a, a, iters=1, size=576)
    roofline.roofline_call(a.to(torch.bfloat16), a.to(torch.bfloat16), iters=1, size=576)
    assert [n for n, _ in card] == ["fa_roofline_bf16"]
