"""The GEMM and roofline probes (K9, K10) and the timing harness of the port
against the JAX package on CPU.

Ports tests/test_quant_gemm.py:72-85 (the tiled-matmul probe against ``a @
b``, and its ValueError): the port's ``matmul`` runs its plain version on a
CPU tensor, the JAX ``matmul`` its Pallas kernel in interpret mode. K10's
plain version is held against the JAX ``_roofline_call`` in interpret mode
(size 128, 2 iterations). Budgets: FWD_TOL[f32] for f32 outputs,
FWD_TOL[bf16] for bf16 ones (the same f32 sums rounded once to bf16). The
harness's median-of-differenced-samples rule is checked on a fake clock.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattn_tpu.ops import gemm as jax_gemm
from flashattn_tpu.ops import roofline as jax_roofline
from flashattn_tpu_torch.ops import gemm, roofline
from flashattn_tpu_torch.utils import timing
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
    """A tensor off the CPU launches K9 or raises: f32 inputs name the
    ROADMAP's f32 item, another device has no kernel."""
    a = torch.empty(128, 128, device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gemm.matmul(a, a)
    with pytest.raises(NotImplementedError, match="meta"):
        gemm.matmul(a.to(torch.bfloat16), a.to(torch.bfloat16))


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
