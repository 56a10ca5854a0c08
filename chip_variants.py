"""Time the design variants of the TMA + wgmma kernels against the committed ones, on one GPU.

    python3 chip_variants.py [ring] [bias] [k3] [k1cap] [k1wide] [f32] [f32bias]

(every family without an argument). Each variant is a committed source
with one design choice undone by text patches (of the source, or of the
header that holds its body, or of both), built alone (nvcc, all at once, ``ptxas -v``) into its own library under
``flashattn_tpu_torch/build/variants/`` and called through the wrappers'
argument packing. Family
``ring``, ``csrc/ring_fwd.cu`` / ``csrc/ring_bwd.cu`` through
``ring_kernel._launch_fwd`` / ``_launch_bwd``:

* ``K8``: as committed (S^T first, P^T rounded to bf16 for dV and to fp16
  for dS^T, then dP^T beside dV; the dQ tile staged and added by one bulk
  reduction);
* ``K8 S+dP together``: S^T and dP^T issued together, dS^T from the f32 P^T
  (the first design: more registers live at once);
* ``K8 bf16 P in dS``: dS^T from the bf16 P^T that dV takes, no fp16 copy;
* ``K8 232 registers``: the consumers given 232 registers (setmaxnreg) and
  the producer 40, in place of 240 and 24;
* ``K8 red.v4``: dQ added from registers by ``red.global.add.v4.f32``, no
  stage and no bulk reduction;
* ``K7``: as committed (a 4-stage K / V ring); ``K7 6 stages``.

At the ring's main shape (B1 Hq16 Hkv8 D128 causal, chunks of 4096) each K8
variant's step is held against ``ring_bwd_step_reference`` (max abs and
relative L2 errors of dQ, dK, dV, printed), then every variant is timed in
turns (3 rounds, each variant once a round, chip_smoke.cuda_ms) on the
off-diagonal and the diagonal chunk pair.

Family ``bias``, K5 + K6's bias route ``csrc/bwd_bias_sm90.cu`` (its body
``csrc/bwd_sm90_tile.cuh``, which the patches change) through
``flash_bwd._launch_bias_bwd``:

* ``bias bwd``: as committed (the bias stage released once P^T is formed,
  dbias by streaming stores, dQ by one bulk reduction per tile);
* ``bias bwd no dQ``: no dQ product, stage or reduction (dQ stays 0): what
  dQ costs inside the KV-major pass, against a Q-major K6 of its own;
* ``bias bwd bias to the end``: each warp releases the bias stage with the
  (Q, dO) stage, at the tile's end, so the next tile's bias is not loaded
  under this tile's products;
* ``bias bwd plain dbias stores``: dbias by plain stores, not ``st.global.cs``;
* ``bias bwd 232 registers``: the consumers given 232 registers and the
  producer 40;
* ``bias bwd no dQ reduction``, ``bias bwd no dQ stage writes``: dQ's
  product and stage kept without the bulk reduction, or its product and
  reduction without the stage's writes (dQ wrong in both): which of the two
  makes dQ's cost.

At path A's shape (B4 H16 N2048 D128) with its mask arm's key-padding bias
[4, 1, N, N] (no dbias) and its learned arm's [4, 16, N, N] bias (dbias),
each variant is held against ``bias_bwd_reference`` (errors printed), then
timed in turns as the ring's.

Family ``k3``, K3 ``csrc/flash_bwd_sm90.cu`` (its body
``csrc/bwd_sm90_tile.cuh``) through ``flash_bwd_fused._launch``, the grid's
two owners of a CTA:

* ``K3``: as committed, one CTA per (query head, KV tile of 128), dK / dV
  per query head, summed over each KV head's group by the caller;
* ``K3 per KV head``: one CTA per (KV head, KV tile), its Hq / Hkv query
  heads in turn, dK / dV per KV head (half the CTAs at GQA 16 / 8): the
  grid's x extent and the body's owner patched.

At the LM's shape (B1 Hq16 Hkv8 N2048 D128 causal) and the SWA shape (N8192,
window 2047 to the left, causal) each is held against ``bwd_reference``
(dK / dV summed over the group), then timed in turns, the caller's sum of
the committed kernel's per-query-head dK / dV included.

Family ``k1cap``, K1's dense route ``csrc/flash_fwd_sm90.cu`` (its body
``csrc/fwd_sm90_tile.cuh``) through ``flash_fwd._launch_dense_sm90``, with
the logit softcap:

* ``K1 cap``: as committed, the accurate ``tanhf`` (an exponential and a
  reciprocal on the MUFU pipe per score, beside the softmax's ex2);
* ``K1 cap tanh.approx``: one ``tanh.approx.f32`` per score (a single MUFU
  operation, ~2^-11 relative error), which the backward's recompute would
  then have to share.

At the soft-capped SWA shape (B1 Hq16 Hkv8 N8192 D128, window 2047 to the
left, causal, cap 50, q and k at 4x) each is held against ``fwd_reference``
(O's max abs and relative L2 errors, LSE's max abs error, printed), then
timed in turns.

Family ``k1wide``, K1's dense route's D 256 form (``csrc/flash_fwd_sm90.cu``,
its body ``csrc/fwd_sm90_tile.cuh``) through ``flash_fwd._launch_dense_sm90``:

* ``K1 D256``: as committed (two (K, V) stages, K and V of a stage on one
  barrier, K's boxes issued before V's; 24 producer and 240 consumer
  registers);
* ``K1 D256 interleaved``: K's and V's boxes issued in turn, the dense
  route's earlier order;
* ``K1 D256 K / V barriers``: K and V on barriers of their own, so that S =
  Q K^T starts once K has landed and V's copy runs under it (the first
  design);
* ``K1 D256 224 registers``: the D <= 128 split, 56 producer and 224
  consumer registers.

At the D 256 LM's attention (B1 Hq8 Hkv4 N2048 D256 causal) each is held
against ``fwd_reference`` (O's max abs and relative L2 errors, LSE's max abs
error, printed), then timed in turns over 10 rounds, there, non-causal
(every KV tile visited) and at the D 128 LM's attention (B1 Hq16 Hkv8 N2048
D128 causal: the copy order is shared), and each round's pairs against the
committed form are counted.

Family ``f32``, the f32 backward ``csrc/flash_bwd_f32.cu`` (built with the
split ``csrc/split_bf16x3.cu``, which its C entry launches first) through
``flash_bwd._launch_split``:

* ``bwd f32``: as committed, each of its wgmma m64n32k16 chains (six
  products of D / 16 or 4 k-steps) a loop over the six products that is not
  unrolled;
* ``bwd f32 unroll 6``: that loop unrolled, which crashes ptxas 12.9 (exit
  139): a variant in ``BUILD_FAILS``, whose failed build is reported
  and left out (as are unroll 2 and 3, a fence per product, a shuffled
  warpgroup index and unrolled m64n64k16 chains, PERF.md PR 17);
* ``bwd f32 n64``: the chains on m64n64k16 (twice the columns, the upper
  half read past each piece and dropped), the loop kept;
* ``bwd f32 paired dQ``: dQ^T's two 64-column halves (D 128) as two chains
  in one loop over the products, one wait for both;
* ``bwd f32 paired S dP``: S^T and dP^T as two chains in one loop, both
  retired before P^T is formed;
* ``bwd f32 descriptors first``: each product's eight descriptors computed
  before a fence of its own, the accumulator zeroed first and every product
  added, so that ptxas injects no fence (ptxas 12.9 crashes on it since the
  body's BIAS family: in ``BUILD_FAILS`` too).

At the f32 LM's shape (B1 Hq16 Hkv8 N2048 D128 causal, f32, TF32 off) each
is held against ``bwd_reference``, then timed in turns, the split of q, k,
v and dO included.

Family ``f32bias``, the f32 backward's BIAS family (the same source), where
each consumer thread reads its 16 bias values of a tile from global memory
straight into S^T's fragment layout:

* ``bwd f32 bias``: as committed, the loads issued right after S^T and dP^T,
  before S^T's wait, so that they land while both products run;
* ``bwd f32 bias after S``: the loads issued once S^T has retired (dP^T
  still running), as a just-in-time read would place them.

At f32 path A's attention (B4 H16 N2048 D128, f32, TF32 off) with the mask
arm's bias ([4, 1, N, N], no dbias) and the learned arm's ([4, 16, N, N],
dbias) each is held against ``bias_bwd_reference``, then timed in turns over
3 rounds, the split included. Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs


def _between(src: str, start: str, end: str, new: str) -> str:
    a = src.index(start)
    b = src.index(end, a) + len(end)
    return src[:a] + new + src[b:]


def _together(src: str) -> str:
    src = src.replace("""      issue_qk<D, RB_BLOCK_N, RB_BLOCK_M>(sc, k_s, q_st);
      wgmma_wait<0>();
""", """      issue_qk<D, RB_BLOCK_N, RB_BLOCK_M>(sc, k_s, q_st);
      issue_qk<D, RB_BLOCK_N, RB_BLOCK_M>(dp, v_s, do_st);
      wgmma_wait<1>();
""")
    return _between(src, "      // P^T in bf16 (the A fragments", "      pack_p(da, dp);\n", """\
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dp[4 * jj + 2 * r] = sc[4 * jj + 2 * r] * (dp[4 * jj + 2 * r] - dl.x);
          dp[4 * jj + 2 * r + 1] = sc[4 * jj + 2 * r + 1] * (dp[4 * jj + 2 * r + 1] - dl.y);
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_p(pa, sc);
      pack_p(da, dp);
      issue_pv<D, RB_BLOCK_M>(dv, pa, do_st);
""")


def _bf16_p(src: str) -> str:
    return _between(src, "      uint32_t pa[4][4], ph[16], da[4][4];", "      pack_p(da, dp);\n", """\
      uint32_t pa[4][4], da[4][4];
      pack_p(pa, sc);
      issue_qk<D, RB_BLOCK_N, RB_BLOCK_M>(dp, v_s, do_st);
      issue_pv<D, RB_BLOCK_M>(dv, pa, do_st);
      wgmma_wait<1>();
      fence_regs(dp);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t pp = pa[jj / 2][2 * (jj & 1) + r];
          dp[4 * jj + 2 * r] = __uint_as_float(pp << 16) * (dp[4 * jj + 2 * r] - dl.x);
          dp[4 * jj + 2 * r + 1] =
              __uint_as_float(pp & 0xffff0000u) * (dp[4 * jj + 2 * r + 1] - dl.y);
        }
      }
      pack_p(da, dp);
""")


def _red_v4(src: str) -> str:
    src = src.replace("      if (issuer) bulk_wait_read();", "")
    return _between(src, "        // dq[4jj + 2r + e]: query row", "        named_arrive(2, 256);\n      }\n",
                    """\
        // Even t adds row g's 4 columns 8jj + 2t.., odd t row g + 8's from 2t - 2.
        float* dq_g = p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m0) * p.d + half * 64;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const bool odd = t & 1;
          const float rx = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * jj] : dq[4 * jj + 2], 1);
          const float ry = __shfl_xor_sync(0xffffffffu, odd ? dq[4 * jj + 1] : dq[4 * jj + 3], 1);
          const float4 x = odd ? make_float4(rx, ry, dq[4 * jj + 2], dq[4 * jj + 3])
                               : make_float4(dq[4 * jj], dq[4 * jj + 1], rx, ry);
          const int col = 8 * jj + 2 * (t & 2);
          if (half * 64 + col < p.d) {
            asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\\n" ::"l"(
                             dq_g + (warp * 16 + g + (odd ? 8 : 0)) * p.d + col),
                         "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
                         : "memory");
          }
        }
      }
""")


def _no_dq(src: str) -> str:
    return src.replace("const bool does_dq = half < BOXES;", "const bool does_dq = false;").replace(
        "      if (issuer_warp) {\n        named_sync(2, 256);",
        "      if (false) {\n        named_sync(2, 256);")


def _bias_to_end(src: str) -> str:
    src = src.replace("""      if constexpr (BIAS) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&bias_empty[bs]);  // this warp is done with the bias tile
      }
""", "")
    return src.replace("if (lane == 0) mbar_arrive(&empty[s]);",
                       "if (lane == 0) {\n        mbar_arrive(&empty[s]);\n"
                       "        mbar_arrive(&bias_empty[bs]);\n      }")


def _regs(s: str) -> str:
    return s.replace("setmaxnreg.dec.sync.aligned.u32 24", "setmaxnreg.dec.sync.aligned.u32 40"
                     ).replace("setmaxnreg.inc.sync.aligned.u32 240",
                               "setmaxnreg.inc.sync.aligned.u32 232")


def _tanh_approx(src: str) -> str:
    return src.replace(
        "if constexpr (CAP) return cap_log2 * tanhf(s * cap_scale);  // K1 sm90 tanh",
        "if constexpr (CAP) {\n    float t;\n"
        "    asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(t) : \"f\"(s * cap_scale));\n"
        "    return cap_log2 * t;\n  }")


# K and V of each (K, V) stage at D 256 on barriers of their own (v_full).
_KV_BARRIERS = (
    ("  static constexpr int STAGES = D == 256 ? 2 : D == 64 || !BIAS ? 4 : 3;\n",
     "  static constexpr int STAGES = D == 256 ? 2 : D == 64 || !BIAS ? 4 : 3;\n"
     "  static constexpr bool KV_SPLIT = D == 256;\n"),
    ("BYTES = 1024 + BARS + (1 + 2 * STAGES) * 8;",
     "BYTES = 1024 + BARS + (1 + (KV_SPLIT ? 3 : 2) * STAGES) * 8;"),
    ("  uint64_t* empty = full + S::STAGES;\n",
     "  uint64_t* empty = full + S::STAGES;\n"
     "  uint64_t* v_full = S::KV_SPLIT ? empty + S::STAGES : full;\n"),
    ("      mbar_init(&empty[s], 8);  // one arrival per consumer warp\n",
     "      mbar_init(&empty[s], 8);  // one arrival per consumer warp\n"
     "      if (S::KV_SPLIT) mbar_init(&v_full[s], 1);\n"),
    ("k1wide).\n        mbar_expect_tx(&full[s], 2 * S::KV + (SEG ? FB_BLOCK_N * 4 : 0));\n",
     "k1wide).\n"
     "        mbar_expect_tx(&full[s], (S::KV_SPLIT ? 1 : 2) * S::KV + (SEG ? FB_BLOCK_N * 4 : 0));\n"
     "        if (S::KV_SPLIT) mbar_expect_tx(&v_full[s], S::KV);\n"),
    ("          tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0, hk,\n",
     "          tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &v_full[s], 64 * x, n0, hk,\n"),
    ("""        pack_p(pa, sc);
        issue_pv<D, FB_BLOCK_N>(o, pa, stage(it) + S::KV);""",
     """        pack_p(pa, sc);
        if (S::KV_SPLIT) mbar_wait(&v_full[s], (it / S::STAGES) & 1);
        issue_pv<D, FB_BLOCK_N>(o, pa, stage(it) + S::KV);"""),
    ("""        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      }
      release(it);""", """        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      } else if (S::KV_SPLIT) {
        mbar_wait(&v_full[s], (it / S::STAGES) & 1);
      }
      release(it);"""),
)


# K's and V's boxes of each stage issued in turn (K0 V0 K1 V1 ...), the earlier order.
_INTERLEAVED = ("""#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
        }
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + S::KV""", """#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
          tma_load_4d(st + S::KV""")


def _interleaved(src: str) -> str:
    assert src.count(_INTERLEAVED[0]) == 1, "the interleaved-copies patch no longer applies"
    return src.replace(*_INTERLEAVED)


def _kv_barriers(src: str) -> str:
    for old, new in _KV_BARRIERS:
        assert src.count(old) == 1, f"the K / V barriers patch no longer applies at {old[:60]!r}"
        src = src.replace(old, new)
    return src


# The D 256 form's register split as at D <= 128: 56 producer, 224 consumer.
_REGS_56_224 = (
    ("constexpr int PRODUCER_REGS = D == 256 ? 24 : 56;", "constexpr int PRODUCER_REGS = 56;"),
    ("constexpr int CONSUMER_REGS = D == 256 ? 240 : 224;", "constexpr int CONSUMER_REGS = 224;"))


def _regs_56_224(src: str) -> str:
    for old, new in _REGS_56_224:
        assert src.count(old) == 1, f"the 224-register patch no longer applies at {old!r}"
        src = src.replace(old, new)
    return src


def _n64(src: str) -> str:
    """The f32 backward's six-product chains on wgmma m64n64k16 into 32-float
    accumulators whose upper 32 columns (the next 32 rows of shared memory,
    read and discarded) are dropped: whether ptxas takes them unrolled."""
    import re

    from flashattn_tpu_torch.utils import native

    sm90 = (native.CSRC / "sm90.cuh").read_text()
    body = re.search(r"__device__ __forceinline__ void wgmma_ss_m64n64k16\(.*?\n}\n", sm90,
                     re.S).group(0)
    tt = body.replace("wgmma_ss_m64n64k16(", "wgmma_ss_m64n64k16_ta(").replace(
        "p, 1, 1, 0, 0;", "p, 1, 1, 1, 0;")
    helper = tt + """
template <int TA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  if constexpr (TA == 0) {
    wgmma_ss_m64n64k16(d, a, b, acc);
  } else {
    wgmma_ss_m64n64k16_ta(d, a, b, acc);
  }
}

"""
    for old, new in (
            ("// acc = the six bf16 products of A's pieces", helper + "// acc = the six bf16 "
             "products of A's pieces"),
            ("void issue_ss6(float (&acc)[16],", "void issue_ss6(float (&acc)[32],"),
            ("      wgmma_ss_m64n32k16<TA>(acc,", "      wgmma_n64<TA>(acc,"),
            ("      float sc[16], dp[16];\n", "      float sc64[32], dp64[32], sc[16], dp[16];\n"),
            ("issue_ss6<0, D / 16>(sc, k_s", "issue_ss6<0, D / 16>(sc64, k_s"),
            ("issue_ss6<0, D / 16>(dp, v_s", "issue_ss6<0, D / 16>(dp64, v_s"),
            ("      wgmma_wait<1>();\n      fence_regs(sc);\n",
             "      wgmma_wait<1>();\n      fence_regs(sc64);\n"
             "      for (int i = 0; i < 16; ++i) sc[i] = sc64[i];\n"),
            ("      wgmma_wait<0>();\n      fence_regs(dp);\n",
             "      wgmma_wait<0>();\n      fence_regs(dp64);\n"
             "      for (int i = 0; i < 16; ++i) dp[i] = dp64[i];\n"),
            ("        float dq[16];\n", "        float dq64[32], dq[16];\n"),
            ("            dq, k_s + x * F32B_BLOCK_N", "            dq64, k_s + x * F32B_BLOCK_N"),
            ("        wgmma_wait<0>();\n        fence_regs(dq);\n",
             "        wgmma_wait<0>();\n        fence_regs(dq64);\n"
             "        for (int i = 0; i < 16; ++i) dq[i] = dq64[i];\n")):
        assert old in src, old
        src = src.replace(old, new)
    return src


_PAIRED = """
// Two chains of six products in one loop over the products: acc0 = A0 B0,
// acc1 = A1 B1 (K-major B, pieces 32 rows apart; A pieces a_piece apart).
template <int TA, int K_STEPS, typename AK, typename BK>
__device__ __forceinline__ void issue_ss6x2(float (&acc0)[16], float (&acc1)[16],
                                            const unsigned char* a_s0, const unsigned char* a_s1,
                                            int a_piece, const unsigned char* b_s0,
                                            const unsigned char* b_s1, AK a_k, BK b_k,
                                            uint32_t a_lbo) {
  const uint64_t a0 = opaque(smem_desc(a_s0, a_lbo, 1024));
  const uint64_t a1 = opaque(smem_desc(a_s1, a_lbo, 1024));
  const uint64_t b0 = opaque(smem_desc(b_s0, 16, 1024));
  const uint64_t b1 = opaque(smem_desc(b_s1, 16, 1024));
  wgmma_fence();
#pragma unroll 1
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < K_STEPS; ++kk) {
      const int da = (pair_a(x) * a_piece + a_k(kk)) >> 4;
      const int db = (pair_b(x) * F32B_BLOCK_M * SW128_ROW + b_k(kk)) >> 4;
      wgmma_ss_m64n32k16<TA>(acc0, a0 + da, b0 + db, x > 0 || kk > 0);
      wgmma_ss_m64n32k16<TA>(acc1, a1 + da, b1 + db, x > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

"""


def _paired_dq(src: str) -> str:
    """dQ^T's two 64-column halves (D 128) as two chains of one loop."""
    src = src.replace("template <int N>\n__device__ __forceinline__ void zero(",
                      _PAIRED + "template <int N>\n__device__ __forceinline__ void zero(")
    old = src[src.index("#pragma unroll\n      for (int x = 0; x < BOXES; ++x) {\n        float dq[16];"):
              src.index("      fence_proxy_async();\n      named_sync(2, 128);")]
    new = """      float dqs[2][16];
      if constexpr (BOXES == 2) {
        issue_ss6x2<1, F32B_BLOCK_N / 16>(
            dqs[0], dqs[1], k_s, k_s + F32B_BLOCK_N * SW128_ROW, S::KVP, ds_s, ds_s,
            [](int kk) { return kk * 16 * SW128_ROW; }, d_step, F32B_BLOCK_N * SW128_ROW);
      } else {
        issue_ss6<1, F32B_BLOCK_N / 16>(
            dqs[0], k_s, S::KVP, ds_s, [](int kk) { return kk * 16 * SW128_ROW; }, d_step,
            F32B_BLOCK_N * SW128_ROW);
      }
      wgmma_wait<0>();
      fence_regs(dqs[0]);
      fence_regs(dqs[1]);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        const float (&dq)[16] = dqs[x];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 64 * x + tw * 16 + tg + 8 * r;
          if (col >= d) continue;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dq_stage[(8 * jj + 2 * tt) * d + col] = dq[4 * jj + 2 * r];
            dq_stage[(8 * jj + 2 * tt + 1) * d + col] = dq[4 * jj + 2 * r + 1];
          }
        }
      }
"""
    return src.replace(old, new)


def _paired_sdp(src: str) -> str:
    """S^T and dP^T as two chains of one loop, both retired before P^T."""
    src = src.replace("template <int N>\n__device__ __forceinline__ void zero(",
                      _PAIRED + "template <int N>\n__device__ __forceinline__ void zero(")
    old = ("      issue_ss6<0, D / 16>(sc, k_s, S::KVP, q_st, a_d, b_d, 16);\n"
           "      issue_ss6<0, D / 16>(dp, v_s, S::KVP, do_st, a_d, b_d, 16);\n")
    wait = "      wgmma_wait<1>();\n      fence_regs(sc);\n"  # S^T's, after the bias loads
    assert old in src and wait in src
    src = src.replace(old, "      issue_ss6x2<0, D / 16>(sc, dp, k_s, v_s, S::KVP, q_st, do_st, a_d, "
                           "b_d, 16);\n")
    return src.replace(wait, "      wgmma_wait<0>();\n      fence_regs(sc);\n", 1)


_SS6_LOOP = """  wgmma_fence();
#pragma unroll 1  // unrolled, the chains crash ptxas 12.9 (the header)
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < K_STEPS; ++kk) {
      wgmma_ss_m64n32k16<TA>(acc, a0 + ((pair_a(x) * a_piece + a_k(kk)) >> 4),
                             b0 + ((pair_b(x) * F32B_BLOCK_M * SW128_ROW + b_k(kk)) >> 4),
                             x > 0 || kk > 0);
    }
  }
"""


_DESC_FIRST_LOOP = """  zero(acc);
#pragma unroll 1
  for (int x = 0; x < 6; ++x) {
    uint64_t da[K_STEPS], db[K_STEPS];
#pragma unroll
    for (int kk = 0; kk < K_STEPS; ++kk) {
      da[kk] = opaque(a0 + ((pair_a(x) * a_piece + a_k(kk)) >> 4));
      db[kk] = opaque(b0 + ((pair_b(x) * F32B_BLOCK_M * SW128_ROW + b_k(kk)) >> 4));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K_STEPS; ++kk) {
      wgmma_ss_m64n32k16<TA>(acc, da[kk], db[kk], 1);
    }
  }
"""


def _desc_first(src: str) -> str:
    """Each product's descriptors computed (and made opaque) before a fence of
    its own, so that no register a wgmma reads is written after the last
    fence (what ptxas otherwise fixes by injecting one, C7519 / C7520); the
    accumulator zeroed first and every product added to it."""
    assert _SS6_LOOP in src
    src = src.replace(_SS6_LOOP, _DESC_FIRST_LOOP)
    # zero() is defined after issue_ss6: move it before
    z = ("template <int N>\n__device__ __forceinline__ void zero(float (&x)[N]) {\n"
         "#pragma unroll\n  for (int i = 0; i < N; ++i) x[i] = 0.f;\n}\n\n")
    assert z in src
    return src.replace(z, "").replace("// acc = the six bf16 products of A's pieces",
                                      z + "// acc = the six bf16 products of A's pieces")


BIAS_BODY = "bwd_sm90_tile.cuh"
# name: (source, ((the file a patch changes, patch), ...)).
VARIANTS = {
    "K8": ("ring_bwd.cu", ()),
    "K8 S+dP together": ("ring_bwd.cu", (("ring_bwd.cu", _together),)),
    "K8 bf16 P in dS": ("ring_bwd.cu", (("ring_bwd.cu", _bf16_p),)),
    "K8 232 registers": ("ring_bwd.cu", (("ring_bwd.cu", _regs),)),
    "K8 red.v4": ("ring_bwd.cu", (("ring_bwd.cu", _red_v4),)),
    "K7": ("ring_fwd.cu", ()),
    "K7 6 stages": ("ring_fwd.cu", (("ring_fwd.cu", lambda s: s.replace(
        "static constexpr int STAGES = 4;", "static constexpr int STAGES = 6;")),)),
    "bias bwd": ("bwd_bias_sm90.cu", ()),
    "bias bwd no dQ": ("bwd_bias_sm90.cu", ((BIAS_BODY, _no_dq),)),
    "bias bwd bias to the end": ("bwd_bias_sm90.cu", ((BIAS_BODY, _bias_to_end),)),
    "bias bwd plain dbias stores": ("bwd_bias_sm90.cu", ((BIAS_BODY, lambda s: s.replace(
        "__stcs(dst, b0)", "*dst = b0").replace("__stcs(dst + p.nk, b1)", "dst[p.nk] = b1")),)),
    "bias bwd no dQ reduction": ("bwd_bias_sm90.cu", ((BIAS_BODY, lambda s: s.replace(
        "        if (lane == 0) {\n          // Only the tile's rows below Nq",
        "        if (false) {\n          // Only the tile's rows below Nq")),)),
    "bias bwd no dQ stage writes": ("bwd_bias_sm90.cu", ((BIAS_BODY, lambda s: s.replace(
        "            *reinterpret_cast<float2*>(srow + 8 * jj + 2 * t) =",
        "            if (p.nq < 0) *reinterpret_cast<float2*>(srow + 8 * jj + 2 * t) =")),)),
    "bias bwd 232 registers": ("bwd_bias_sm90.cu", ((BIAS_BODY, _regs),)),
    "K3": ("flash_bwd_sm90.cu", ()),
    "K3 per KV head": ("flash_bwd_sm90.cu", (
        ("flash_bwd_sm90.cu", lambda s: s.replace("const dim3 grid(p.hq, ",
                                                  "const dim3 grid(p.hq / p.rep, ")),
        (BIAS_BODY, lambda s: s.replace("    h0 = blockIdx.x;\n    hk = h0 / p.rep;\n"
                                        "    heads = 1;\n",
                                        "    hk = blockIdx.x;\n    h0 = hk * p.rep;\n"
                                        "    heads = p.rep;\n")))),
    "K1 cap": ("flash_fwd_sm90.cu", ()),
    "K1 cap tanh.approx": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _tanh_approx),)),
    "K1 D256": ("flash_fwd_sm90.cu", ()),
    "K1 D256 interleaved": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _interleaved),)),
    "K1 D256 K / V barriers": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _kv_barriers),)),
    "K1 D256 224 registers": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _regs_56_224),)),
    "bwd f32": ("flash_bwd_f32.cu", ()),
    "bwd f32 unroll 6": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", lambda s: s.replace(
        "#pragma unroll 1  // unrolled,", "#pragma unroll 6  // unrolled,")),)),
    "bwd f32 n64": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _n64),)),
    "bwd f32 paired dQ": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _paired_dq),)),
    "bwd f32 paired S dP": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _paired_sdp),)),
    "bwd f32 descriptors first": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _desc_first),)),
    "bwd f32 bias": ("flash_bwd_f32.cu", ()),
    "bwd f32 bias after S": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", lambda s: s.replace(
        "      if constexpr (BIAS) {  // bwd f32 bias prefetch",
        "      wgmma_wait<1>();\n      fence_regs(sc);\n"
        "      if constexpr (BIAS) {  // bwd f32 bias prefetch")),)),
}
# Variants known not to build, kept as witnesses: a failed build of one of
# these is reported and left out; any other variant that fails stops the run.
# ptxas 12.9 exits 139 on both: the unrolled chains (PERF.md) and, since the
# body's BIAS family, the descriptors computed first (its BIAS instantiations).
BUILD_FAILS = {"bwd f32 unroll 6", "bwd f32 descriptors first"}
# The C entry, its argument types and the family of each source.
ENTRIES = {"ring_bwd.cu": ("fa_ring_bwd_bf16", "RING_BWD_ARGTYPES", "ring"),
           "ring_fwd.cu": ("fa_ring_fwd_bf16", "RING_FWD_ARGTYPES", "ring"),
           "bwd_bias_sm90.cu": ("fa_bwd_bias_sm90", "BWD_BIAS_SM90_ARGTYPES", "bias"),
           "flash_bwd_sm90.cu": ("fa_bwd_sm90", "BWD_SM90_ARGTYPES", "k3"),
           "flash_fwd_sm90.cu": ("fa_fwd_sm90", "FWD_SM90_ARGTYPES", "k1cap"),
           "flash_bwd_f32.cu": ("fa_bwd_f32", "BWD_F32_ARGTYPES", "f32")}
# Variants whose family is not their source's.
FAMILY = {"K1 D256": "k1wide", "K1 D256 interleaved": "k1wide", "K1 D256 K / V barriers": "k1wide",
          "K1 D256 224 registers": "k1wide", "bwd f32 bias": "f32bias",
          "bwd f32 bias after S": "f32bias"}


def _family(name: str) -> str:
    return FAMILY.get(name, ENTRIES[VARIANTS[name][0]][2])


# Sources a variant's library is linked with beside its own.
EXTRA_SOURCES = {"flash_bwd_f32.cu": ("split_bf16x3.cu",)}


def build(families) -> dict:
    """{name: loaded library} of the variants of ``families``, with each
    variant's ptxas registers and spills printed; a variant that does not
    build stops the run, unless it is in BUILD_FAILS (then it is printed and
    left out)."""
    from flashattn_tpu_torch.utils import native

    root = native.BUILD_DIR / "variants"
    procs = {}
    for i, (name, (src, patches)) in enumerate(VARIANTS.items()):
        if _family(name) not in families:
            continue
        d = root / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(native.CSRC, d)
        for target, fn in patches:
            text = (d / target).read_text()
            new = fn(text)
            assert new != text, f"a patch of {name} no longer applies to {target}"
            (d / target).write_text(new)
        procs[name] = (d, subprocess.Popen(
            [native.find_nvcc(), *native.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             str(d / "lib.so"), str(d / src), *(str(d / x) for x in EXTRA_SOURCES.get(src, ()))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode and name in BUILD_FAILS:
            print(f"[build] {name}: failed as known (exit {proc.returncode}), left out: "
                  f"{(err + out)[-600:]}", flush=True)
            continue
        if proc.returncode:
            raise SystemExit(f"chip_variants: {name} failed to build:\n{err[-4000:]}")
        if name in BUILD_FAILS:
            print(f"[build] {name}: built, though listed in BUILD_FAILS", flush=True)
        for entry, (regs, stack, st, ld) in cs.ptxas_stats(err + out).items():
            print(f"[build] {name}: {entry}: {regs} registers, {stack} B stack, {st} / {ld} B "
                  "spill stores / loads", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        entry, argtypes, _ = ENTRIES[VARIANTS[name][0]]
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = getattr(native, argtypes)
        libs[name] = lib
    return libs


def ring(libs: dict) -> None:
    from flashattn_tpu_torch.parallel import ring_kernel as rk
    from flashattn_tpu_torch.utils.testing import make_qkv

    c, hq, hkv, d = cs.RING_CHUNK, 16, 8, 128
    q, k, v = make_qkv(21, 1, hq, 2 * c, d, Hkv=hkv, dtype=torch.bfloat16, device="cuda")
    do = make_qkv(22, 1, hq, 2 * c, d, dtype=torch.bfloat16, device="cuda")[0]
    o, lse = rk.run_virtual_ring(q, k, v, ranks=2, causal=True)
    q2 = rk._prescale(q, d ** -0.5)
    rows = lambda x, r: x.narrow(2, r * c, c)  # noqa: E731
    lse1 = rows(lse, 1).contiguous()
    delta1 = rows((do.float() * o.float()).sum(-1), 1).contiguous()
    f32 = dict(dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    steps = {"off-diagonal": 0, "diagonal": 1}  # the K/V chunk rank 1 holds

    def bwd_args(src):
        grads = [torch.zeros((1, h, c, d), **f32) for h in (hq, hkv, hkv)]
        return ((rows(q2, 1), rows(k, src), rows(v, src), rows(do, 1), lse1, delta1, *grads),
                dict(q_base=c, kv_off=src * c, causal=True, window=None))

    for label, src in steps.items():
        args, pos = bwd_args(src)
        rk.ring_bwd_step_reference(*args, **pos)
        want = args[-3:]
        for name, lib in libs.items():
            if name.startswith("K8"):
                got, pos = bwd_args(src)
                rc = rk._launch_bwd(lib, *got, stream=stream, **pos)
                torch.cuda.synchronize()
                errs = [((a - b).abs().max().item(), ((a - b).norm() / b.norm()).item())
                        for a, b in zip(got[-3:], want)]
                print(f"[check] {name} {label}: rc {rc}, dQ / dK / dV max abs err "
                      + " / ".join(f"{e:.3e}" for e, _ in errs) + ", relative L2 "
                      + " / ".join(f"{r:.3e}" for _, r in errs), flush=True)

    acc, m, l = (torch.zeros((1, hq, c, d), **f32), torch.zeros((1, hq, c), **f32),
                 torch.ones((1, hq, c), **f32))
    o1, lse_c = torch.empty_like(rows(q2, 1)), torch.empty((1, hq, c), **f32)
    times = {}
    for rnd in range(3):
        for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
            for label, src in steps.items():
                if name.startswith("K8"):
                    args, pos = bwd_args(src)
                    fn = lambda: rk._launch_bwd(lib, *args, stream=stream, **pos)  # noqa: E731
                else:
                    pos = dict(q_base=c, kv_off=src * c, causal=True, window=None,
                               first=src == 1, last=False)
                    fn = lambda: rk._launch_fwd(  # noqa: E731
                        lib, rows(q2, 1), rows(k, src), rows(v, src), acc, m, l, o1, lse_c,
                        stream=stream, **pos)
                times.setdefault((name, label), []).append(cs.cuda_ms(fn, reps=10, trials=3))
    _report(times)


def _report(times: dict) -> None:
    for (name, label), ts in times.items():
        print(f"[time] {name} {label}: {' / '.join(f'{x:.4f}' for x in ts)} ms, median "
              f"{statistics.median(ts):.4f}", flush=True)


def bias(libs: dict) -> None:
    from flashattn_tpu_torch.ops import flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    B, N, H, D = len(cs.ATTN_LENGTHS), cs.ATTN_SEQ, 16, 128
    q, k, v = cs._grown(31, B, H, N, D, N, H)
    do = cs._bnhd(make_qkv(32, B, H, N, D, dtype=torch.bfloat16, device="cuda")[0])
    pad = cs._padding_bias(cs.ATTN_LENGTHS, N)
    gen = torch.Generator(device="cuda").manual_seed(33)
    arms = {"mask": (pad, False),
            "learned": (pad + torch.randn((1, H, N, N), generator=gen, device="cuda"), True)}
    f32 = [x.float() for x in (q, k, v, do)]
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, arm):
        bias_, want_dbias = arms[arm]
        lse, delta = stats[arm]
        dq = torch.zeros((B, H, N, D), dtype=torch.float32, device="cuda")
        dk, dv = (torch.empty((B, H, N, D), dtype=torch.float32, device="cuda") for _ in "kv")
        dbias = torch.empty((B, H, N, N), dtype=torch.float32, device="cuda") if want_dbias else None
        b, strides = flash_fwd.sm90_bias(bias_)
        rc = flash_bwd._launch_bias_bwd(lib, q, k, v, do, lse, delta, b, strides, dq, dk, dv,
                                        dbias, scale=D ** -0.5, causal=False, kv_valid_len=N,
                                        nq_pad=N, softcap=None, stream=stream)
        return rc, (dq, dk, dv, dbias)

    stats = {}
    for arm, (bias_, want_dbias) in arms.items():
        o, lse = flash_fwd.fwd_reference(*f32[:3], scale=D ** -0.5, bias=bias_)
        stats[arm] = (lse, (f32[3] * o).sum(-1))
        want = flash_bwd.bias_bwd_reference(*f32, *stats[arm], scale=D ** -0.5, bias=bias_,
                                            want_dbias=want_dbias)
        for name, lib in libs.items():
            rc, got = call(lib, arm)
            torch.cuda.synchronize()
            errs = [((a - w).abs().max().item(), cs._rel(a, w))
                    for a, w in zip(got, want) if w is not None]
            print(f"[check] {name} {arm} arm: rc {rc}, dQ / dK / dV"
                  f"{' / dbias' if want_dbias else ''} max abs err "
                  + " / ".join(f"{e:.3e}" for e, _ in errs) + ", relative L2 "
                  + " / ".join(f"{r:.3e}" for _, r in errs), flush=True)
        del want
        torch.cuda.empty_cache()
    times = {}
    for rnd in range(3):
        for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
            for arm in arms:
                times.setdefault((name, arm), []).append(
                    cs.cuda_ms(lambda: call(lib, arm), reps=10, trials=3))
    _report(times)


def k3(libs: dict) -> None:
    from flashattn_tpu_torch.ops import flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    stream = torch.cuda.current_stream().cuda_stream
    shapes = {"LM": (cs.LM_SEQ, dict(causal=True, window=None)),
              "SWA": (cs.SWA_SEQ, dict(causal=True, window=(cs.SWA_WINDOW - 1, -1)))}
    B, Hq, Hkv, D = 1, 16, 8, 128
    calls = {}
    for shape, (n, band) in shapes.items():
        q, k, v = (cs._bnhd(x) for x in make_qkv(41, B, Hq, n, D, Hkv=Hkv, dtype=torch.bfloat16,
                                                  device="cuda"))
        do = cs._bnhd(make_qkv(42, B, Hq, n, D, dtype=torch.bfloat16, device="cuda")[0])
        kw = dict(scale=D ** -0.5, **band)
        o, lse = flash_fwd.fwd(q, k, v, **kw)
        delta = (do.float() * o.float()).sum(-1)
        nq_pad = -(-n // flash_bwd.SM90_BWD_Q_TILE) * flash_bwd.SM90_BWD_Q_TILE
        stats = flash_bwd._padded_rows(lse, nq_pad), flash_bwd._padded_rows(delta, nq_pad)
        want = flash_bwd_fused.bwd_reference(*(x.float() for x in (q, k, v, do)), lse, delta,
                                             **kw)
        want = (want[0], *(w.view(B, Hkv, Hq // Hkv, n, D).sum(2) for w in want[1:]))
        for name, lib in libs.items():
            owners = Hkv if name == "K3 per KV head" else Hq

            def call(lib=lib, owners=owners, q=q, k=k, v=v, do=do, stats=stats, kw=kw, n=n,
                     nq_pad=nq_pad):
                dq = torch.zeros((B, Hq, n, D), dtype=torch.float32, device="cuda")
                dk, dv = (torch.empty((B, owners, n, D), dtype=torch.float32, device="cuda")
                          for _ in "kv")
                rc = flash_bwd_fused._launch(lib, q, k, v, do, *stats, dq, dk, dv,
                                             kv_valid_len=n, nq_pad=nq_pad, stream=stream, **kw)
                if owners == Hq:  # the caller's sum over each KV head's group
                    dk, dv = (x.view(B, Hkv, Hq // Hkv, n, D).sum(2) for x in (dk, dv))
                return rc, (dq, dk, dv)

            rc, got = call()
            torch.cuda.synchronize()
            errs = [((a - w).abs().max().item(), cs._rel(a, w)) for a, w in zip(got, want)]
            print(f"[check] {name} {shape}: rc {rc}, dQ / dK / dV max abs err "
                  + " / ".join(f"{e:.3e}" for e, _ in errs) + ", relative L2 "
                  + " / ".join(f"{r:.3e}" for _, r in errs), flush=True)
            calls[(name, shape)] = call
        del want
        torch.cuda.empty_cache()
    times = {}
    for rnd in range(3):
        for key, call in (calls.items() if rnd % 2 == 0 else reversed(calls.items())):
            times.setdefault(key, []).append(cs.cuda_ms(call, reps=10, trials=3))
    _report(times)


def k1cap(libs: dict) -> None:
    from flashattn_tpu_torch.ops import flash_fwd
    from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE

    B, Hq, Hkv, N, D = 1, 16, 8, cs.SWA_SEQ, 128
    q, k, v = cs._grown(51, B, Hq, N, D, N, Hkv)
    kw = dict(scale=D ** -0.5, causal=True, window=(cs.SWA_WINDOW - 1, -1), softcap=cs.SOFTCAP)
    o_want, lse_want = flash_fwd.fwd_reference(q, k, v, **kw)
    live = lse_want > math.log(2.0) * DEFAULT_MASK_VALUE * 0.5
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, N), dtype=torch.float32, device="cuda")

    def call(lib):
        return flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, None, kv_valid_len=N,
                                            stream=stream, **kw)

    for name, lib in libs.items():
        rc = call(lib)
        torch.cuda.synchronize()
        print(f"[check] {name}: rc {rc}, O max abs err "
              f"{(o.float() - o_want).abs().max().item():.3e}, relative L2 "
              f"{cs._rel(o.float(), o_want):.3e}, LSE max abs err "
              f"{(lse[live] - lse_want[live]).abs().max().item():.3e}", flush=True)
    del o_want, lse_want
    torch.cuda.empty_cache()
    times = {}
    for rnd in range(3):
        for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
            times.setdefault((name, "SWA"), []).append(
                cs.cuda_ms(lambda: call(lib), reps=10, trials=3))
    _report(times)


def k1wide(libs: dict) -> None:
    from flashattn_tpu_torch.ops import flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    def inputs(B, Hq, Hkv, N, D):
        q, k, v = (cs._bnhd(x) for x in make_qkv(71, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16,
                                                  device="cuda"))
        return q, k, v, torch.empty_like(q), torch.empty((B, Hq, N), dtype=torch.float32,
                                                          device="cuda")

    B, Hq, Hkv, N, D = cs.WIDE_SHAPE
    q, k, v, o, lse = inputs(B, Hq, Hkv, N, D)
    kw = dict(scale=D ** -0.5, causal=True, window=None, softcap=None)
    o_want, lse_want = flash_fwd.fwd_reference(q.float(), k.float(), v.float(), scale=D ** -0.5,
                                               causal=True)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        return flash_fwd._launch_dense_sm90(lib, q, k, v, o, lse, None, kv_valid_len=q.shape[2],
                                            stream=stream, **kw)

    for name, lib in libs.items():
        o.zero_()
        rc = call(lib)
        torch.cuda.synchronize()
        print(f"[check] {name}: rc {rc}, O max abs err "
              f"{(o.float() - o_want).abs().max().item():.3e}, relative L2 "
              f"{cs._rel(o.float(), o_want):.3e}, LSE max abs err "
              f"{(lse - lse_want).abs().max().item():.3e}", flush=True)
    del o_want, lse_want
    torch.cuda.empty_cache()
    times = {}
    for label, causal in (("LM D256", True), ("non-causal D256", False), ("LM D128", True)):
        kw["causal"] = causal
        if label == "LM D128":
            q, k, v, o, lse = inputs(1, 16, 8, N, 128)
            kw["scale"] = 128 ** -0.5
        for rnd in range(10):
            for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
                times.setdefault((name, label), []).append(
                    cs.cuda_ms(lambda: call(lib), reps=20, trials=3))
    _report(times)
    for (name, label), ts in times.items():
        if name != "K1 D256":
            base = times[("K1 D256", label)]
            wins = sum(t < b for t, b in zip(ts, base))
            print(f"[pairs] {name} {label}: faster than the committed form in {wins} of "
                  f"{len(ts)} rounds", flush=True)


def f32(libs: dict) -> None:
    from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_bwd_fused, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    cs._f32_tf32_off()
    B, Hq, Hkv, N, D = 1, 16, 8, cs.LM_SEQ, 128
    q, k, v = (cs._bnhd(x) for x in make_qkv(61, B, Hq, N, D, Hkv=Hkv, device="cuda"))
    do = cs._bnhd(make_qkv(62, B, Hq, N, D, device="cuda")[0])
    kw = dict(scale=D ** -0.5, causal=True)
    o, lse = flash_fwd.fwd(q, k, v, **kw)
    delta = (do * o).sum(-1)
    want = flash_bwd_fused.bwd_reference(q, k, v, do, lse, delta, **kw)
    nq_pad = -(-N // flash_bwd.F32_BWD_Q_TILE) * flash_bwd.F32_BWD_Q_TILE
    stats = flash_bwd._padded_rows(lse, nq_pad), flash_bwd._padded_rows(delta, nq_pad)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        dq = torch.zeros((B, Hq, N, D), dtype=torch.float32, device="cuda")
        dk, dv = (torch.empty((B, Hq, N, D), dtype=torch.float32, device="cuda") for _ in "kv")
        pieces = f32_split.scratch(2 * B * Hq * N, B * Hkv * N, D, q.device)
        rc = flash_bwd._launch_split(lib, q, k, v, do, *stats, dq, dk, dv, None, kv_valid_len=N,
                                     window=None, softcap=None, nq_pad=nq_pad, stream=stream,
                                     pieces=pieces, **kw)
        return rc, (dq, dk, dv)

    for name, lib in libs.items():
        rc, got = call(lib)
        torch.cuda.synchronize()
        print(f"[check] {name} LM: rc {rc}, dQ / dK / dV max abs err "
              + " / ".join(f"{(a - w).abs().max().item():.3e}" for a, w in zip(got, want)),
              flush=True)
    del want
    torch.cuda.empty_cache()
    times = {}
    for rnd in range(3):
        for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
            times.setdefault((name, "LM"), []).append(
                cs.cuda_ms(lambda: call(lib), reps=10, trials=3))
    _report(times)


def f32bias(libs: dict) -> None:
    from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    cs._f32_tf32_off()
    B, H, N, D = len(cs.ATTN_LENGTHS), cs.ATTN_WIDTH["num_heads"], cs.ATTN_SEQ, 128
    q, k, v = make_qkv(63, B, H, N, D, device="cuda")
    do = make_qkv(64, B, H, N, D, device="cuda")[0]
    mask = cs._padding_bias(cs.ATTN_LENGTHS, N)
    gen = torch.Generator(device="cuda").manual_seed(65)
    learned = mask + torch.randn((1, H, N, N), generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    nq_pad = -(-N // flash_bwd.F32_BWD_Q_TILE) * flash_bwd.F32_BWD_Q_TILE
    times = {}
    for arm, bias, want_dbias in (("mask", mask, False), ("learned", learned, True)):
        kw = dict(scale=D ** -0.5)
        o, lse = flash_fwd.fwd(q, k, v, bias=bias, **kw)
        delta = (do * o).sum(-1)
        want = flash_bwd.bias_bwd_reference(q, k, v, do, lse, delta, bias=bias,
                                            want_dbias=want_dbias, **kw)
        stats = flash_bwd._padded_rows(lse, nq_pad), flash_bwd._padded_rows(delta, nq_pad)
        kbias, strides = flash_fwd.kernel_bias(bias)

        def call(lib):
            dq = torch.zeros((B, H, N, D), dtype=torch.float32, device="cuda")
            dk, dv = (torch.empty((B, H, N, D), dtype=torch.float32, device="cuda")
                      for _ in "kv")
            dbias = (torch.empty((B, H, N, N), dtype=torch.float32, device="cuda")
                     if want_dbias else None)
            pieces = f32_split.scratch(2 * B * H * N, B * H * N, D, q.device)
            rc = flash_bwd._launch_split(lib, q, k, v, do, *stats, dq, dk, dv, None, causal=False,
                                         kv_valid_len=N, window=None, softcap=None,
                                         nq_pad=nq_pad, stream=stream, pieces=pieces,
                                         bias=kbias, dbias=dbias, bias_strides=strides, **kw)
            return rc, (dq, dk, dv) + ((dbias,) if want_dbias else ())

        for name, lib in libs.items():
            rc, got = call(lib)
            torch.cuda.synchronize()
            print(f"[check] {name} {arm}: rc {rc}, dQ / dK / dV{' / dbias' if want_dbias else ''}"
                  " max abs err " + " / ".join(f"{(a - w).abs().max().item():.3e}"
                                               for a, w in zip(got, want)), flush=True)
            del got
        del want
        torch.cuda.empty_cache()
        for rnd in range(3):
            for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
                times.setdefault((name, arm), []).append(
                    cs.cuda_ms(lambda: call(lib), reps=5, trials=3))
    _report(times)


def main() -> None:
    families = sys.argv[1:] or ["ring", "bias", "k3", "k1cap", "k1wide", "f32", "f32bias"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build(families)
    for family, run in (("ring", ring), ("bias", bias), ("k3", k3), ("k1cap", k1cap),
                        ("k1wide", k1wide), ("f32", f32), ("f32bias", f32bias)):
        if family in families:
            run({n: lib for n, lib in libs.items() if _family(n) == family})


if __name__ == "__main__":
    main()
