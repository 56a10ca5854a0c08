"""Time the design variants of the TMA + wgmma kernels against the committed ones, on one GPU.

    python3 chip_variants.py [ring] [bias] [k3] [k1cap] [k1wide] [f32] [f32bias] [k1quant]

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

Family ``k1wide``, K1's dense body at D 256 (``csrc/fwd_sm90_tile.cuh``,
built with ``csrc/flash_fwd_sm90.cu`` and ``csrc/ring_fwd.cu``) through
``flash_fwd._launch_dense_sm90`` and ``ring_kernel._launch_fwd``, each
choice of its design (``FbSmem``'s OVERLAP, PINGPONG and BN) undone or
taken in turn:

* ``K1 D256``: as committed (the next tile's S and the previous tile's P V
  on the tensor cores under the softmax, K and V on barriers of their own,
  the two consumer warpgroups issuing their products in turn, 80-key tiles,
  the ring's state prefetched into L2 four tiles before the end);
* ``K1 D256 no ping-pong``: the warpgroups issue independently;
* ``K1 D256 serial 64 keys``: the earlier loop (issue S, wait, softmax,
  issue P V, wait; K and V of a stage on one barrier; 64-key tiles; no
  ping-pong);
* ``K1 D256 serial 80 keys``: that loop on 80-key tiles;
* ``K1 D256 ping-pong serial``: the serial loop on 80-key tiles with the
  warpgroups taking turns to issue S and P V;
* ``K1 D256 64 keys``: the committed loop on 64-key tiles;
* ``K1 D256 no state prefetch``: K7's merge reads its state from device
  memory after the last tile;
* ``K1 D128 overlap``: the overlapped loop also in the dense D 128 form
  (64-key tiles, 4 stages, no ping-pong), which keeps the serial loop as
  committed;
* ``K1 D256 merge unbatched``: K7's merge reading each column pair of its
  state just before writing it back (``ring_merge.cuh``'s
  RING_MERGE_AHEAD 1, not 8).

Each is held against ``fwd_reference`` at the D 256 LM's attention (B1 Hq8
Hkv4 N2048 D256 causal; O's max abs and relative L2 errors, LSE's max abs
error, printed) and, as K7, against ``ring_fwd_step_reference`` on the
ring's off-diagonal chunk pair (B1 Hq8 Hkv4 D256, rank 1's 4096 rows against
rank 0's K/V) merged into a state that the plain step made from the diagonal
pair (the state's errors printed). Then each is timed in turns over 10
rounds: at the D 256 LM's attention, non-causal (every KV tile visited), on
the ring's off-diagonal pair as a middle step (the state read, merged and
written) and as a rank's first live step (the state written without a read:
the difference is what the merge's read costs), and at the D 128 LM's
attention (B1 Hq16 Hkv8 N2048 D128 causal); each round's pairs against the
committed form are counted.

Family ``f32``, the f32 backward ``csrc/flash_bwd_f32.cu`` (built with the
split ``csrc/split_bf16x3.cu``, which its C entry launches first) through
``flash_bwd._launch_split``:

* ``bwd f32``: as committed (two consumer warpgroups taking the visits in
  turn; the six-product chains of wgmma m64n32k16 unrolled by template
  recursion, each wgmma forming its descriptors inside its own asm
  statement from the chain's two base descriptors; setmaxnreg 24 / 240);
* ``bwd f32 chain loops``: each chain a loop over the six products that is
  not unrolled, the descriptors formed in C++ (the earlier body's form:
  ptxas serializes its wgmma, C7520);
* ``bwd f32 descriptors in C++``: that loop unrolled (ptxas 12.9 crashed on
  it in the earlier body; it builds in this one);
* ``bwd f32 40 / 232 registers``: the producer given 40 registers and the
  consumers 232.

A variant in ``BUILD_FAILS`` (none since PR 27) is one ptxas is known to
refuse: its failed build is reported and left out.

At the f32 LM's shape (B1 Hq16 Hkv8 N2048 D128 causal, f32, TF32 off) each
is held against ``bwd_reference``, then timed in turns, the split of q, k,
v and dO included. Each build prints its instantiations' registers, spills
and ptxas's wgmma serialization notes.

Family ``f32bias``, the f32 backward's BIAS family (the same source):

* ``bwd f32 bias``: as committed (the stage released once dK retires; at D
  256 rank 0 alone reads the bias and folds it into its partial S^T);
* ``bwd f32 bias stage released at the end``: the stage released once dQ is
  staged, so the producer loads the consumer's next tile only after its
  dQ^T: what the early release saves, i.e. how long the producer would wait;
* ``bwd f32 bias chain loops``, ``bwd f32 bias descriptors in C++``: as
  ``bwd f32 chain loops`` and ``bwd f32 descriptors in C++``;
* ``bwd f32 bias read by both ranks``: at D 256 each rank reads the bias
  and adds it in P^T's exponent (the earlier body's way).

At f32 path A's attention (B4 H16 N2048 D128 and B4 H8 N2048 D256, f32,
TF32 off) with the mask arm's bias ([4, 1, N, N], no dbias) and the learned
arm's ([4, H, N, N], dbias) each is held against ``bias_bwd_reference``, then
timed in turns over 3 rounds, the split included.

Family ``k1quant``, K1's quantized route ``csrc/flash_fwd_quant_sm90.cu`` (its
body ``csrc/fwd_sm90_tile.cuh``) through ``flash_fwd._launch_quant_sm90``:

* ``K1 quant``: as committed (int8 widened through f32: the byte in 2^23's
  mantissa, one f32 subtraction, the upper half kept; e4m3 by
  ``cvt.rn.f16x2.e4m3x2``, each half to f32, the upper halves kept; 3 bf16
  stages and 8 8-bit slots at D 128; 72 producer and 216 consumer
  registers);
* ``K1 quant int8 in bf16x2``: int8 widened in bf16x2 arithmetic, 128 +
  the low 7 bits minus 128 or 256: 8 operations for 4 values where the
  committed form takes 11, one of them a bf16x2 FMA a pair;
* ``K1 quant fp8 by integer ops``: e4m3 widened by integer operations (sign
  to bit 15, exponent and mantissa four bits down) and a bf16x2 multiply by
  2^120;
* ``K1 quant 4 stages``: 4 bf16 stages and 6 8-bit slots at D 128;
* ``K1 quant no conversion``, ``K1 quant no widening`` (their numbers are
  wrong, the check prints how wrong): the bytes stored as they are, without
  the conversion's arithmetic, or no widening at all (the bf16 stages keep
  what they held): what the conversion, and all of the producer's widening,
  cost.

At the quantized prefill (B1 Hq16 Hkv8 N2048 D128 causal, int8 and fp8
K/V), at SWA's window (N8192, window 2047 to the left, causal, int8) and at
heads of 256 (B1 Hq8 Hkv4 N2048 D256 causal, int8) each is held against
``fwd_reference`` on the same 8-bit K/V and scales, then timed in turns
over 5 rounds. Prints the card's name and power limit first.
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


# The dense D 256 body's design switches (FbSmem in fwd_sm90_tile.cuh), as
# committed: the overlapped loop, ping-pong, 80-key tiles.
_DESIGN = {"overlap": "  static constexpr bool OVERLAP = D == 256 && !BIAS;\n",
           "pingpong": "  static constexpr bool PINGPONG = D == 256 && !BIAS;\n",
           "bn": "  static constexpr int BN = D == 256 && !BIAS ? 80 : 64;\n"}


def _design(overlap: str | None = None, pingpong: str | None = None, bn: str | None = None):
    """A patch of FbSmem's switches: each given one's expression replaced."""
    def patch(src: str) -> str:
        for key, expr in (("overlap", overlap), ("pingpong", pingpong), ("bn", bn)):
            if expr is None:
                continue
            old = _DESIGN[key]
            assert src.count(old) == 1, f"the {key} patch no longer applies"
            src = src.replace(old, old[:old.index("= ") + 2] + expr + ";\n")
        return src
    return patch


# The f32 backward's chains in other forms (wgmma_n32_at and chain_ss6
# replaced): each wgmma's descriptors formed in C++ from the chain's two base
# descriptors, the chain unrolled, or a loop over the six products that is
# not unrolled (the earlier body's form, which ptxas serializes, C7520).
_CHAIN_CXX = """template <int TA, int KS, int A_PIECE, int A_BOX, int A_COL, int B_BOX>
__device__ __forceinline__ void chain_ss6(float (&acc)[16], uint64_t a0, uint64_t b0) {
#pragma unroll UNROLL
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss_m64n32k16<TA>(
          acc, a0 + ((pair_a(x) * A_PIECE + (kk / 4) * A_BOX + (kk % 4) * A_COL) >> 4),
          b0 + ((pair_b(x) * F32B_BLOCK_M * SW128_ROW + (kk / 4) * B_BOX + (kk % 4) * 32) >> 4),
          x > 0 || kk > 0);
    }
  }
}
"""


def _chain_cxx(unroll: str):
    def patch(src: str) -> str:
        a = src.index("// One wgmma m64n32k16 from shared memory, D (64 x 32, f32)")
        b = src.index("\n}\n", src.index("void chain_ss6(", a)) + 3
        return src[:a] + _CHAIN_CXX.replace("UNROLL", unroll) + src[b:]
    return patch


def _release_at_end(src: str) -> str:
    """The (Q, dO) stage released at the end of the visit, once dQ has been
    staged, as the earlier body released it, instead of once dK retires."""
    old = "      if (lane == 0) mbar_arrive(&empty[c]);  // bwd f32 stage release\n"
    anchor = "      named_sync(bar, 128);  // the whole dQ tile is staged\n"
    assert src.count(old) == 1 and src.count(anchor) == 1, "the release patch no longer applies"
    return src.replace(old, "").replace(anchor, anchor + "      __syncwarp();\n" + old)


# The quantized route's widening in other arithmetic: int8 in bf16x2, e4m3
# by the hardware conversion to f16x2.
_INT8_BF16X2 = '''__device__ __forceinline__ uint32_t widen2_int8(uint32_t w2) {
  const uint32_t a = (w2 & 0x007F007Fu) | 0x43004300u;
  const uint32_t c = (w2 & 0x00800080u) ^ 0xC300C300u;
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(y) : "r"(a), "r"(0x3F803F80u), "r"(c));
  return y;
}

__device__ __forceinline__ uint2 widen4_int8(uint32_t w) {
  return make_uint2(widen2_int8(__byte_perm(w, 0, 0x4140)),
                    widen2_int8(__byte_perm(w, 0, 0x4342)));
}
'''
_FP8_BY_INT = '''__device__ __forceinline__ uint32_t widen2_fp8(uint32_t t) {
  const uint32_t h = (t & 0x80008000u) | ((t >> 4) & 0x07F007F0u);
  uint32_t y;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(y) : "r"(h), "r"(0x7B807B80u), "r"(0x80008000u));
  return y;
}

__device__ __forceinline__ uint2 widen4_fp8(uint32_t w) {
  return make_uint2(widen2_fp8(__byte_perm(w, 0, 0x1404)), widen2_fp8(__byte_perm(w, 0, 0x3424)));
}
'''


def _replace_fn(src: str, head: str, new: str) -> str:
    start = src.index(head)
    end = src.index("\n}\n", start) + 3
    return src[:start] + new + src[end:]


def _int8_bf16x2(src: str) -> str:
    return _replace_fn(src, "__device__ __forceinline__ uint2 widen4_int8(uint32_t w) {",
                       _INT8_BF16X2)


def _fp8_by_int(src: str) -> str:
    return _replace_fn(src, "__device__ __forceinline__ uint2 widen4_fp8(uint32_t w) {",
                       _FP8_BY_INT)


def _no_conversion(src: str) -> str:
    old = "  if constexpr (KV == KV_INT8) return widen4_int8(w);\n  return widen4_fp8(w);"
    assert src.count(old) == 1, "the no-conversion patch no longer applies"
    return src.replace(old, "  return make_uint2(__byte_perm(w, 0, 0x4140), __byte_perm(w, 0, 0x4342));")


QUANT_BODY = "fwd_sm90_tile.cuh"
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
    "K1 D256 no ping-pong": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _design(
        pingpong="false")),)),
    "K1 D256 serial 64 keys": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _design(
        overlap="false", pingpong="false", bn="64")),)),
    "K1 D256 serial 80 keys": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _design(
        overlap="false", pingpong="false")),)),
    "K1 D256 ping-pong serial": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _design(
        overlap="false")),)),
    "K1 D256 64 keys": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _design(bn="64")),)),
    "K1 D256 no state prefetch": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", lambda s: s.replace(
        "constexpr int RING_PREFETCH_TILES = 4;", "constexpr int RING_PREFETCH_TILES = 0;")),)),
    "K1 D128 overlap": ("flash_fwd_sm90.cu", (("fwd_sm90_tile.cuh", _design(
        overlap="D >= 128 && !BIAS")),)),
    "K1 D256 merge unbatched": ("flash_fwd_sm90.cu", (("ring_merge.cuh", lambda s: s.replace(
        "constexpr int RING_MERGE_AHEAD = 8;", "constexpr int RING_MERGE_AHEAD = 1;")),)),
    "bwd f32": ("flash_bwd_f32.cu", ()),
    "bwd f32 chain loops": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _chain_cxx("1")),)),
    "bwd f32 descriptors in C++": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _chain_cxx("")),)),
    "bwd f32 40 / 232 registers": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", lambda s: s.replace(
        "setmaxnreg.dec.sync.aligned.u32 24;", "setmaxnreg.dec.sync.aligned.u32 40;").replace(
        "setmaxnreg.inc.sync.aligned.u32 240;", "setmaxnreg.inc.sync.aligned.u32 232;")),)),
    "K1 quant": ("flash_fwd_quant_sm90.cu", ()),
    "K1 quant int8 in bf16x2": ("flash_fwd_quant_sm90.cu", ((QUANT_BODY, _int8_bf16x2),)),
    "K1 quant fp8 by integer ops": ("flash_fwd_quant_sm90.cu", ((QUANT_BODY, _fp8_by_int),)),
    "K1 quant 4 stages": ("flash_fwd_quant_sm90.cu", ((QUANT_BODY, lambda s: s.replace(
        "(D == 256 ? 2 : D == 128 ? 3 : 4);\n"
        "  static constexpr int SLOTS8 = D == 256 ? 2 : F32Q && D == 128 ? 6 : 8;",
        "(D == 256 ? 2 : 4);\n"
        "  static constexpr int SLOTS8 = D == 256 ? 2 : D == 128 ? 6 : 8;")),)),
    "K1 quant no conversion": ("flash_fwd_quant_sm90.cu", ((QUANT_BODY, _no_conversion),)),
    "K1 quant no widening": ("flash_fwd_quant_sm90.cu", ((QUANT_BODY, lambda s: s.replace(
        "        widen_tile<D, KV>(st + x * S::KV, smem + S::OFF8 + slot * S::KV8, tid);\n",
        "")),)),
    "bwd f32 bias": ("flash_bwd_f32.cu", ()),
    "bwd f32 bias stage released at the end": ("flash_bwd_f32.cu",
                                               (("flash_bwd_f32.cu", _release_at_end),)),
    "bwd f32 bias chain loops": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", _chain_cxx("1")),)),
    "bwd f32 bias descriptors in C++": ("flash_bwd_f32.cu",
                                        (("flash_bwd_f32.cu", _chain_cxx("")),)),
    "bwd f32 bias read by both ranks": ("flash_bwd_f32.cu", (("flash_bwd_f32.cu", lambda s: s.replace(
        "constexpr bool FOLD = WIDE && BIAS && !CAP;", "constexpr bool FOLD = false;")),)),
}
# Variants known not to build, kept as witnesses: a failed build of one of
# these is reported and left out; any other variant that fails stops the run.
# None since PR 27: ptxas 12.9 exited 139 on the earlier f32 backward body
# whenever its chains were unrolled (PERF.md PR 17); the same unrolled
# chains build in the body that replaced it ("bwd f32 descriptors in C++").
BUILD_FAILS: set = set()
# The C entry, its argument types and the family of each source.
ENTRIES = {"ring_bwd.cu": ("fa_ring_bwd_bf16", "RING_BWD_ARGTYPES", "ring"),
           "ring_fwd.cu": ("fa_ring_fwd_bf16", "RING_FWD_ARGTYPES", "ring"),
           "bwd_bias_sm90.cu": ("fa_bwd_bias_sm90", "BWD_BIAS_SM90_ARGTYPES", "bias"),
           "flash_bwd_sm90.cu": ("fa_bwd_sm90", "BWD_SM90_ARGTYPES", "k3"),
           "flash_fwd_sm90.cu": ("fa_fwd_sm90", "FWD_SM90_ARGTYPES", "k1cap"),
           "flash_bwd_f32.cu": ("fa_bwd_f32", "BWD_F32_ARGTYPES", "f32"),
           "flash_fwd_quant_sm90.cu": ("fa_fwd_quant_sm90", "FWD_QUANT_SM90_ARGTYPES", "k1quant")}
# Variants whose family is not their source's.
FAMILY = {**{name: "k1wide" for name in ("K1 D256", "K1 D256 no ping-pong",
                                         "K1 D256 serial 64 keys", "K1 D256 serial 80 keys",
                                         "K1 D256 ping-pong serial", "K1 D256 64 keys",
                                         "K1 D256 no state prefetch", "K1 D128 overlap",
                                         "K1 D256 merge unbatched")},
          "bwd f32 bias": "f32bias",
          "bwd f32 bias stage released at the end": "f32bias",
          "bwd f32 bias chain loops": "f32bias", "bwd f32 bias descriptors in C++": "f32bias",
          "bwd f32 bias read by both ranks": "f32bias"}


def _family(name: str) -> str:
    return FAMILY.get(name, ENTRIES[VARIANTS[name][0]][2])


# Sources a variant's library is linked with beside its own (K1's dense body
# at D 256 is also K7's D 256 form).
EXTRA_SOURCES = {"flash_bwd_f32.cu": ("split_bf16x3.cu",), "flash_fwd_sm90.cu": ("ring_fwd.cu",)}


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
        notes = cs.serialization_notes(err + out)
        print(f"[build] {name}: wgmma serialized in {len(notes)} instantiations"
              + "".join(f"; {n}: {found[0][0]} {found[0][1]}" for n, found in
                        sorted(notes.items())[:3]), flush=True)
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
    from flashattn_tpu_torch.parallel import ring_kernel as rk
    from flashattn_tpu_torch.utils import native
    from flashattn_tpu_torch.utils.testing import make_qkv

    for lib in libs.values():
        lib.fa_ring_fwd_bf16.restype = ctypes.c_int
        lib.fa_ring_fwd_bf16.argtypes = native.RING_FWD_ARGTYPES

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

    # K7's D 256 form: rank 1's rows against rank 0's K/V (off-diagonal),
    # merged into the state the plain step made from rank 1's own (diagonal).
    c = cs.RING_CHUNK
    rq, rk_, rv = make_qkv(72, 1, Hq, 2 * c, D, Hkv=Hkv, dtype=torch.bfloat16, device="cuda")
    q2 = rk._prescale(rq, D ** -0.5)
    rows = lambda x, r: x.narrow(2, r * c, c)  # noqa: E731
    f32 = dict(dtype=torch.float32, device="cuda")
    state0 = (torch.zeros((1, Hq, c, D), **f32), torch.zeros((1, Hq, c), **f32),
              torch.zeros((1, Hq, c), **f32))
    o_c, lse_c = torch.empty_like(rows(q2, 1)), torch.empty((1, Hq, c), **f32)
    diag = dict(q_base=c, kv_off=c, causal=True, window=None)
    rk.ring_fwd_step_reference(rows(q2, 1), rows(rk_, 1), rows(rv, 1), *state0, o_c, lse_c,
                               first=True, **diag)
    off = dict(q_base=c, kv_off=0, causal=True, window=None)
    want = tuple(x.clone() for x in state0)
    rk.ring_fwd_step_reference(rows(q2, 1), rows(rk_, 0), rows(rv, 0), *want, o_c, lse_c, **off)

    def ring_call(lib, state, first):
        return rk._launch_fwd(lib, rows(q2, 1), rows(rk_, 0), rows(rv, 0), *state, o_c, lse_c,
                              stream=stream, first=first, last=False, **off)

    for name, lib in libs.items():
        o.zero_()
        rc = call(lib)
        got = tuple(x.clone() for x in state0)
        rc_ring = ring_call(lib, got, False)
        torch.cuda.synchronize()
        print(f"[check] {name}: rc {rc}, O max abs err "
              f"{(o.float() - o_want).abs().max().item():.3e}, relative L2 "
              f"{cs._rel(o.float(), o_want):.3e}, LSE max abs err "
              f"{(lse - lse_want).abs().max().item():.3e}; K7 middle step rc {rc_ring}, acc / m "
              f"/ l relative L2 " + " / ".join(f"{cs._rel(a, b):.3e}" for a, b in zip(got, want)),
              flush=True)
    del o_want, lse_want, want
    torch.cuda.empty_cache()
    state = tuple(x.clone() for x in state0)
    calls = {"LM D256": lambda lib: call(lib), "non-causal D256": lambda lib: call(lib),
             "ring off-diagonal middle step": lambda lib: ring_call(lib, state, False),
             "ring off-diagonal first step": lambda lib: ring_call(lib, state, True),
             "LM D128": lambda lib: call(lib)}
    times = {}
    for label, fn in calls.items():
        kw["causal"] = label != "non-causal D256"
        if label == "LM D128":
            q, k, v, o, lse = inputs(1, 16, 8, N, 128)
            kw["scale"] = 128 ** -0.5
        for rnd in range(10):
            for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
                times.setdefault((name, label), []).append(
                    cs.cuda_ms(lambda: fn(lib), reps=20, trials=3))
    _report(times)
    for (name, label), ts in times.items():
        if name != "K1 D256":
            base = times[("K1 D256", label)]
            wins = sum(t < b for t, b in zip(ts, base))
            print(f"[pairs] {name} {label}: faster than the committed form in {wins} of "
                  f"{len(ts)} rounds; median {statistics.median(ts) / statistics.median(base) - 1:+.2%}",
                  flush=True)
    pairs = Hq * c * c
    for name in libs:
        mid = statistics.median(times[(name, "ring off-diagonal middle step")])
        first = statistics.median(times[(name, "ring off-diagonal first step")])
        print(f"[ring] {name}: off-diagonal step {mid:.4f} ms ({4 * D * pairs / mid / 1e9:.1f} "
              f"TFLOP/s), as a first step {first:.4f} ms: the merge's read "
              f"{(mid - first) / mid:+.1%} of the step", flush=True)


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
    cs._f32_tf32_off()
    times = {}
    for H, D in ((cs.ATTN_WIDTH["num_heads"], 128), (cs.WIDE_ATTN_WIDTH["num_heads"], 256)):
        _f32bias_at(libs, times, H, D)
    _report(times)


def _f32bias_at(libs: dict, times: dict, H: int, D: int) -> None:
    from flashattn_tpu_torch.ops import f32_split, flash_bwd, flash_fwd
    from flashattn_tpu_torch.utils.testing import make_qkv

    B, N = len(cs.ATTN_LENGTHS), cs.ATTN_SEQ
    q, k, v = make_qkv(63, B, H, N, D, device="cuda")
    do = make_qkv(64, B, H, N, D, device="cuda")[0]
    mask = cs._padding_bias(cs.ATTN_LENGTHS, N)
    gen = torch.Generator(device="cuda").manual_seed(65)
    learned = mask + torch.randn((1, H, N, N), generator=gen, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    nq_pad = -(-N // flash_bwd.F32_BWD_Q_TILE) * flash_bwd.F32_BWD_Q_TILE
    for arm, bias, want_dbias in ((f"mask D{D}", mask, False), (f"learned D{D}", learned, True)):
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
    del q, k, v, do, mask, learned
    torch.cuda.empty_cache()


def k1quant(libs: dict) -> None:
    from flashattn_tpu_torch.ops import flash_fwd, quant
    from flashattn_tpu_torch.utils.testing import make_qkv

    stream = torch.cuda.current_stream().cuda_stream
    shapes = {"prefill int8": (1, 16, 8, cs.LM_SEQ, 128, torch.int8, None),
              "prefill fp8": (1, 16, 8, cs.LM_SEQ, 128, torch.float8_e4m3fn, None),
              "SWA int8": (1, 16, 8, cs.SWA_SEQ, 128, torch.int8, (cs.SWA_WINDOW - 1, -1)),
              "D256 int8": (1, 8, 4, cs.LM_SEQ, 256, torch.int8, None)}
    times = {}
    for label, (B, Hq, Hkv, N, D, dt, window) in shapes.items():
        q, k, v = make_qkv(81, B, Hq, N, D, Hkv=Hkv, dtype=torch.bfloat16, device="cuda")
        qkv = quant.quantize_kv(k, v, dt, allow_slow_fp8=True)
        kw = dict(scale=D ** -0.5, causal=True, window=window)
        o_want = flash_fwd.fwd_reference(q, qkv.k_q, qkv.v_q, k_scale=qkv.k_scale,
                                         v_scale=qkv.v_scale, **kw)[0].float()
        o = torch.empty_like(q)
        lse = torch.empty((B, Hq, N), dtype=torch.float32, device="cuda")

        def call(lib):
            return flash_fwd._launch_quant_sm90(lib, q, qkv.k_q, qkv.v_q, o, lse, qkv.k_scale,
                                                qkv.v_scale, None, (0, 0, 0), None,
                                                kv_valid_len=N, stream=stream, **kw)

        for name, lib in libs.items():
            o.zero_()
            rc = call(lib)
            torch.cuda.synchronize()
            print(f"[check] {name} {label}: rc {rc}, O max abs err "
                  f"{(o.float() - o_want).abs().max().item():.3e}, relative L2 "
                  f"{cs._rel(o.float(), o_want):.3e}", flush=True)
        del o_want
        for rnd in range(5):
            for name, lib in (libs.items() if rnd % 2 == 0 else reversed(libs.items())):
                times.setdefault((name, label), []).append(
                    cs.cuda_ms(lambda: call(lib), reps=20, trials=3))
        del q, k, v, qkv, o, lse
        torch.cuda.empty_cache()
    _report(times)


def main() -> None:
    families = sys.argv[1:] or ["ring", "bias", "k3", "k1cap", "k1wide", "f32", "f32bias",
                                "k1quant"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libs = build(families)
    for family, run in (("ring", ring), ("bias", bias), ("k3", k3), ("k1cap", k1cap),
                        ("k1wide", k1wide), ("f32", f32), ("f32bias", f32bias),
                        ("k1quant", k1quant)):
        if family in families:
            run({n: lib for n, lib in libs.items() if _family(n) == family})


if __name__ == "__main__":
    main()
