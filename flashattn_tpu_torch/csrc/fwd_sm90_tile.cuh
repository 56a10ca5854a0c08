// K1 for Hopper (sm_90a): one warp-specialised TMA + wgmma forward body
// with two instantiation families -- K1's bias route, which streams the f32
// bias tile through shared memory (flash_fwd_bias_sm90.cu), and K1's dense
// route (flash_fwd_sm90.cu) -- both with the causal / window band, q / kv
// offsets, segment ids and any tail; and, below them, the quantized route's
// body (flash_fwd_quant_sm90.cu: int8 / e4m3 K/V widened in shared memory by
// the producer warpgroup, the dense route's consumers and options; its design
// is in that source and above fwd_quant_sm90_body).
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) and, with causal or a window, the whole-sequence banded
// _fwd_causal_resident_kernel (K2, :516) and fwd_macro_padded (:957).
// The families compute K1's function (JAX's order of operations): scores
// x = s * scale * log2 e (with the logit softcap, CAP: x = cap * log2 e *
// tanh(s * scale / cap), the scale inside the tanh), + bias * log2 e floored
// at the finite mask value, then the masks (JAX's order,
// flashattn_tpu/ops/flash_fwd.py:310-320), the online softmax in the log2 domain with f32 (m, l,
// acc), O in bf16 and the LSE in natural log; a row whose largest score is
// at or below half the mask value is dead (O = 0, LSE = ln2 * mask, bit for
// bit the convention K3 / K5 / K6 read). GQA maps query head h to KV head
// h / rep; Q, K, V and O are strided views.
//
//   * Both routes take any D that is a multiple of 8 up to 256,
//     instantiated at 64, 128 and 256: D 40, 80, 96 or 136-248 read zeros
//     past D from the TMA boxes, and O's columns >= D are never written. Both
//     take the
//     softcap (CAP, a template flag): the accurate tanhf, which the
//     backward's recompute uses too -- a P that differs from the backward's
//     breaks sum(P) = 1 behind Delta.
//   * The bias route (ops/flash_fwd.py::bias_route): bf16 Q/K/V, an
//     additive f32 bias [B|1, H|1, Nq|1, Nk] read through (batch,
//     head, row) strides that are 0 on broadcast dims, columns only below
//     kv_valid_len and rows only below Nq; and every mask of the dense
//     route below -- the KV tail, the band (causal, a window, q / kv
//     offsets) and segment ids -- the bias added before them, as the JAX
//     kernel adds it (flashattn_tpu/ops/flash_fwd.py:291-320).
//   * The dense route (ops/flash_fwd.py::dense_route): bf16 Q/K/V without a
//     bias; the KV tail
//     below kv_valid_len and a ragged Q tail; the band of flash_fwd.py::
//     _range_predicates, also when Nq != Nk -- row i sees column j iff i -
//     lo <= j <= i + hi, hi 0 with causal, else the window's right bound, lo
//     the window's left one (NO_BOUND on an unbounded side), as K7 takes it
//     (ring_fwd.cu), both shifted by a chunk pair's q_offset - kv_offset
//     (common.cuh band_bounds): a shifted band may miss the diagonal, whole
//     rows or the whole CTA, whose rows are then dead (no KV tile visited:
//     m stays -inf, under the dead-row test); and
//     segment ids (seg_q [B, Nq], seg_kv [B, Nk]: pair (i, j) attends iff
//     the ids are equal), AND-composed with the other masks, a row that
//     matches no key being dead.
//
// What bounds it: at the LM's attention (B1 Hq16 Hkv8 N2048 D128 causal) the
// two products are 17.2 GFLOP, 0.017 ms at 989 TFLOP/s: operations. At path
// A's shape with its bias (B4 H16 N2048 D128, bias [4, 1, N, N]) 137 GFLOP,
// 0.139 ms; with a learned [4, 16, N, N] bias the kernel must read 1.07 GB
// of it: 0.32 ms at 3.35 TB/s, bytes. The mma.sync K1 that this body
// replaced ran them at ~100 and 56 TFLOP/s: 16 rows per warp, synchronous
// K / V loads between two block barriers, and (with a bias) one dependent
// scalar bias load per score. With the softcap at the SWA shape (B1 Hq16
// Hkv8 N8192 D128, window 2047, cap 50) the products are 0.12 ms of
// operations, and each score's tanhf puts two more MUFU operations (an
// exponential and a reciprocal) and ~15 FMA-pipe instructions beside the
// softmax's one ex2: the mma.sync K1 took 0.84 ms there. This design:
//
//   * One CTA owns 128 Q rows of one (batch, head): warpgroup 0 is the
//     producer (setmaxnreg gives its registers away), warpgroups 1 and 2 the
//     consumers, 64 rows each.
//   * S = Q K^T by wgmma m64n64k16 with Q and K from shared memory (K's
//     row-major [keys, D] tile is the K-major B operand); O += P V by wgmma
//     with A from registers: the f32 score accumulators, rounded to bf16, are
//     the A fragments (the wgmma accumulator layout is mma.sync's, row g and
//     g + 8 of each warp's 16), so P never touches shared memory; V is the
//     N-major B operand (transpose bit), as K9's B.
//   * A ring of KV tiles of 64 keys on full / empty mbarriers. Q, K and V
//     come by TMA (4-D maps over (D, seq, head, batch) with the 128-byte
//     swizzle; the sequence extents are Nq and kv_valid_len, so the tails
//     read zeros -- zeros give S = 0, not P = 0, so every tile that holds a
//     tail column is masked). Each consumer warp releases a stage once its
//     products on it have retired.
//   * The bias route: 3 stages at D 128 (224 KB of shared memory) and 4 at
//     D 64, each carrying (K, V, bias). The bias tile (128 rows x 64 columns
//     f32) comes by 16-byte cp.async from all 128 producer threads, 16
//     copies each with no branch -- a TMA map cannot take the zero row
//     stride of a [B, H, 1, Nk] bias; such a bias is copied as one row and
//     read by every row -- whose completion arrives on the same full barrier
//     (cp.async.mbarrier.arrive.noinc). The tile's rows are unpadded (the
//     third stage needs the room) and their 16-byte chunks are permuted,
//     chunk c of row r stored at c ^ 2 (r % 4): a thread reads rows g and
//     g + 8, columns 8j + 2t and + 1 (the accumulator's layout) as float2 by
//     ld.shared, and with the permutation the 16 lanes of each half-warp hit
//     32 distinct banks, while the copies (8 lanes, 8 consecutive chunks of
//     one row) stay conflict-free. Grid (head, Q tile, batch): the head
//     varies fastest, so the 16 CTAs that share a [B, 1, N, N] bias tile run
//     together and read it from HBM once. The band and the segment ids are
//     the dense route's (below): every producer thread walks the same tile
//     list -- the band's tiles from n_begin whose id range meets the Q
//     tile's, from the ranges every thread reads -- so the 128 arrivals of
//     each full barrier stay whole, and copies the bias from the tile's
//     absolute column; with SEG thread 0 adds the tile's 64 ids to the
//     stage's barrier. The 3 stages' ids (768 B) fit beside the D 128 ring
//     (229,376 B of Q and stages, ~1.2 KB below the 227 KB limit); a fourth
//     stage does not.
//   * The dense route: 4 stages of (K, V) (2 at D 256) and one thread
//     issuing every copy (K7's producer). The CTA visits only the KV tiles that meet its rows'
//     band, [m0 - lo, m0 + 127 + hi], so a window of w costs ~w columns a
//     row; each warpgroup skips (and releases unread) the tiles that miss its
//     own 64 rows (in the D 256 form, whose warpgroups take turns, it masks
//     them whole), and masks only the tiles that the band, the KV tail or a
//     document edge cuts. With segment ids the wrapper gives each Q tile's
//     and each KV tile's [min, max] id (flashattn_tpu/ops/flash.py::
//     _seg_block_flags, taken on the host as there); producer and consumers
//     walk the same list, the tiles whose range meets the Q tile's, so
//     packed attention costs the sum of the documents' areas. A visited tile
//     whose ids and the Q tile's are one single document is not masked; the
//     others are masked per pair from the rows' ids (read once) and the
//     tile's ids (padded by the wrapper to whole tiles of the route's KV
//     tile, 80 keys in the D 256 form), which come by a bulk copy on the
//     stage's K barrier.
//   * D 256 (Gemma 2's heads): Q takes 64 KB and a (K, V) stage of 80 keys
//     80 KB, so the ring has 2 stages (FbSmem); a consumer keeps O's 128 f32
//     accumulators, so setmaxnreg gives it 240 registers and the producer 24;
//     P V is one wgmma m64n256k16 a k-step (sm90.cuh), S one m64n80k16. At
//     64 keys a tile's shared-memory traffic equals its tensor work, so the
//     dense form takes 80-key tiles, overlaps each tile's softmax with the
//     next tile's S and the previous tile's P V, and has its two consumer
//     warpgroups issue their products in turn (FbSmem's OVERLAP, PINGPONG,
//     BN). At the LM's attention (B1 Hq8 Hkv4 N2048 D256 causal) the grid is
//     8 x 16 = 128 CTAs, one wave on 132 SMs: the longest visits 2048 keys,
//     268 MFLOP, 0.036 ms at one SM's share of 989 TFLOP/s, the floor of
//     this grid there.
//   * The bias route at D 256 (fwd_bias_sm90_kernel<256, SEG, CAP>): the
//     producer keeps 24 registers, too few for the 128-thread cp.async
//     stream, and a bias tile per stage would pass 227 KB. So the bias has
//     one slot of its own (32 KB: 229,376 B with Q and the two stages), on a
//     full / empty barrier pair of its own, filled by the one TMA thread --
//     two boxes of 32 columns x 128 rows (one row for a row-broadcast bias)
//     with the 128-byte swizzle, from the bias map of sm90.cuh (a broadcast
//     dim an extent-1 dim), at the tile's absolute column -- after the
//     tile's K and V. Each consumer warp releases the slot once its softmax
//     has read the tile (a warpgroup that skips the tile waits for it all the
//     same), so the next tile's bias lands while P V runs. With the swizzle a
//     half-warp's float2 reads fall on 4 chunks of 4 rows: 2-way bank
//     conflicts, where the cp.async layout below has none.
//   * The softmax spends one MUFU.EX2 per score (with CAP, tanhf's
//     exponential and reciprocal too). With a right bound
//     (causal) the longest Q tiles go first, so the tail of the grid is
//     short.
// Tried on the card and left out (H100, PERF.md §6): in the bias route at D
// 128 (path A's mask arm), overlapping a tile's softmax with the previous
// tile's P V inside a warpgroup, alone or with the two warpgroups taking
// turns on named barriers (5-10% slower), and Q's fragments in registers (no
// faster); the overlapped loop in the bias route's D 256 form (7-9% slower)
// and in the dense D 128 form (11% slower at the LM's attention).

#pragma once

#include "ring_merge.cuh"
#include "sm90.cuh"

namespace fa {

// The dense route's parameters (SEG: the segment ids and their tile ranges).
struct FwdDenseParams {
  __nv_bfloat16* o;
  float* lse;            // [B, Hq, Nq] contiguous
  const int* seg_q;      // [B, Nq] ids, batch stride seg_q_sb, unit along the rows
  const int* seg_kv;     // [B, kv_tiles * 64] ids, contiguous, each row padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 128-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) id of each 64-key tile's keys below kv_valid_len
  int64_t o_sb, o_sh, o_sn;
  int64_t seg_q_sb;
  int hq, rep, nq, d, kv_valid_len;
  int lo, hi;              // band: row - lo <= col <= row + hi (NO_BOUND: none)
  int q_tiles, kv_tiles;   // ceil(Nq / 128), ceil(kv_valid_len / 64)
  float scale_log2;        // softmax scale * log2(e)
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
};

// The bias route's: the dense route's and the bias.
struct FwdBiasParams : FwdDenseParams {
  const float* bias;   // f32, unit column stride, 16-byte-aligned rows
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
};

// The quantized family's: the bias route's (bias null without one) and the
// per-token f32 scales [B, Hkv, Nk] with their (batch, head, seq) strides.
struct FwdQuantParams : FwdBiasParams {
  const float* k_scale;
  const float* v_scale;
  int64_t ks_sb, ks_sh, ks_sn, vs_sb, vs_sh, vs_sn;
};

// The quantized family's launch on an f32 q (its F32Q form, tm_q the map of
// q's three bf16 pieces), D from p.d; defined in flash_fwd_quant_f32.cu.
cudaError_t fwd_quant_f32(const CUtensorMap& tm_q, const CUtensorMap& tm_k8,
                          const CUtensorMap& tm_v8, const FwdQuantParams& p, int kv_dtype,
                          int batch, cudaStream_t stream);

}  // namespace fa

namespace {

using namespace fa;

constexpr int FB_BLOCK_M = 128;  // Q rows per CTA: two consumer warpgroups of 64
constexpr int FB_BLOCK_N = 64;   // keys per KV tile below D 256 and in the bias forms (FbSmem::BN)
constexpr int FB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int FB_BOX_ROW = 128;  // bytes per row of a 64-column bf16 box (the swizzle's span)

// The body's design at each (D, BIAS) (chip_variants.py k1wide times each
// choice against the others) and its shared-memory layout (bytes, from a
// 1024-byte-aligned base): Q, then per stage K, V (each D / 64 boxes of 64
// columns, BN rows) and, with BIAS below D 256, the bias tile; at D 256 with
// BIAS the one bias slot (SLOT: two boxes of 32 columns x 128 rows); then the
// BN segment ids of each stage; then the mbarriers q_full, full[STAGES],
// empty[STAGES], with OVERLAP v_full[STAGES] and v_empty[STAGES] (full /
// empty then hold K and the ids alone), and with SLOT bias_full, bias_empty.
//   * OVERLAP (the dense D 256 form, K7's D 256 form with it): a consumer
//     warpgroup issues tile j's S = Q K^T, then the previous tile's O += P
//     V, and runs tile j's softmax while both are on the tensor cores
//     (FlashAttention-3's intra-warpgroup overlap), waiting on P V only
//     before it writes P again. K and V then sit on barriers of their own,
//     the producer issuing each tile's K one tile ahead of its V, so that K
//     is released once S has read it and V once P V has. The
//     bias forms keep the serial loop: with the D 256 slot it measured 7-9%
//     slower on path A's two arms (chip_ab.py), as at D 128 (the header).
//   * PINGPONG (with OVERLAP): the two consumer warpgroups issue their
//     products in turn, on named barriers 1 and 2 (with OVERLAP a tile's S
//     and the previous P V together, without it S and P V each), so that
//     one's softmax runs under the other's products; both then walk every
//     tile of the CTA (a tile outside a warpgroup's band is masked whole).
//     With OVERLAP it measured 9-12% faster than OVERLAP alone at D 256
//     (chip_variants.py k1wide).
//   * BN, the keys of a KV tile: 80 in the dense D 256 form (its Q 64 KB and
//     two (K, V) stages of 80 KB take 224 KB), where a 64-key tile's shared-
//     memory traffic (S's Q and K reads, P V's V reads, TMA's writes: 256 KB
//     a tile for both warpgroups, 2048 cycles at 128 B a clock) equals its
//     tensor work (2048 cycles at 2048 bf16 MAC a clock), so any stall comes
//     off the rate; 80 keys move 304 KB against 2560 cycles. The bias forms
//     keep 64 (the softmax's bias addressing, and the D 256 slot's 32 KB).
// D 256: Q 64 KB and 2 stages of (K, V), 225 KB with 80 keys, 225 KB with the
// bias slot at 64 keys; a third stage would pass 227 KB.
template <int D, bool BIAS = true>
struct FbSmem {
  static constexpr bool OVERLAP = D == 256 && !BIAS;
  static constexpr bool PINGPONG = D == 256 && !BIAS;
  static constexpr int BN = D == 256 && !BIAS ? 80 : 64;
  static constexpr int STAGES = D == 256 ? 2 : D == 64 || !BIAS ? 4 : 3;
  static constexpr bool SLOT = BIAS && D == 256;
  static constexpr int KSTEPS = BN / 16;  // P V's k-steps a tile
  static constexpr int NS = BN / 2;       // a consumer thread's scores of a tile
  static constexpr int Q = FB_BLOCK_M * D * 2;
  static constexpr int KV = BN * D * 2;
  static constexpr int BIAS_TILE = BIAS ? FB_BLOCK_M * BN * 4 : 0;
  static constexpr int BIAS_BOX = FB_BLOCK_M * SW128_F32 * 4;  // SLOT: a box's bytes
  static constexpr int STAGE = 2 * KV + (SLOT ? 0 : BIAS_TILE);
  static constexpr int OFF_BIAS = Q + STAGES * STAGE;  // SLOT
  static constexpr int SEG = OFF_BIAS + (SLOT ? BIAS_TILE : 0);  // int[STAGES][BN]
  static constexpr int BARS = SEG + STAGES * BN * 4;
  static constexpr int BYTES =
      1024 + BARS + (1 + (OVERLAP ? 4 : 2) * STAGES + (SLOT ? 2 : 0)) * 8;
  static_assert(Q % 1024 == 0 && KV % 1024 == 0 && BIAS_TILE % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BN == 64 || (BN == 80 && !BIAS), "the bias forms read 64-column bias tiles");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// The keys of the dense route's KV tile at head dim d (its tile ranges' and
// padded ids' width; flash_fwd_sm90.cu, ring_fwd.cu).
constexpr int dense_kv_tile(int d) {
  return d <= 64 ? FbSmem<64, false>::BN : d <= 128 ? FbSmem<128, false>::BN
                                                    : FbSmem<256, false>::BN;
}

// RING: the producer prefetches the rows' running state into L2 as it issues
// the loads of the CTA's RING_PREFETCH_TILES-th tile from the end (0: never),
// so that the merge (ring_merge_store) reads it from L2: read from device
// memory after the last tile, it took 13-16% of the D 256 off-diagonal step
// (chip_variants.py k1wide, the middle step against a first one).
constexpr int RING_PREFETCH_TILES = 4;

// The log2-domain score of raw score s: s * scale * log2 e, or with CAP
// cap * log2 e * tanh(s * scale / cap) -- the accurate tanhf, the one the
// backward recomputes (bwd_sm90_tile.cuh), not tanh.approx.
template <bool CAP>
__device__ __forceinline__ float log2_score(float s, float scale_log2, float cap_scale,
                                            float cap_log2) {
  if constexpr (CAP) return cap_log2 * tanhf(s * cap_scale);  // K1 sm90 tanh
  return s * scale_log2;
}

// Where column chunk c (4 floats) of row r of the bias tile is stored, in
// floats from the tile's start (the permutation of the header's notes).
__device__ __forceinline__ int bias_slot(int r, int c) {
  return r * FB_BLOCK_N + 4 * (c ^ ((r & 3) << 1));
}

// One tile's scores to probabilities (NS / 4 keys: 64, or 80 in the dense
// D 256 form), sc[4jj + 2r + e] being row row0 + 8r, column col0 + 8jj + 2t
// + e (absolute positions): scale (with CAP, cap)
// into the log2 domain in f32 (log2_score); with BIAS add the bias and floor
// at the mask value (a bias at the mask value times log2 e would overflow to
// -inf, and a tile of -inf only would make the rescale NaN); with MASKED (a
// tile that the band, the KV tail or, with SEG, a document edge cuts) set to
// the mask value the pairs outside the band, the columns at or past nkv and,
// with SEG, the pairs whose ids differ (ids: the tile's key ids in shared
// memory, q_seg the rows'); then the online max and sum. Returns the rescale
// factor of the earlier tiles' O in alpha. ACCURATE (K1's f32 route,
// flash_fwd_f32.cu) takes the exponentials by exp2f: FWD_TOL[f32] leaves no
// room for ex2.approx. The bias of column 8jj + 2t of row g is at shared
// address b_addr ^ 32jj (bias_slot's permutation: b_addr has bits 5-6 = row
// % 4 and bits 3-4 = t), row g + 8's b_step bytes on (0 for a row-broadcast
// bias); with SW128 (the D 256 slot's TMA boxes) at (b_addr ^ 32 (jj % 4)) +
// box (jj / 4) (b_addr has bits 4-6 = (t / 2) ^ (row % 8) and bit 3 = t % 2:
// chunk 2 (jj % 4) + t / 2 of the row, swizzled). QUANT (int8 / fp8 K/V, the
// quantized family, no CAP): the tile's 64 k scales times scale * log2 e at
// shared address kv_scales and its 64 v scales 256 bytes on (kv_scales
// already 8t bytes in: column 2t), where the TPU kernel applies them
// (flashattn_tpu/ops/flash_fwd.py:304-309, 342-345): k_scale[col] on the f32
// score (one multiply, the softmax scale with it), v_scale[col] on the
// probability after the row sum and before P's bf16 rounding; with BIAS the
// bias comes from b_regs (sc's layout), not shared memory.
template <bool MASKED, bool SEG, bool CAP, bool ACCURATE = false, bool BIAS = false,
          bool SW128 = false, bool QUANT = false, int NS>
__device__ __forceinline__ void dense_softmax_tile(float (&sc)[NS], int col0, int row0, int t,
                                                   int lo, int hi, int nkv, const int* ids,
                                                   const int (&q_seg)[2], float scale_log2,
                                                   float cap_scale, float cap_log2,
                                                   float (&m_i)[2], float (&l_i)[2],
                                                   float (&alpha)[2], uint32_t b_addr = 0,
                                                   uint32_t b_step = 0, uint32_t b_box = 0,
                                                   uint32_t kv_scales = 0,
                                                   const float* b_regs = nullptr) {
  static_assert(NS == 32 || (NS == 40 && !BIAS && !QUANT), "64- or 80-key tiles");
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int jj = 0; jj < NS / 4; ++jj) {
    int2 kv_seg = make_int2(0, 0);
    if (SEG && MASKED) kv_seg = *reinterpret_cast<const int2*>(ids + 8 * jj + 2 * t);
    float2 ks = make_float2(1.f, 1.f);
    if constexpr (QUANT) ks = lds_f2(kv_scales + 32 * jj);  // K1 quant k scale
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 bv = make_float2(0.f, 0.f);
      if constexpr (BIAS && QUANT) {
        bv = make_float2(b_regs[4 * jj + 2 * r], b_regs[4 * jj + 2 * r + 1]);
      } else if constexpr (BIAS) {
        const uint32_t a = SW128 ? (b_addr ^ (32 * (jj & 3))) + (jj >> 2) * b_box
                                 : b_addr ^ (32 * jj);
        bv = lds_f2(a + r * b_step);
      }
      const float bias2[2] = {bv.x, bv.y};  // K1 bias sm90 read
      const float kscale[2] = {ks.x, ks.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * r + e;
        float x = QUANT ? sc[i] * kscale[e]
                        : log2_score<CAP>(sc[i], scale_log2, cap_scale, cap_log2);
        if constexpr (BIAS) x = fmaxf(x + bias2[e] * LOG2E, MASK_VALUE);
        if (MASKED) {
          const int col = col0 + 8 * jj + 2 * t + e;
          const int row = row0 + 8 * r;
          if (col - row > hi || row - col > lo || col >= nkv) x = MASK_VALUE;  // K1 dense band mask
          if (SEG && (e ? kv_seg.y : kv_seg.x) != q_seg[r]) x = MASK_VALUE;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ACCURATE ? exp2f(m_i[r] - mx[r]) : ex2(m_i[r] - mx[r]);
    m_i[r] = mx[r];
    l_i[r] *= alpha[r];
  }
#pragma unroll
  for (int jj = 0; jj < NS / 4; ++jj) {
    float2 vs = make_float2(1.f, 1.f);
    if constexpr (QUANT) vs = lds_f2(kv_scales + 4 * FB_BLOCK_N + 32 * jj);  // K1 quant v scale
    const float vscale[2] = {vs.x, vs.y};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * jj + k;
      const float x = sc[i] - m_i[k >> 1];
      const float pe = ACCURATE ? exp2f(x) : ex2(x);
      l_i[k >> 1] += pe;
      sc[i] = QUANT ? pe * vscale[k & 1] : pe;  // K1 quant P v_scale
    }
  }
}

// The id range of KV tile `tile` of batch row b (the dense route's SEG).
__device__ __forceinline__ int2 kv_tile_range(const FwdDenseParams& p, int b, int tile) {
  return p.kv_range[b * p.kv_tiles + tile];
}

// The consumers' epilogue (every family): O = acc / l, LSE = m ln2 + log l
// of rows row0 and row0 + 8; ragged rows and O's columns >= D (zeros the
// boxes read) masked on store; a dead row stores O = 0 and LSE = ln2 * mask.
// O in bf16, or with F32O in f32 (the quantized family on an f32 q, whose
// p.o points at f32).
template <int D, bool F32O = false>
__device__ __forceinline__ void fwd_sm90_store(const FwdDenseParams& p, const float (&o)[D / 2],
                                               const float (&m_i)[2], const float (&l_i)[2],
                                               int b, int h, int row0, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool dead = m_i[r] <= MASK_VALUE * 0.5f;
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = dead ? 0.f : 1.f / l_safe;
    const int row = row0 + 8 * r;
    if (row < p.nq) {
      const int64_t o_off = b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_sn;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (8 * jj + 2 * t >= p.d) continue;
        const float x0 = o[4 * jj + 2 * r] * inv, x1 = o[4 * jj + 2 * r + 1] * inv;
        if constexpr (F32O) {
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.o) + o_off + 8 * jj + 2 * t) =
              make_float2(x0, x1);
        } else {
          *reinterpret_cast<uint32_t*>(p.o + o_off + 8 * jj + 2 * t) = pack_bf16(x0, x1);
        }
      }
      if (t == 0) {
        p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
            dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
      }
    }
  }
}

// The body of both families: BIAS, the bias route (Params FwdBiasParams);
// else the dense route (Params FwdDenseParams); in both SEG with segment ids
// and CAP with the logit softcap, the band as runtime ints. RING (K7's D 256
// form, ring_fwd.cu: Params with a RingState `ring`) merges the rows into a
// ring's running state in place of K1's epilogue (ring_merge.cuh). The
// consumers' loop is FbSmem's: serial (issue S, wait, softmax, issue P V,
// wait) or, with OVERLAP, a tile's S and the previous tile's P V on the
// tensor cores under the tile's softmax.
template <int D, bool BIAS, bool SEG, bool CAP, bool RING = false, typename Params>
__device__ __forceinline__ void fwd_sm90_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                              const CUtensorMap& tm_v, const Params& p,
                                              const CUtensorMap* tm_bias = nullptr) {
  static_assert(D == 64 || D == 128 || D == 256, "instantiated for D 64, 128 and 256");
  using S = FbSmem<D, BIAS>;
  constexpr bool SLOT = S::SLOT;  // the bias in one slot of its own, by TMA (D 256)
  constexpr int BN = S::BN;
  static_assert(!S::OVERLAP || !BIAS || SLOT, "the cp.async bias rides on the stage's barrier");
  // setmaxnreg's split of the registers between the producer and each
  // consumer warpgroup (56 + 2 x 224 = 24 + 2 x 240): at D 256 a consumer
  // keeps o[128], S's 40 scores and P's 20 fragments (with OVERLAP a tile's
  // S beside the previous tile's P), so the producer (one thread issuing
  // copies) goes down to 24 and the consumers up to 240, as
  // FlashAttention-3's Hopper forward splits them (56 / 224 there: 4-14%
  // slower in the serial loop, chip_variants.py k1wide).
  constexpr int PRODUCER_REGS = D == 256 ? 24 : 56;
  constexpr int CONSUMER_REGS = D == 256 ? 240 : 224;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;  // K and the ids (OVERLAP), or K, V and the ids
  uint64_t* empty = full + S::STAGES;
  uint64_t* v_full = S::OVERLAP ? empty + S::STAGES : full;
  uint64_t* v_empty = S::OVERLAP ? v_full + S::STAGES : empty;
  uint64_t* bias_full = empty + (S::OVERLAP ? 3 : 1) * S::STAGES;  // SLOT
  uint64_t* bias_empty = bias_full + 1;

  const int h = blockIdx.x;
  // A right bound (causal): the late Q tiles meet the most KV tiles, so they
  // go first and the tail of the grid is short.
  const int m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * FB_BLOCK_M;
  const int b = blockIdx.z;
  const int nkv = p.kv_valid_len;
  // The KV tiles from n_begin that meet the CTA's rows' band, columns
  // [m0 - lo, m0 + 127 + hi].
  int n_begin = 0;
  if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / BN * BN;
  const int n_end = p.hi < NO_BOUND ? min(nkv, m0 + FB_BLOCK_M + p.hi) : nkv;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + BN - 1) / BN : 0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::Q + (j % S::STAGES) * S::STAGE; };
  // SEG: the Q tile's id range, and whether KV tile j (from n_begin) holds a
  // key of it. Every thread reads the same ranges, so the producer (each of
  // its threads, with the bias) and both consumer warpgroups walk the same
  // tiles.
  int2 q_rng = make_int2(0, 0);
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m_tile];
  const int t_begin = n_begin / BN;
  auto skipped = [&](int j) {
    if constexpr (SEG) return !ranges_meet(q_rng, kv_tile_range(p, b, t_begin + j));
    return false;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      // BIAS below D 256: the TMA thread's expect_tx, each producer's cp.async.
      mbar_init(&full[s], BIAS && !SLOT ? 1 + 128 : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      if constexpr (S::OVERLAP) {
        mbar_init(&v_full[s], 1);
        mbar_init(&v_empty[s], 8);
      }
    }
    if constexpr (SLOT) {
      mbar_init(bias_full, 1);
      mbar_init(bias_empty, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
    if constexpr (BIAS && !SLOT) {
      // Producer: thread 0 issues the TMA loads, all 128 threads the bias copies.
      if (tid == 0) {
        mbar_expect_tx(q_full, S::Q);
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(smem + x * FB_BLOCK_M * FB_BOX_ROW, &tm_q, q_full, 64 * x, m0, h, b);
        }
      }
      // The bias tile, 4 columns a copy: thread tid copies chunk c of rows
      // r0 + 8i (row 0 alone for a row-broadcast bias); zeros past Nq (rows
      // never stored) and past kv_valid_len (columns the tail mask sets).
      const int c = tid % (BN / 4);
      const int r0 = tid / (BN / 4);
      const int bias_rows = p.bias_sn ? FB_BLOCK_M : 1;
      const int rows_valid = p.nq - m0;
      const float* bias_src = p.bias + b * p.bias_sb + h * p.bias_sh  // K1 bias sm90 head
                              + (m0 + r0) * p.bias_sn + 4 * c;
      const int64_t src_step = 8 * p.bias_sn;
      int it = 0;  // tiles issued
      for (int j = 0; j < n_tiles; ++j) {
        if (skipped(j)) continue;
        const int s = it % S::STAGES;
        const int n0 = n_begin + j * BN;  // the tile's first column
        unsigned char* st = stage(it);
        mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        if (tid == 0) {
          mbar_expect_tx(&full[s], 2 * S::KV + (SEG ? BN * 4 : 0));
#pragma unroll
          for (int x = 0; x < BOXES; ++x) {
            tma_load_4d(st + x * BN * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
            tma_load_4d(st + S::KV + x * BN * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0, hk, b);
          }
          if constexpr (SEG) {
            bulk_load(smem + S::SEG + s * BN * 4,
                      p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * BN + n0, BN * 4,
                      &full[s]);
          }
        }
        const int col_bytes = 4 * min(max(nkv - n0 - 4 * c, 0), 4);
        float* dst = reinterpret_cast<float*>(st + 2 * S::KV) + bias_slot(r0, c);
        const float* src = bias_src + n0;  // K1 bias sm90 column
        if (bias_rows == 1) {
          if (r0 == 0) cp_async_16_zfill(dst, col_bytes ? src : p.bias, col_bytes);
        } else {
#pragma unroll
          for (int i = 0; i < FB_BLOCK_M / 8; ++i) {
            const int bytes = r0 + 8 * i < rows_valid ? col_bytes : 0;
            cp_async_16_zfill(dst + 8 * i * BN, bytes ? src + i * src_step : p.bias, bytes);
          }
        }
        cp_async_mbar_arrive(&full[s]);
        ++it;
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (tid == 0) {
      // Producer: thread 0 issues every copy, over the tiles the consumers
      // visit (SEG: those whose id range meets the Q tile's); with SLOT the
      // bias too, once the slot is free. With OVERLAP a tile's K (and ids)
      // lands on full[s] and its V on v_full[s], V issued one tile behind K:
      // the consumers read tile j's K before tile j - 1's V.
      uint32_t bias_bytes = 0;
      if constexpr (SLOT) bias_bytes = 2 * (p.bias_sn ? FB_BLOCK_M : 1) * SW128_ROW;
      mbar_expect_tx(q_full, S::Q);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * FB_BLOCK_M * FB_BOX_ROW, &tm_q, q_full, 64 * x, m0, h, b);
      }
      // V of visit `it` (from column n0) into its stage.
      auto load_v = [&](int visit, int n0) {
        const int s = visit % S::STAGES;
        if constexpr (S::OVERLAP) {
          mbar_wait(&v_empty[s], ((visit / S::STAGES) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(&v_full[s], S::KV);
        }
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(stage(visit) + S::KV + x * BN * FB_BOX_ROW, &tm_v, &v_full[s], 64 * x, n0,
                      hk, b);
        }
      };
      int it = 0;  // tiles issued
      int n0_prev = 0;
      for (int j = 0; j < n_tiles; ++j) {
        if (skipped(j)) continue;
        const int s = it % S::STAGES;
        const int n0 = n_begin + j * BN;
        unsigned char* st = stage(it);
        mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        // K's boxes, then V's: each tensor's rows read whole, one after the
        // other (K's and V's boxes in turn measured 7% slower at the D 256
        // LM's attention and 12% non-causal, no different at D 128, in the
        // serial loop; chip_variants.py k1wide).
        mbar_expect_tx(&full[s], (S::OVERLAP ? 1 : 2) * S::KV + (SEG ? BN * 4 : 0));
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * BN * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
        }
        if constexpr (!S::OVERLAP) load_v(it, n0);
        if constexpr (SEG) {
          bulk_load(smem + S::SEG + s * BN * 4,
                    p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * BN + n0, BN * 4,
                    &full[s]);
        }
        if constexpr (SLOT) {
          mbar_wait(bias_empty, (it & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(bias_full, bias_bytes);
#pragma unroll
          for (int x = 0; x < BN / SW128_F32; ++x) {
            tma_load_4d(smem + S::OFF_BIAS + x * S::BIAS_BOX, tm_bias, bias_full,
                        n0 + SW128_F32 * x,  // K1 bias d256 column
                        p.bias_sn ? m0 : 0, p.bias_sh ? h : 0, p.bias_sb ? b : 0);
          }
        }
        if (S::OVERLAP && it > 0) load_v(it - 1, n0_prev);
        if constexpr (RING) {
          if (j == max(n_tiles - RING_PREFETCH_TILES, 0)) {
            ring_prefetch_state(p.ring, p.hq, p.nq, p.d, b, h, m0, FB_BLOCK_M);
          }
        }
        n0_prev = n0;
        ++it;
      }
      if constexpr (RING) {
        if (n_tiles == 0 && RING_PREFETCH_TILES > 0) {
          ring_prefetch_state(p.ring, p.hq, p.nq, p.d, b, h, m0, FB_BLOCK_M);
        }
      }
      if (S::OVERLAP && it > 0) load_v(it - 1, n0_prev);
    }
  } else {
    // Consumers: warpgroup 1 owns rows m0..m0+63, warpgroup 2 rows m0+64..m0+127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int half = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int r_first = m0 + half * 64;          // this warpgroup's first row
    const int tr = half * 64 + warp * 16 + g;    // row g of this warp in the CTA's tile
    const int row0 = m0 + tr;
    const unsigned char* q_s = smem + half * 64 * FB_BOX_ROW;
    // This warp is done with visit j's stage: its K and ids (release), its
    // V (release_v; without OVERLAP release frees both).
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % S::STAGES]);
    };
    auto release_v = [&](int j) {
      if constexpr (S::OVERLAP) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&v_empty[j % S::STAGES]);
      }
    };
    auto wait_v = [&](int j) {
      if constexpr (S::OVERLAP) mbar_wait(&v_full[j % S::STAGES], (j / S::STAGES) & 1);
    };
    // PINGPONG: this warpgroup's turn to issue products, then the other's.
    auto turn_begin = [&] {
      if constexpr (S::PINGPONG) named_sync(1 + half, 256);
    };
    auto turn_end = [&] {
      if constexpr (S::PINGPONG) named_arrive(2 - half, 256);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Rows g and g + 8; (m, l) in log2 units, l this thread's partial sum over
    // its columns (reduced over the quad at the end; m is quad-uniform).
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[S::NS], alpha[2];
    uint32_t pa[S::KSTEPS][4];
    // SEG: the ids of rows g and g + 8 (rows past Nq are never stored).
    int q_seg[2] = {0, 0};
    if constexpr (SEG) {
      const int* q_ids = p.seg_q + b * p.seg_q_sb;
      q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
      q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
    }
    const bool q_one_doc = q_rng.x == q_rng.y;
    // BIAS: this thread's bias, its row of the tile (row 0 of a
    // row-broadcast bias), chunk 2jj + t / 2 at bias_slot's place
    // (dense_softmax_tile).
    // SLOT: row tr of the box (row 0 of a row-broadcast bias), its chunk
    // t / 2 swizzled by the row's % 8 (g), 8 bytes in for an odd t.
    uint32_t b_off = 0, b_step = 0;
    if constexpr (SLOT) {
      const int b_row = p.bias_sn ? tr : 0;
      b_off = b_row * SW128_ROW + ((((t >> 1) ^ b_row) & 7) << 4) + (t & 1) * 8;
      b_step = p.bias_sn ? 8 * SW128_ROW : 0;
    } else if constexpr (BIAS) {
      const int b_row = p.bias_sn ? tr : 0;
      b_off = 4 * (b_row * BN + 8 * (b_row & 3) + 2 * t);
      b_step = p.bias_sn ? 4 * 8 * BN : 0;
    }
    // SLOT: this warp is done with the slot's tile (the producer refills it).
    auto release_bias = [&](int j) {
      if constexpr (SLOT) {
        mbar_wait(bias_full, j & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(bias_empty);
      }
    };
    // KV tile j's (visit `visit`'s) scores in sc to P, masked where the
    // band, the KV tail or a document edge cuts the tile for this
    // warpgroup's rows; alpha the factor of the earlier tiles' O.
    auto softmax = [&](int j, int visit, int2 k_rng) {
      const int c0 = n_begin + j * BN;  // the tile's first column
      const bool edge = c0 + BN > nkv || c0 + BN - 1 - r_first > p.hi ||
                        r_first + 63 - c0 > p.lo ||
                        (SEG && !(q_one_doc && k_rng.x == k_rng.y && k_rng.x == q_rng.x));
      const int* ids =
          reinterpret_cast<const int*>(smem + S::SEG + (visit % S::STAGES) * BN * 4);
      const uint32_t b_addr =
          !BIAS ? 0 : smem_u32(SLOT ? smem + S::OFF_BIAS : stage(visit) + 2 * S::KV) + b_off;
      if constexpr (SLOT) mbar_wait(bias_full, visit & 1);
      if (edge) {
        dense_softmax_tile<true, SEG, CAP, false, BIAS, SLOT>(
            sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
            p.cap_log2, m_i, l_i, alpha, b_addr, b_step, S::BIAS_BOX);
      } else {
        dense_softmax_tile<false, SEG, CAP, false, BIAS, SLOT>(
            sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
            p.cap_log2, m_i, l_i, alpha, b_addr, b_step, S::BIAS_BOX);
      }
      release_bias(visit);  // the wait has passed: this arrives
    };
    auto rescale = [&] {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    };
    // After the last P V: O and P free again.
    auto pv_retired = [&] {
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < S::KSTEPS; ++kk) fence_regs(pa[kk]);
    };
    // A tile that meets this warpgroup's band, [r_first - lo, r_first + 63 +
    // hi]; the others are released unread (PINGPONG: masked whole instead).
    auto meets = [&](int j) {
      const int c0 = n_begin + j * BN;
      return S::PINGPONG || (c0 <= r_first + 63 + p.hi && c0 + BN - 1 >= r_first - p.lo);
    };
    if constexpr (S::PINGPONG) {
      if (half == 1) named_arrive(1, 256);  // warpgroup 1 issues first
    }
    mbar_wait(q_full, 0);
    int it = 0;  // tiles visited, in the producer's order
    if constexpr (S::OVERLAP) {
      // From KV tile j on, the next tile this warpgroup computes (n_tiles:
      // none), its stage full; the visited tiles outside this warpgroup's
      // band on the way are released unread (`it` counts them).
      auto advance = [&](int j) {
        for (; j < n_tiles; ++j) {
          if (skipped(j)) continue;
          mbar_wait(&full[it % S::STAGES], (it / S::STAGES) & 1);
          if (meets(j)) break;
          release_bias(it);  // unread: the slot's phase still moves on
          release(it);
          wait_v(it);
          release_v(it);
          ++it;
        }
        return j;
      };
      auto k_range = [&](int j) {
        if constexpr (SEG) return kv_tile_range(p, b, t_begin + j);
        return make_int2(0, 0);
      };
      // The first tile alone: its S, then its P in pa (pend: its visit).
      // Every later tile's S and the pending P V are then issued without a
      // branch (ptxas serializes wgmma issued on a divergent path, C7520).
      int j = advance(0);
      if (j < n_tiles) {
        turn_begin();
        issue_qk<D, FB_BLOCK_M, BN>(sc, q_s, stage(it));
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        if constexpr (!SEG) release(it);  // K read; with SEG the ids until the softmax
        softmax(j, it, k_range(j));
        if constexpr (SEG) release(it);
        pack_p(pa, sc);
        int pend = it++;
        for (j = advance(j + 1); j < n_tiles; j = advance(j + 1)) {
          turn_begin();
          issue_qk<D, FB_BLOCK_M, BN>(sc, q_s, stage(it));  // K1 D256 next S
          rescale();  // O to the pending tile's max, under S's product
          wait_v(pend);
          issue_pv<D, BN>(o, pa, stage(pend) + S::KV);
          turn_end();
          wgmma_wait<1>();  // S
          fence_regs(sc);
          if constexpr (!SEG) release(it);
          softmax(j, it, k_range(j));
          if constexpr (SEG) release(it);
          pv_retired();
          release_v(pend);
          pack_p(pa, sc);
          pend = it++;
        }
        rescale();
        wait_v(pend);
        issue_pv<D, BN>(o, pa, stage(pend) + S::KV);
        pv_retired();
        release_v(pend);
      }
    } else {
      for (int j = 0; j < n_tiles; ++j) {
        int2 k_rng = make_int2(0, 0);
        if constexpr (SEG) {
          k_rng = kv_tile_range(p, b, t_begin + j);
          if (!ranges_meet(q_rng, k_rng)) continue;
        }
        mbar_wait(&full[it % S::STAGES], (it / S::STAGES) & 1);
        if (meets(j)) {
          turn_begin();
          issue_qk<D, FB_BLOCK_M, BN>(sc, q_s, stage(it));
          turn_end();
          wgmma_wait<0>();
          fence_regs(sc);
          softmax(j, it, k_rng);
          rescale();
          pack_p(pa, sc);
          turn_begin();
          issue_pv<D, BN>(o, pa, stage(it) + S::KV);
          turn_end();
          pv_retired();
        } else {
          release_bias(it);  // unread: the slot's phase still moves on
        }
        release(it);
        ++it;
      }
    }
    if constexpr (S::PINGPONG) {
      if (half == 0) named_sync(1, 256);  // warpgroup 1's last turn
    }

    if constexpr (RING) {
      ring_merge_store<D>(p.ring, p.o, p.o_sb, p.o_sh, p.o_sn, p.lse, p.hq, p.nq, p.d, o, m_i,
                          l_i, b, h, row0, t);
    } else {
      fwd_sm90_store<D>(p, o, m_i, l_i, b, h, row0, t);
    }
  }
}

// ---------------------------------------------------------------------------
// The quantized family (flash_fwd_quant_sm90.cu): int8 / e4m3 K/V.
//
// Shared-memory layout (bytes, from a 1024-byte-aligned base): Q; STAGES bf16
// (K, V) stages as the dense route's, which the consumers read; SLOTS8 slots
// of one 8-bit tile each (K or V: 64 keys x D bytes, unswizzled rows of D
// bytes), which TMA fills; each bf16 stage's 64 k and 64 v scales and 64
// segment ids; the mbarriers q_full, full[STAGES], empty[STAGES],
// raw_full[SLOTS8], raw_empty[SLOTS8]. A slot holds half a tile, so that the
// next tile's K lands while V is widened: at D 256 (Q 64 KB, two bf16 stages
// of 64 KB) there is room for two slots of 16 KB and no more (232,008 B). At
// D 128, 3 stages and 8 slots (4 tiles ahead) measured 0.7-2% faster than 4
// and 6 (chip_variants.py k1quant).
// F32Q (an f32 q, flash_fwd_quant_f32.cu): Q as its three bf16 pieces, each
// QP bytes. At D 128 they take 96 KB, so 2 bf16 stages and 6 slots remain
// (215,688 B); at D 256 a CTA takes 64 Q rows (one consumer warpgroup:
// three pieces of 128 rows would be 192 KB alone), and Q's 96 KB leave one
// bf16 stage and two slots (198,456 B). D 64: the bf16 q's layout with Q's
// 48 KB (151,752 B).
template <int D, bool F32Q = false>
struct FqSmem {
  static constexpr int BM = F32Q && D == 256 ? 64 : FB_BLOCK_M;  // Q rows per CTA
  static constexpr int CONSUMERS = BM / 64;                      // consumer warpgroups
  static constexpr int THREADS = 128 * (1 + CONSUMERS);
  static constexpr int STAGES =
      F32Q ? (D == 256 ? 1 : D == 128 ? 2 : 4) : (D == 256 ? 2 : D == 128 ? 3 : 4);
  static constexpr int SLOTS8 = D == 256 ? 2 : F32Q && D == 128 ? 6 : 8;
  static constexpr int QP = BM * D * 2;  // one bf16 piece of Q
  static constexpr int Q = (F32Q ? 3 : 1) * QP;
  static constexpr int KV = FB_BLOCK_N * D * 2;  // a bf16 tile
  static constexpr int KV8 = FB_BLOCK_N * D;     // an 8-bit tile
  static constexpr int STAGE = 2 * KV;
  static constexpr int OFF8 = Q + STAGES * STAGE;
  static constexpr int SCALES = OFF8 + SLOTS8 * KV8;     // float[STAGES][2][64]
  static constexpr int SEG = SCALES + STAGES * 2 * FB_BLOCK_N * 4;  // int[STAGES][64]
  static constexpr int BARS = SEG + STAGES * FB_BLOCK_N * 4;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES + 2 * SLOTS8) * 8;
  static_assert(QP % 1024 == 0 && KV % 1024 == 0 && KV8 % 128 == 0, "TMA's alignments");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// Four int8 (w's bytes, signed) as four bf16, exactly: byte b ^ 0x80 (b + 128)
// as the low byte of the f32 2^23 (0x4B000000) is 2^23 + 128 + b, from which
// one f32 subtraction leaves b; b's 8 significant bits fit bf16's, so the
// upper halves of two such f32 are two bf16 (one PRMT). No I2F: conversions
// run at a quarter of the integer pipe's rate on sm_90. (In bf16x2
// arithmetic -- 128 + (b & 127) minus 128 or 256, 8 operations for 4 values
// where this takes 11 -- it measured 5% slower: chip_variants.py k1quant.)
__device__ __forceinline__ uint2 widen4_int8(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
  }
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// Four e4m3 (w's bytes) as four bf16, exactly: pairs to f16x2 by the
// hardware conversion (cvt.rn.f16x2.e4m3x2, exact: e4m3's subnormals are
// normal in f16), each half to f32, the upper halves kept (4 significant
// bits fit bf16). (Through integer operations and a bf16x2 multiply by
// 2^120 it measured 8% slower: chip_variants.py k1quant.)
__device__ __forceinline__ uint2 widen4_fp8(uint32_t w) {
  uint32_t h[2];
  asm("{\n.reg .b16 a, b;\nmov.b32 {a, b}, %2;\ncvt.rn.f16x2.e4m3x2 %0, a;\n"
      "cvt.rn.f16x2.e4m3x2 %1, b;\n}\n"
      : "=r"(h[0]), "=r"(h[1])
      : "r"(w));
  uint32_t y[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h[i]));
    y[i] = __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
  }
  return make_uint2(y[0], y[1]);
}

template <int KV>
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  if constexpr (KV == KV_INT8) return widen4_int8(w);
  return widen4_fp8(w);  // K1 quant e4m3
}

// One 8-bit K or V tile (64 keys x D bytes, row pitch D, as TMA wrote it)
// widened, unscaled, to bf16 in D / 64 boxes of 64 keys x 128 bytes with the
// 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)): the layout TMA
// writes for the bf16 routes, which issue_qk's and issue_pv's descriptors
// read. Producer thread tid takes 16-byte pieces (16 values, two chunks
// out); in each 8-lane phase of a 16-byte access lanes 0-3 take row 2j and
// lanes 4-7 row 2j + 1, of a 128-byte run of the row the halves in turn (at
// D 64 the two rows, 64 bytes each, are the run), so the 8 loads and each of
// the 2 x 8 stores fall on 32 distinct banks.
template <int D, int KV>
__device__ __forceinline__ void widen_tile(unsigned char* dst, const unsigned char* src, int tid) {
  constexpr int RUNS = D == 64 ? 1 : D / 128;
  constexpr int HALVES = D == 64 ? 1 : 2;
  const int grp = tid >> 3, sub = (tid >> 2) & 1, q = tid & 3;
#pragma unroll
  for (int rp = 0; rp < 2; ++rp) {
    const int row = 32 * rp + 2 * grp + sub;
#pragma unroll 1  // D 256's two runs one after the other: the producer has 56 registers
    for (int run = 0; run < RUNS; ++run) {
#pragma unroll
      for (int hf = 0; hf < HALVES; ++hf) {
        const int piece = 8 * run + (D == 64 ? q : 4 * (sub ? 1 - hf : hf) + q);
        const uint4 raw = *reinterpret_cast<const uint4*>(src + row * D + 16 * piece);
        const uint2 a = widen4<KV>(raw.x), b = widen4<KV>(raw.y);
        const uint2 c = widen4<KV>(raw.z), d = widen4<KV>(raw.w);
        unsigned char* box_row = dst + (piece >> 2) * (FB_BLOCK_N * SW128_ROW) + row * SW128_ROW;
        const int chunk = 2 * (piece & 3);
        *reinterpret_cast<uint4*>(box_row + ((chunk ^ (row & 7)) << 4)) =
            make_uint4(a.x, a.y, b.x, b.y);
        *reinterpret_cast<uint4*>(box_row + (((chunk + 1) ^ (row & 7)) << 4)) =
            make_uint4(c.x, c.y, d.x, d.y);
      }
    }
  }
}

// BIAS in the quantized family: this thread's 32 bias values of the tile at
// column c0 in sc's layout (rows row0 and row0 + 8, columns c0 + 8jj + 2t
// and + 1), read from L2 as K5 + K6's D 256 bias route reads them: rows at
// or past Nq (row null) and columns at or past kv_valid_len read as 0.
__device__ __forceinline__ void load_bias_regs(float (&bq)[32], const float* row_g,
                                               const float* row_g8, int c0, int t, int nkv) {
#pragma unroll
  for (int jj = 0; jj < FB_BLOCK_N / 8; ++jj) {
    const int col = c0 + 8 * jj + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* row = r ? row_g8 : row_g;
      float2 v = make_float2(0.f, 0.f);
      if (row != nullptr && col + 1 < nkv) {
        v = __ldg(reinterpret_cast<const float2*>(row + col));
      } else if (row != nullptr && col < nkv) {
        v.x = __ldg(row + col);
      }
      bq[4 * jj + 2 * r] = v.x;
      bq[4 * jj + 2 * r + 1] = v.y;
    }
  }
}

// The quantized family's body: the dense route's band, offsets, segment ids
// and tails (and with BIAS an f32 bias from L2) on int8 / e4m3 K/V (KV),
// widened in shared memory. Producer warpgroup: thread 0 loads Q by TMA and
// keeps the 8-bit slots filled (K then V of each visited tile, by TMA from
// the 8-bit maps tm_k8 / tm_v8); all 128 threads widen each tile into a free
// bf16 stage (widen_tile), release the slot, store the tile's scales (one
// each, read before the widening: the k scales times scale * log2 e) and,
// after fence.proxy.async, arrive on the stage's full barrier (129
// arrivals: thread 0 first adds, with expect_tx, the bulk copy of the tile's
// ids). The consumers are the dense route's, with the scales in the softmax
// (dense_softmax_tile's QUANT).
// F32Q (an f32 q, flash_fwd_quant_f32.cu): tm_q maps Q's three bf16 pieces
// ([3B, H, N, D], piece pc of batch b at batch pc B + b; the split of q
// alone), S is three wgmma chains, one per piece, on the exactly widened K
// (wgmma_qk3), the softmax takes exp2f (ACCURATE), P (with its v_scale) is
// split in registers into three bf16 pieces and O += P V is three chains
// (wgmma_pv3), O is stored in f32: each f32 product the three bf16 products
// that Precision.HIGHEST takes when one operand is exact in bf16. At D 256 a
// CTA takes 64 Q rows with one consumer warpgroup (FqSmem).
template <int D, int KV, bool BIAS, bool SEG, bool F32Q = false>
__device__ __forceinline__ void fwd_quant_sm90_body(const CUtensorMap& tm_q,
                                                    const CUtensorMap& tm_k8,
                                                    const CUtensorMap& tm_v8,
                                                    const FwdQuantParams& p) {
  static_assert(D == 64 || D == 128 || D == 256, "instantiated for D 64, 128 and 256");
  static_assert(KV == KV_INT8 || KV == KV_FP8, "int8 or e4m3 K/V");
  using S = FqSmem<D, F32Q>;
  constexpr int BM = S::BM;
  // setmaxnreg's split, within the 3 x 168 registers a thread slot the launch
  // gave (a larger sum leaves the consumers' inc waiting forever): the
  // producer widens (a 16-byte piece in, two out) and walks the tile list; a
  // consumer keeps o[D / 2], sc[32] and, with BIAS, bq[32].
  // With one consumer warpgroup (F32Q at D 256: 256 threads, 255 registers
  // each) there is no setmaxnreg.
  constexpr int PRODUCER_REGS = D == 256 ? 56 : 72;
  constexpr int CONSUMER_REGS = D == 256 ? 224 : 216;
  static_assert(PRODUCER_REGS + 2 * CONSUMER_REGS <= 3 * 168, "the launch's registers");
  constexpr bool SETMAXNREG = S::CONSUMERS == 2;
  constexpr int BOXES = D / 64;
  constexpr uint32_t SCALE_BYTES = FB_BLOCK_N * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S::STAGES;
  uint64_t* raw_full = empty + S::STAGES;
  uint64_t* raw_empty = raw_full + S::SLOTS8;

  const int h = blockIdx.x;
  const int m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * BM;
  const int b = blockIdx.z;
  const int nkv = p.kv_valid_len;
  int n_begin = 0;
  if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / FB_BLOCK_N * FB_BLOCK_N;
  const int n_end = p.hi < NO_BOUND ? min(nkv, m0 + BM + p.hi) : nkv;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + FB_BLOCK_N - 1) / FB_BLOCK_N : 0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int hk = h / p.rep;
  auto stage = [&](int j) { return smem + S::Q + (j % S::STAGES) * S::STAGE; };
  int2 q_rng = make_int2(0, 0);
  // (The id range of the 128-row tile that holds the CTA's rows.)
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m0 / FB_BLOCK_M];
  const int t_begin = n_begin / FB_BLOCK_N;
  auto skipped = [&](int j) {
    if constexpr (SEG) return !ranges_meet(q_rng, kv_tile_range(p, b, t_begin + j));
    return false;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // each producer thread, and thread 0's expect_tx
      mbar_init(&empty[s], 4 * S::CONSUMERS);  // one arrival per consumer warp
    }
    for (int s = 0; s < S::SLOTS8; ++s) {
      mbar_init(&raw_full[s], 1);
      mbar_init(&raw_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (SETMAXNREG) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    }
    // Thread 0's TMA cursor: 8-bit tile u is K (u even) or V of the
    // (u / 2)-th visited tile, into slot u % SLOTS8 once every producer
    // thread has widened the slot's previous tile.
    int n_visit = 0;
    for (int j = 0; j < n_tiles; ++j) n_visit += !skipped(j);
    int jt = 0, n0_issue = 0;
    auto issue = [&](int u) {
      const int slot = u % S::SLOTS8;
      mbar_wait(&raw_empty[slot], ((u / S::SLOTS8) & 1) ^ 1);  // round 0 passes at once
      if ((u & 1) == 0) {
        while (skipped(jt)) ++jt;
        n0_issue = n_begin + jt * FB_BLOCK_N;
        ++jt;
      }
      mbar_expect_tx(&raw_full[slot], S::KV8);
      tma_load_4d(smem + S::OFF8 + slot * S::KV8, (u & 1) ? &tm_v8 : &tm_k8, &raw_full[slot], 0,
                  n0_issue, hk, b);
    };
    if (tid == 0) {
      mbar_expect_tx(q_full, S::Q);
#pragma unroll
      for (int pc = 0; pc < (F32Q ? 3 : 1); ++pc) {
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(smem + pc * S::QP + x * BM * FB_BOX_ROW, &tm_q, q_full, 64 * x, m0, h,
                      pc * gridDim.z + b);
        }
      }
      for (int u = 0; u < min(S::SLOTS8, 2 * n_visit); ++u) issue(u);
    }
    // This thread's scale of each tile, read through the scales' strides: k
    // scale tid (times scale * log2 e) or v scale tid - 64, at float tid of
    // the stage's scales; 0 past kv_valid_len (P = 0 there, and 0 * 0 stays 0).
    const bool k_side = tid < FB_BLOCK_N;
    const int scale_col = tid % FB_BLOCK_N;
    const float* scale_src = k_side ? p.k_scale + b * p.ks_sb + hk * p.ks_sh
                                    : p.v_scale + b * p.vs_sb + hk * p.vs_sh;
    const int64_t scale_sn = k_side ? p.ks_sn : p.vs_sn;
    const float scale_mul = k_side ? p.scale_log2 : 1.f;
    int it = 0;  // tiles widened
    for (int j = 0; j < n_tiles; ++j) {
      if (skipped(j)) continue;
      const int s = it % S::STAGES;
      const int n0 = n_begin + j * FB_BLOCK_N;
      unsigned char* st = stage(it);
      const int col = n0 + scale_col;  // K1 quant scales column
      const float scale = col < nkv ? __ldg(scale_src + col * scale_sn) : 0.f;
      mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // round 0 passes at once
      if (tid == 0) {
        mbar_expect_tx(&full[s], SEG ? FB_BLOCK_N * 4 : 0);
        if constexpr (SEG) {
          bulk_load(smem + S::SEG + s * FB_BLOCK_N * 4,
                    p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * FB_BLOCK_N + n0,
                    FB_BLOCK_N * 4, &full[s]);
        }
      }
#pragma unroll 1
      for (int x = 0; x < 2; ++x) {  // K, then V
        const int u = 2 * it + x;
        const int slot = u % S::SLOTS8;
        mbar_wait(&raw_full[slot], (u / S::SLOTS8) & 1);
        widen_tile<D, KV>(st + x * S::KV, smem + S::OFF8 + slot * S::KV8, tid);
        mbar_arrive(&raw_empty[slot]);
        if (tid == 0 && u + S::SLOTS8 < 2 * n_visit) issue(u + S::SLOTS8);
      }
      reinterpret_cast<float*>(smem + S::SCALES + s * 2 * SCALE_BYTES)[tid] = scale * scale_mul;
      fence_proxy_async();  // the widened tile, to the consumers' wgmma
      mbar_arrive(&full[s]);
      ++it;
    }
  } else {
    if constexpr (SETMAXNREG) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    }
    const int half = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r_first = m0 + half * 64;
    const int row0 = m0 + half * 64 + warp * 16 + g;
    const unsigned char* q_s = smem + half * 64 * FB_BOX_ROW;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[32], alpha[2], bq[32];
    uint32_t pa[F32Q ? 3 : 1][4][4];  // P's bf16 A fragments (F32Q: its three pieces)
    int q_seg[2] = {0, 0};
    if constexpr (SEG) {
      const int* q_ids = p.seg_q + b * p.seg_q_sb;
      q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
      q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
    }
    const bool q_one_doc = q_rng.x == q_rng.y;
    const float* bias_g = nullptr;
    const float* bias_g8 = nullptr;
    if constexpr (BIAS) {
      const float* bias_bh = p.bias + b * p.bias_sb + h * p.bias_sh;
      bias_g = row0 < p.nq ? bias_bh + static_cast<int64_t>(row0) * p.bias_sn : nullptr;
      bias_g8 = row0 + 8 < p.nq ? bias_bh + static_cast<int64_t>(row0 + 8) * p.bias_sn : nullptr;
    }
    mbar_wait(q_full, 0);
    int it = 0;
    for (int j = 0; j < n_tiles; ++j) {
      int2 k_rng = make_int2(0, 0);
      if constexpr (SEG) {
        k_rng = kv_tile_range(p, b, t_begin + j);
        if (!ranges_meet(q_rng, k_rng)) continue;
      }
      const int s = it % S::STAGES;
      const int c0 = n_begin + j * FB_BLOCK_N;
      mbar_wait(&full[s], (it / S::STAGES) & 1);
      if (c0 <= r_first + 63 + p.hi && c0 + FB_BLOCK_N - 1 >= r_first - p.lo) {
        if constexpr (F32Q) {
          wgmma_qk3<D, BM, FB_BLOCK_N, S::QP>(sc, q_s, stage(it));
        } else {
          issue_qk<D, BM, FB_BLOCK_N>(sc, q_s, stage(it));
        }
        if constexpr (BIAS) load_bias_regs(bq, bias_g, bias_g8, c0, t, nkv);
        wgmma_wait<0>();
        fence_regs(sc);
        const bool edge = c0 + FB_BLOCK_N > nkv || c0 + FB_BLOCK_N - 1 - r_first > p.hi ||
                          r_first + 63 - c0 > p.lo ||
                          (SEG && !(q_one_doc && k_rng.x == k_rng.y && k_rng.x == q_rng.x));
        const int* ids = reinterpret_cast<const int*>(smem + S::SEG + s * FB_BLOCK_N * 4);
        const uint32_t kv_scales = smem_u32(smem + S::SCALES + s * 2 * SCALE_BYTES) + 8 * t;
        if (edge) {
          dense_softmax_tile<true, SEG, false, F32Q, BIAS, false, true>(
              sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, 0.f, 0.f, m_i, l_i,
              alpha, 0, 0, 0, kv_scales, bq);
        } else {
          dense_softmax_tile<false, SEG, false, F32Q, BIAS, false, true>(
              sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, 0.f, 0.f, m_i, l_i,
              alpha, 0, 0, 0, kv_scales, bq);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        if constexpr (F32Q) {
          split3_frags<4>(pa, sc);  // K1 quant f32 P pieces
          wgmma_pv3<D, FB_BLOCK_N>(o, pa, stage(it) + S::KV);
        } else {
          pack_p(pa[0], sc);
          issue_pv<D, FB_BLOCK_N>(o, pa[0], stage(it) + S::KV);
        }
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int pc = 0; pc < (F32Q ? 3 : 1); ++pc) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pa[pc][kk]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      ++it;
    }
    fwd_sm90_store<D, F32Q>(p, o, m_i, l_i, b, h, row0, t);
  }
}

// The grid of every family: (head, Q tile of `rows` rows, batch), the head
// fastest, `threads` a CTA (the quantized family's F32Q at D 256: 64 rows,
// 256 threads).
template <typename Kernel, typename Params>
cudaError_t fwd_sm90_launch(Kernel kernel, int smem, const CUtensorMap& tm_q,
                            const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Params& p,
                            int batch, cudaStream_t stream, int rows = FB_BLOCK_M,
                            int threads = FB_THREADS) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nq + rows - 1) / rows, batch);
  kernel<<<grid, threads, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

}  // namespace
