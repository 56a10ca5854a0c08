// K1 for Hopper (sm_90a): one warp-specialised TMA + wgmma forward body
// with two instantiation families -- K1's bias route, which streams the f32
// bias tile through shared memory (flash_fwd_bias_sm90.cu), and K1's dense
// route (flash_fwd_sm90.cu) -- both with the causal / window band, q / kv
// offsets, segment ids and any tail.
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) and, with causal or a window, the whole-sequence banded
// _fwd_causal_resident_kernel (K2, :516) and fwd_macro_padded (:957).
// Both families compute what fwd_tile.cuh computes for their calls: scores
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
//     bias or quantized K/V; the KV tail
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
// of it: 0.32 ms at 3.35 TB/s, bytes. fwd_tile ran them at ~100 and 56
// TFLOP/s: mma.sync at 16 rows per warp, synchronous K / V loads between two
// block barriers, and (with a bias) one dependent scalar bias load per
// score. With the softcap at the SWA shape (B1 Hq16 Hkv8 N8192 D128, window
// 2047, cap 50) the products are 0.12 ms of operations, and each score's
// tanhf puts two more MUFU operations (an exponential and a reciprocal) and
// ~15 FMA-pipe instructions beside the softmax's one ex2: fwd_tile took 0.84
// ms there. This design:
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
//     own 64 rows, and masks only the tiles that the band, the KV tail or a
//     document edge cuts. With segment ids the wrapper gives each Q tile's
//     and each KV tile's [min, max] id (flashattn_tpu/ops/flash.py::
//     _seg_block_flags, taken on the host as there); producer and consumers
//     walk the same list, the tiles whose range meets the Q tile's, so
//     packed attention costs the sum of the documents' areas. A visited tile
//     whose ids and the Q tile's are one single document is not masked; the
//     others are masked per pair from the rows' ids (read once) and the
//     tile's 64 ids (padded by the wrapper to whole tiles), which come by a
//     bulk copy on the stage's barrier.
//   * D 256 (Gemma 2's heads): Q takes 64 KB and a (K, V) stage 64 KB, so
//     the ring has 2 stages (FbSmem); a consumer keeps O's 128 f32
//     accumulators, so setmaxnreg gives it 240 registers and the producer 24;
//     P V is one wgmma m64n256k16 a k-step (sm90.cuh). At the LM's attention
//     (B1 Hq8 Hkv4 N2048 D256 causal) the grid is 8 x 16 = 128 CTAs, one wave
//     on 132 SMs: the longest visits 32 KV tiles, 268 MFLOP, 0.036 ms at one
//     SM's share of 989 TFLOP/s, the floor of this grid there.
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
// Tried on the card and left out (H100, path A's mask arm; PERF.md §6):
// overlapping a tile's softmax with the previous tile's P V inside a
// warpgroup, alone or with the two warpgroups taking turns on named barriers
// (5-10% slower), and Q's fragments in registers (no faster).

#pragma once

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

}  // namespace fa

namespace {

using namespace fa;

constexpr int FB_BLOCK_M = 128;  // Q rows per CTA: two consumer warpgroups of 64
constexpr int FB_BLOCK_N = 64;   // keys per KV tile
constexpr int FB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int FB_BOX_ROW = 128;  // bytes per row of a 64-column bf16 box (the swizzle's span)

// Shared-memory layout (bytes, from a 1024-byte-aligned base): Q, then per
// stage K, V (each D / 64 boxes of 64 columns) and, with BIAS below D 256,
// the bias tile; at D 256 with BIAS the one bias slot (SLOT: two boxes of 32
// columns x 128 rows); then the 64 segment ids of each stage; then the
// mbarriers q_full, full[STAGES], empty[STAGES] and with SLOT bias_full,
// bias_empty. D 256: Q 64 KB and 2 stages of (K, V) 64 KB, 193 KB in all (225
// KB with the bias slot); a third stage would pass 227 KB. (K and V on
// barriers of their own, so that S = Q K^T starts once K has landed, measured
// no faster: chip_variants.py k1wide.)
template <int D, bool BIAS = true>
struct FbSmem {
  static constexpr int STAGES = D == 256 ? 2 : D == 64 || !BIAS ? 4 : 3;
  static constexpr bool SLOT = BIAS && D == 256;
  static constexpr int Q = FB_BLOCK_M * D * 2;
  static constexpr int KV = FB_BLOCK_N * D * 2;
  static constexpr int BIAS_TILE = BIAS ? FB_BLOCK_M * FB_BLOCK_N * 4 : 0;
  static constexpr int BIAS_BOX = FB_BLOCK_M * SW128_F32 * 4;  // SLOT: a box's bytes
  static constexpr int STAGE = 2 * KV + (SLOT ? 0 : BIAS_TILE);
  static constexpr int OFF_BIAS = Q + STAGES * STAGE;  // SLOT
  static constexpr int SEG = OFF_BIAS + (SLOT ? BIAS_TILE : 0);  // int[STAGES][64]
  static constexpr int BARS = SEG + STAGES * FB_BLOCK_N * 4;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES + (SLOT ? 2 : 0)) * 8;
  static_assert(Q % 1024 == 0 && KV % 1024 == 0 && BIAS_TILE % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

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

// One tile's scores to probabilities, sc[4jj + 2r + e] being row row0 +
// 8r, column col0 + 8jj + 2t + e (absolute positions): scale (with CAP, cap)
// into the log2 domain in f32 (log2_score); with BIAS add the bias and floor
// at the mask value (a bias at the mask value times log2 e would overflow to
// -inf, and a tile of -inf only would make the rescale NaN); with MASKED (a
// tile that the band, the KV tail or, with SEG, a document edge cuts) set to
// the mask value the pairs outside the band, the columns at or past nkv and,
// with SEG, the pairs whose ids differ (ids: the tile's 64 key ids in shared
// memory, q_seg the rows'); then the online max and sum. Returns the rescale
// factor of the earlier tiles' O in alpha. ACCURATE (K1's f32 route,
// flash_fwd_f32.cu) takes the exponentials by exp2f: FWD_TOL[f32] leaves no
// room for ex2.approx. The bias of column 8jj + 2t of row g is at shared
// address b_addr ^ 32jj (bias_slot's permutation: b_addr has bits 5-6 = row
// % 4 and bits 3-4 = t), row g + 8's b_step bytes on (0 for a row-broadcast
// bias); with SW128 (the D 256 slot's TMA boxes) at (b_addr ^ 32 (jj % 4)) +
// box (jj / 4) (b_addr has bits 4-6 = (t / 2) ^ (row % 8) and bit 3 = t % 2:
// chunk 2 (jj % 4) + t / 2 of the row, swizzled).
template <bool MASKED, bool SEG, bool CAP, bool ACCURATE = false, bool BIAS = false,
          bool SW128 = false>
__device__ __forceinline__ void dense_softmax_tile(float (&sc)[32], int col0, int row0, int t,
                                                   int lo, int hi, int nkv, const int* ids,
                                                   const int (&q_seg)[2], float scale_log2,
                                                   float cap_scale, float cap_log2,
                                                   float (&m_i)[2], float (&l_i)[2],
                                                   float (&alpha)[2], uint32_t b_addr = 0,
                                                   uint32_t b_step = 0, uint32_t b_box = 0) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int jj = 0; jj < FB_BLOCK_N / 8; ++jj) {
    int2 kv_seg = make_int2(0, 0);
    if (SEG && MASKED) kv_seg = *reinterpret_cast<const int2*>(ids + 8 * jj + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 bv = make_float2(0.f, 0.f);
      if constexpr (BIAS) {
        const uint32_t a = SW128 ? (b_addr ^ (32 * (jj & 3))) + (jj >> 2) * b_box
                                 : b_addr ^ (32 * jj);
        bv = lds_f2(a + r * b_step);
      }
      const float bias2[2] = {bv.x, bv.y};  // K1 bias sm90 read
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * r + e;
        float x = log2_score<CAP>(sc[i], scale_log2, cap_scale, cap_log2);
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
  for (int i = 0; i < 32; ++i) {
    const float x = sc[i] - m_i[(i >> 1) & 1];
    const float pe = ACCURATE ? exp2f(x) : ex2(x);
    l_i[(i >> 1) & 1] += pe;
    sc[i] = pe;
  }
}

// The id range of KV tile `tile` of batch row b (the dense route's SEG).
__device__ __forceinline__ int2 kv_tile_range(const FwdDenseParams& p, int b, int tile) {
  return p.kv_range[b * p.kv_tiles + tile];
}

// The body of both families: BIAS, the bias route (Params FwdBiasParams);
// else the dense route (Params FwdDenseParams); in both SEG with segment ids
// and CAP with the logit softcap, the band as runtime ints.
template <int D, bool BIAS, bool SEG, bool CAP, typename Params>
__device__ __forceinline__ void fwd_sm90_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                              const CUtensorMap& tm_v, const Params& p,
                                              const CUtensorMap* tm_bias = nullptr) {
  static_assert(D == 64 || D == 128 || D == 256, "instantiated for D 64, 128 and 256");
  using S = FbSmem<D, BIAS>;
  constexpr bool SLOT = S::SLOT;  // the bias in one slot of its own, by TMA (D 256)
  // setmaxnreg's split of the registers between the producer and each
  // consumer warpgroup (56 + 2 x 224 = 24 + 2 x 240): at D 256 a consumer
  // keeps o[128], sc[32] and pa[16], so the producer (one thread issuing
  // copies) goes down to 24 and the consumers up to 240, as
  // FlashAttention-3's Hopper forward splits them (56 / 224 there: 4-14%
  // slower, chip_variants.py k1wide).
  constexpr int PRODUCER_REGS = D == 256 ? 24 : 56;
  constexpr int CONSUMER_REGS = D == 256 ? 240 : 224;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S::STAGES;
  uint64_t* bias_full = empty + S::STAGES;  // SLOT
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
  if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / FB_BLOCK_N * FB_BLOCK_N;
  const int n_end = p.hi < NO_BOUND ? min(nkv, m0 + FB_BLOCK_M + p.hi) : nkv;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + FB_BLOCK_N - 1) / FB_BLOCK_N : 0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::Q + (j % S::STAGES) * S::STAGE; };
  // SEG: the Q tile's id range, and whether KV tile j (from n_begin) holds a
  // key of it. Every thread reads the same ranges, so the producer (each of
  // its threads, with the bias) and both consumer warpgroups walk the same
  // tiles.
  int2 q_rng = make_int2(0, 0);
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m_tile];
  const int t_begin = n_begin / FB_BLOCK_N;
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
      const int c = tid % (FB_BLOCK_N / 4);
      const int r0 = tid / (FB_BLOCK_N / 4);
      const int bias_rows = p.bias_sn ? FB_BLOCK_M : 1;
      const int rows_valid = p.nq - m0;
      const float* bias_src = p.bias + b * p.bias_sb + h * p.bias_sh  // K1 bias sm90 head
                              + (m0 + r0) * p.bias_sn + 4 * c;
      const int64_t src_step = 8 * p.bias_sn;
      int it = 0;  // tiles issued
      for (int j = 0; j < n_tiles; ++j) {
        if (skipped(j)) continue;
        const int s = it % S::STAGES;
        const int n0 = n_begin + j * FB_BLOCK_N;  // the tile's first column
        unsigned char* st = stage(it);
        mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        if (tid == 0) {
          mbar_expect_tx(&full[s], 2 * S::KV + (SEG ? FB_BLOCK_N * 4 : 0));
#pragma unroll
          for (int x = 0; x < BOXES; ++x) {
            tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
            tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0,
                        hk, b);
          }
          if constexpr (SEG) {
            bulk_load(smem + S::SEG + s * FB_BLOCK_N * 4,
                      p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * FB_BLOCK_N + n0,
                      FB_BLOCK_N * 4, &full[s]);
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
            cp_async_16_zfill(dst + 8 * i * FB_BLOCK_N, bytes ? src + i * src_step : p.bias,
                              bytes);
          }
        }
        cp_async_mbar_arrive(&full[s]);
        ++it;
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (tid == 0) {
      // Producer: thread 0 issues every copy, over the tiles the consumers
      // visit (SEG: those whose id range meets the Q tile's); with SLOT the
      // bias too, once the slot is free.
      uint32_t bias_bytes = 0;
      if constexpr (SLOT) bias_bytes = 2 * (p.bias_sn ? FB_BLOCK_M : 1) * SW128_ROW;
      mbar_expect_tx(q_full, S::Q);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * FB_BLOCK_M * FB_BOX_ROW, &tm_q, q_full, 64 * x, m0, h, b);
      }
      int it = 0;  // tiles issued
      for (int j = 0; j < n_tiles; ++j) {
        if (skipped(j)) continue;
        const int s = it % S::STAGES;
        const int n0 = n_begin + j * FB_BLOCK_N;
        unsigned char* st = stage(it);
        mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        // K's boxes, then V's: each tensor's rows read whole, one after the
        // other (K's and V's boxes in turn measured 7% slower at the D 256
        // LM's attention and 12% non-causal, no different at D 128;
        // chip_variants.py k1wide).
        mbar_expect_tx(&full[s], 2 * S::KV + (SEG ? FB_BLOCK_N * 4 : 0));
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
        }
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0, hk,
                      b);
        }
        if constexpr (SEG) {
          bulk_load(smem + S::SEG + s * FB_BLOCK_N * 4,
                    p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * FB_BLOCK_N + n0,
                    FB_BLOCK_N * 4, &full[s]);
        }
        if constexpr (SLOT) {
          mbar_wait(bias_empty, (it & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(bias_full, bias_bytes);
#pragma unroll
          for (int x = 0; x < FB_BLOCK_N / SW128_F32; ++x) {
            tma_load_4d(smem + S::OFF_BIAS + x * S::BIAS_BOX, tm_bias, bias_full,
                        n0 + SW128_F32 * x,  // K1 bias d256 column
                        p.bias_sn ? m0 : 0, p.bias_sh ? h : 0, p.bias_sb ? b : 0);
          }
        }
        ++it;
      }
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
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % S::STAGES]);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Rows g and g + 8; (m, l) in log2 units, l this thread's partial sum over
    // its columns (reduced over the quad at the end; m is quad-uniform).
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[32], alpha[2];
    uint32_t pa[4][4];
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
      b_off = 4 * (b_row * FB_BLOCK_N + 8 * (b_row & 3) + 2 * t);
      b_step = p.bias_sn ? 4 * 8 * FB_BLOCK_N : 0;
    }
    // SLOT: this warp is done with the slot's tile (the producer refills it).
    auto release_bias = [&](int j) {
      if constexpr (SLOT) {
        mbar_wait(bias_full, j & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(bias_empty);
      }
    };
    mbar_wait(q_full, 0);
    int it = 0;  // tiles visited, in the producer's order
    for (int j = 0; j < n_tiles; ++j) {
      int2 k_rng = make_int2(0, 0);
      if constexpr (SEG) {
        k_rng = kv_tile_range(p, b, t_begin + j);
        if (!ranges_meet(q_rng, k_rng)) continue;
      }
      const int s = it % S::STAGES;
      const int c0 = n_begin + j * FB_BLOCK_N;  // the tile's first column
      mbar_wait(&full[s], (it / S::STAGES) & 1);
      // A tile that meets this warpgroup's band, [r_first - lo, r_first +
      // 63 + hi]; the others are released unread.
      if (c0 <= r_first + 63 + p.hi && c0 + FB_BLOCK_N - 1 >= r_first - p.lo) {
        issue_qk<D, FB_BLOCK_M, FB_BLOCK_N>(sc, q_s, stage(it));
        if constexpr (SLOT) mbar_wait(bias_full, it & 1);
        wgmma_wait<0>();
        fence_regs(sc);
        const bool edge = c0 + FB_BLOCK_N > nkv || c0 + FB_BLOCK_N - 1 - r_first > p.hi ||
                          r_first + 63 - c0 > p.lo ||
                          (SEG && !(q_one_doc && k_rng.x == k_rng.y && k_rng.x == q_rng.x));
        const int* ids = reinterpret_cast<const int*>(smem + S::SEG + s * FB_BLOCK_N * 4);
        const uint32_t b_addr =
            !BIAS ? 0 : smem_u32(SLOT ? smem + S::OFF_BIAS : stage(it) + 2 * S::KV) + b_off;
        if (edge) {
          dense_softmax_tile<true, SEG, CAP, false, BIAS, SLOT>(
              sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
              p.cap_log2, m_i, l_i, alpha, b_addr, b_step, S::BIAS_BOX);
        } else {
          dense_softmax_tile<false, SEG, CAP, false, BIAS, SLOT>(
              sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
              p.cap_log2, m_i, l_i, alpha, b_addr, b_step, S::BIAS_BOX);
        }
        release_bias(it);  // the wait has passed: this arrives
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p(pa, sc);
        issue_pv<D, FB_BLOCK_N>(o, pa, stage(it) + S::KV);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      } else {
        release_bias(it);  // unread: the slot's phase still moves on
      }
      release(it);
      ++it;
    }

    // Epilogue: O = acc / l, LSE = m ln2 + log l; ragged rows and O's
    // columns >= D (zeros the boxes read) masked on store.
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
        __nv_bfloat16* o_row = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_sn;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          if (8 * jj + 2 * t >= p.d) continue;
          *reinterpret_cast<uint32_t*>(o_row + 8 * jj + 2 * t) =
              pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
        }
        if (t == 0) {
          p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
              dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
        }
      }
    }
  }
}

// The grid of both families: (head, Q tile, batch), the head fastest.
template <typename Kernel, typename Params>
cudaError_t fwd_sm90_launch(Kernel kernel, int smem, const CUtensorMap& tm_q,
                            const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Params& p,
                            int batch, cudaStream_t stream) {
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nq + FB_BLOCK_M - 1) / FB_BLOCK_M, batch);
  kernel<<<grid, FB_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

}  // namespace
