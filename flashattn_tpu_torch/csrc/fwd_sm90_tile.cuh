// K1 for Hopper (sm_90a): one warp-specialised TMA + wgmma forward body
// with two instantiation families -- K1's bias route, which streams the f32
// bias tile through shared memory (flash_fwd_bias_sm90.cu), and K1's dense
// route, with the causal / window band, segment ids and any tail
// (flash_fwd_sm90.cu).
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
//   * Both routes take any D that is a multiple of 8 up to 128,
//     instantiated at 64 and 128: D 40, 80 or 96 read zeros past D from the
//     TMA boxes, and O's columns >= D are never written. Both take the
//     softcap (CAP, a template flag): the accurate tanhf, which the
//     backward's recompute uses too -- a P that differs from the backward's
//     breaks sum(P) = 1 behind Delta.
//   * The bias route (ops/flash_fwd.py::bias_route): bf16 Q/K/V, an
//     additive f32 bias [B|1, H|1, Nq|1, Nk] read through (batch,
//     head, row) strides that are 0 on broadcast dims, columns only below
//     kv_valid_len and rows only below Nq; the KV tail and the top-left
//     causal mask; no segment ids or window.
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
//     together and read it from HBM once.
//   * The dense route: 4 stages of (K, V) and one thread issuing every copy
//     (K7's producer). The CTA visits only the KV tiles that meet its rows'
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

struct FwdBiasParams {
  __nv_bfloat16* o;
  float* lse;          // [B, Hq, Nq] contiguous
  const float* bias;   // f32, unit column stride, 16-byte-aligned rows
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  int hq, rep, nq, d, kv_valid_len, causal;
  float scale_log2;           // softmax scale * log2(e)
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
};

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

}  // namespace fa

namespace {

using namespace fa;

constexpr int FB_BLOCK_M = 128;  // Q rows per CTA: two consumer warpgroups of 64
constexpr int FB_BLOCK_N = 64;   // keys per KV tile
constexpr int FB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int FB_BOX_ROW = 128;  // bytes per row of a 64-column bf16 box (the swizzle's span)

// Shared-memory layout (bytes, from a 1024-byte-aligned base): Q, then per
// stage K, V (each D / 64 boxes of 64 columns) and, with BIAS, the bias
// tile; without, the 64 segment ids of each stage; then the mbarriers
// q_full, full[STAGES], empty[STAGES].
template <int D, bool BIAS = true>
struct FbSmem {
  static constexpr int STAGES = D == 64 || !BIAS ? 4 : 3;
  static constexpr int Q = FB_BLOCK_M * D * 2;
  static constexpr int KV = FB_BLOCK_N * D * 2;
  static constexpr int BIAS_TILE = BIAS ? FB_BLOCK_M * FB_BLOCK_N * 4 : 0;
  static constexpr int STAGE = 2 * KV + BIAS_TILE;
  static constexpr int SEG = BIAS ? 0 : Q + STAGES * STAGE;  // int[STAGES][64]
  static constexpr int BARS = Q + STAGES * STAGE + (BIAS ? 0 : STAGES * FB_BLOCK_N * 4);
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES) * 8;
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

// One tile's scores to probabilities, sc[4jj + 2r + e] being row g + 8r,
// column 8jj + 2t + e: scale (with CAP, cap) into the log2 domain in f32
// (log2_score), add the bias, floor
// at the mask value (a bias at the mask value times log2 e would overflow to
// -inf, and a tile of -inf only would make the rescale NaN), and with MASKED
// (a tile over the KV tail or causal's diagonal) set the tail and causal's
// upper triangle to the mask value; then the online max and sum. The bias of
// column 8jj + 2t of row g is at shared address b_addr ^ 32jj (bias_slot's
// permutation: b_addr has bits 5-6 = row % 4 and bits 3-4 = t), row g + 8's
// b_step bytes on (0 for a row-broadcast bias). Returns the rescale factor of
// the earlier tiles' O in alpha.
template <bool MASKED, bool CAP>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint32_t b_addr, uint32_t b_step,
                                             int n0, int t, int row0, int nkv, bool causal,
                                             float scale_log2, float cap_scale, float cap_log2,
                                             float (&m_i)[2], float (&l_i)[2],
                                             float (&alpha)[2]) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int jj = 0; jj < FB_BLOCK_N / 8; ++jj) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 bv = lds_f2((b_addr ^ (32 * jj)) + r * b_step);
      const float bias2[2] = {bv.x, bv.y};  // K1 bias sm90 read
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * r + e;
        float x;
        if constexpr (CAP) {
          x = log2_score<CAP>(sc[i], scale_log2, cap_scale, cap_log2);  // K1 bias sm90 cap
          x = fmaxf(x + bias2[e] * LOG2E, MASK_VALUE);
        } else {
          x = fmaxf(sc[i] * scale_log2 + bias2[e] * LOG2E, MASK_VALUE);
        }
        if (MASKED) {
          const int col = n0 + 8 * jj + 2 * t + e;
          if (col >= nkv || (causal && col > row0 + 8 * r)) x = MASK_VALUE;
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
    alpha[r] = ex2(m_i[r] - mx[r]);
    m_i[r] = mx[r];
    l_i[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pe = ex2(sc[i] - m_i[(i >> 1) & 1]);
    l_i[(i >> 1) & 1] += pe;
    sc[i] = pe;
  }
}

// The dense route's softmax of one tile, sc[4jj + 2r + e] being row row0 +
// 8r, column col0 + 8jj + 2t + e (absolute positions): scale (with CAP, cap)
// into the log2 domain in f32 (log2_score) and, with MASKED (a tile that the band, the KV tail or, with
// SEG, a document edge cuts), set to the mask value the pairs outside the
// band, the columns at or past nkv and, with SEG, the pairs whose ids differ
// (ids: the tile's 64 key ids in shared memory, q_seg the rows'); then the
// online max and sum. Returns the rescale factor of the earlier tiles' O in
// alpha. ACCURATE (K1's f32 route, flash_fwd_f32.cu) takes the exponentials
// by exp2f: FWD_TOL[f32] leaves no room for ex2.approx.
template <bool MASKED, bool SEG, bool CAP, bool ACCURATE = false>
__device__ __forceinline__ void dense_softmax_tile(float (&sc)[32], int col0, int row0, int t,
                                                   int lo, int hi, int nkv, const int* ids,
                                                   const int (&q_seg)[2], float scale_log2,
                                                   float cap_scale, float cap_log2,
                                                   float (&m_i)[2], float (&l_i)[2],
                                                   float (&alpha)[2]) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int jj = 0; jj < FB_BLOCK_N / 8; ++jj) {
    int2 kv_seg = make_int2(0, 0);
    if (SEG && MASKED) kv_seg = *reinterpret_cast<const int2*>(ids + 8 * jj + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * r + e;
        float x = log2_score<CAP>(sc[i], scale_log2, cap_scale, cap_log2);
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

// The body of both families: BIAS, the bias route (Params FwdBiasParams,
// SEG false); else the dense route (Params FwdDenseParams), SEG with
// segment ids; CAP, in both, the logit softcap.
template <int D, bool BIAS, bool SEG, bool CAP, typename Params>
__device__ __forceinline__ void fwd_sm90_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                              const CUtensorMap& tm_v, const Params& p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  static_assert(!(BIAS && SEG), "the bias route takes no segment ids");
  using S = FbSmem<D, BIAS>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S::STAGES;

  const int h = blockIdx.x;
  int m_tile;
  if constexpr (BIAS) {
    // Causal: heavy (late) Q tiles first, so the tail of the grid is short.
    m_tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  } else {
    // A right bound (causal): the late Q tiles meet the most KV tiles.
    m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  }
  const int m0 = m_tile * FB_BLOCK_M;
  const int b = blockIdx.z;
  const int nkv = p.kv_valid_len;
  // The KV tiles from n_begin that meet the CTA's rows: causal, only those
  // whose first column is <= the CTA's last row; with a band, those that meet
  // columns [m0 - lo, m0 + 127 + hi].
  int n_begin = 0;
  int n_end;
  if constexpr (BIAS) {
    n_end = p.causal ? min(nkv, m0 + FB_BLOCK_M) : nkv;
  } else {
    if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / FB_BLOCK_N * FB_BLOCK_N;
    n_end = p.hi < NO_BOUND ? min(nkv, m0 + FB_BLOCK_M + p.hi) : nkv;
  }
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + FB_BLOCK_N - 1) / FB_BLOCK_N : 0;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::Q + (j % S::STAGES) * S::STAGE; };
  // SEG: the Q tile's id range, and whether KV tile j (from n_begin) holds a
  // key of it. Every thread reads the same ranges, so the producer and both
  // consumer warpgroups walk the same tiles.
  int2 q_rng = make_int2(0, 0);
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m_tile];
  const int t_begin = n_begin / FB_BLOCK_N;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      // BIAS: the TMA thread's expect_tx, each producer's cp.async.
      mbar_init(&full[s], BIAS ? 1 + 128 : 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
    if constexpr (BIAS) {
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
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S::STAGES;
        const int n0 = j * FB_BLOCK_N;
        unsigned char* st = stage(j);
        mbar_wait(&empty[s], ((j / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        if (tid == 0) {
          mbar_expect_tx(&full[s], 2 * S::KV);
#pragma unroll
          for (int x = 0; x < BOXES; ++x) {
            tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
            tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0,
                        hk, b);
          }
        }
        const int col_bytes = 4 * min(max(nkv - n0 - 4 * c, 0), 4);
        float* dst = reinterpret_cast<float*>(st + 2 * S::KV) + bias_slot(r0, c);
        if (bias_rows == 1) {
          if (r0 == 0) cp_async_16_zfill(dst, col_bytes ? bias_src + n0 : p.bias, col_bytes);
        } else {
#pragma unroll
          for (int i = 0; i < FB_BLOCK_M / 8; ++i) {
            const int bytes = r0 + 8 * i < rows_valid ? col_bytes : 0;
            cp_async_16_zfill(dst + 8 * i * FB_BLOCK_N,
                              bytes ? bias_src + n0 + i * src_step : p.bias, bytes);
          }
        }
        cp_async_mbar_arrive(&full[s]);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (tid == 0) {
      // Producer: thread 0 issues every copy, over the tiles the consumers
      // visit (SEG: those whose id range meets the Q tile's).
      mbar_expect_tx(q_full, S::Q);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * FB_BLOCK_M * FB_BOX_ROW, &tm_q, q_full, 64 * x, m0, h, b);
      }
      int it = 0;  // tiles issued
      for (int j = 0; j < n_tiles; ++j) {
        if constexpr (SEG) {
          if (!ranges_meet(q_rng, kv_tile_range(p, b, t_begin + j))) continue;
        }
        const int s = it % S::STAGES;
        const int n0 = n_begin + j * FB_BLOCK_N;
        unsigned char* st = stage(it);
        mbar_wait(&empty[s], ((it / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::KV + (SEG ? FB_BLOCK_N * 4 : 0));
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
          tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0, hk,
                      b);
        }
        if constexpr (SEG) {
          bulk_load(smem + S::SEG + s * FB_BLOCK_N * 4,
                    p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * FB_BLOCK_N + n0,
                    FB_BLOCK_N * 4, &full[s]);
        }
        ++it;
      }
    }
  } else {
    // Consumers: warpgroup 1 owns rows m0..m0+63, warpgroup 2 rows m0+64..m0+127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
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
    if constexpr (BIAS) {
      // Causal: the tiles that meet this warpgroup's rows (the rest, past its
      // diagonal, are released unread).
      const int n_mine = p.causal ? min(n_tiles, (r_first + 64 + FB_BLOCK_N - 1) / FB_BLOCK_N)
                                  : n_tiles;
      // This thread's bias: its row of the tile (row 0 of a row-broadcast
      // bias), chunk 2jj + t / 2 at bias_slot's place (softmax_tile).
      const int b_row = p.bias_sn ? tr : 0;
      const uint32_t b_off = 4 * (b_row * FB_BLOCK_N + 8 * (b_row & 3) + 2 * t);
      const uint32_t b_step = p.bias_sn ? 4 * 8 * FB_BLOCK_N : 0;
      auto bias_of = [&](int j) { return smem_u32(stage(j) + 2 * S::KV) + b_off; };
      auto masked = [&](int j) {
        return j * FB_BLOCK_N + FB_BLOCK_N > nkv ||
               (p.causal && j * FB_BLOCK_N + FB_BLOCK_N - 1 > r_first);
      };
      mbar_wait(q_full, 0);
      for (int j = 0; j < n_mine; ++j) {
        mbar_wait(&full[j % S::STAGES], (j / S::STAGES) & 1);
        issue_qk<D, FB_BLOCK_M, FB_BLOCK_N>(sc, q_s, stage(j));
        wgmma_wait<0>();
        fence_regs(sc);
        if (masked(j)) {
          softmax_tile<true, CAP>(sc, bias_of(j), b_step, j * FB_BLOCK_N, t, row0, nkv,
                                  p.causal, p.scale_log2, p.cap_scale, p.cap_log2, m_i, l_i,
                                  alpha);
        } else {
          softmax_tile<false, CAP>(sc, bias_of(j), b_step, j * FB_BLOCK_N, t, row0, nkv,
                                   p.causal, p.scale_log2, p.cap_scale, p.cap_log2, m_i, l_i,
                                   alpha);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p(pa, sc);
        issue_pv<D, FB_BLOCK_N>(o, pa, stage(j) + S::KV);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        release(j);
      }
      for (int j = n_mine; j < n_tiles; ++j) {
        mbar_wait(&full[j % S::STAGES], (j / S::STAGES) & 1);
        release(j);
      }
    } else {
      // SEG: the ids of rows g and g + 8 (rows past Nq are never stored).
      int q_seg[2] = {0, 0};
      if constexpr (SEG) {
        const int* q_ids = p.seg_q + b * p.seg_q_sb;
        q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
        q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
      }
      const bool q_one_doc = q_rng.x == q_rng.y;
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
          wgmma_wait<0>();
          fence_regs(sc);
          const bool edge = c0 + FB_BLOCK_N > nkv || c0 + FB_BLOCK_N - 1 - r_first > p.hi ||
                            r_first + 63 - c0 > p.lo ||
                            (SEG && !(q_one_doc && k_rng.x == k_rng.y && k_rng.x == q_rng.x));
          const int* ids = reinterpret_cast<const int*>(smem + S::SEG + s * FB_BLOCK_N * 4);
          if (edge) {
            dense_softmax_tile<true, SEG, CAP>(sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg,
                                               p.scale_log2, p.cap_scale, p.cap_log2, m_i, l_i,
                                               alpha);
          } else {
            dense_softmax_tile<false, SEG, CAP>(sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg,
                                                p.scale_log2, p.cap_scale, p.cap_log2, m_i, l_i,
                                                alpha);
          }
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          pack_p(pa, sc);
          issue_pv<D, FB_BLOCK_N>(o, pa, stage(it) + S::KV);
          wgmma_wait<0>();
          fence_regs(o);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        }
        release(it);
        ++it;
      }
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
