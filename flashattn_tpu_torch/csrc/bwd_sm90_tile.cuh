// The single-pass TMA + wgmma attention backward for Hopper (sm_90a), KV-major:
// the body of K3 (flash_bwd_sm90.cu), of K5 + K6's bias route
// (bwd_bias_sm90.cu) and of K5 + K6 without a bias (flash_bwd_split_sm90.cu:
// segment ids, the logit softcap), one launch writing dQ, dK, dV and, with a
// bias that needs a gradient, dbias. K8's design (ring_bwd.cu,
// FlashAttention-3's backward); each source's header says what its family
// replaces and what bounds it.
//
// With the forward's LSE (natural log; ln2 * mask on a dead row) and Delta =
// rowsum(dO * O) it computes, for each (query row i, key j) that attends,
//   x = S scale log2 e (+ bias log2 e, floored at the mask value, as K1's
//       bias route forms it: fwd_sm90_tile.cuh), S = Q K^T on the unscaled Q;
//   P = exp2(x - LSE log2 e), exactly 0 on keys at or past kv_valid_len, on
//       rows past Nq, outside the band (K1's, row i sees column j iff i - lo
//       <= j <= i + hi: causal, a window, q / kv offsets) and on a dead row
//       (LSE log2 e <= mask / 2);
//   dL = P (dP - Delta), dP = dO V^T;  dS = dL scale;
//   with the softcap (CAP): x = cap log2 e t (+ bias log2 e, floored as
//       above), t = tanh(S scale / cap), and dS = dL (1 - t^2) scale (the
//       JAX kernel's, flash_bwd.py:92-98, :220); dbias is still dL, the
//       gradient of the capped logit, taken before the Jacobian
//       (flash_bwd.py:300-304);
//   with segment ids (SEG): P exactly 0 on a pair whose ids differ;
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,  dbias = dL (f32, before scale:
//       the JAX kernel's, flashattn_tpu/ops/flash_bwd.py:97-98, :135, :300-302).
// dQ and dK each carry `scale` exactly once. dQ is added into a zeroed f32 dQ.
//
//   * One CTA owns 128 KV rows (2 consumer warpgroups of 64) of one (batch,
//     owner): warpgroup 0 is the producer (one thread issues every copy;
//     setmaxnreg gives its registers away), warpgroups 1 and 2 the
//     consumers, their f32 dK and dV tiles in registers across the owner's
//     query heads and every Q tile of 64 rows that the band leaves. The
//     owner is a KV head with the bias (its rep query heads, dK / dV per KV
//     head) and, without, one query head (dK / dV per query head, which the
//     caller sums over each KV head's group -- twice the CTAs for GQA, so a
//     causal grid does not wait on its first KV tile's CTAs).
//   * K and V come once by TMA (sequence extent kv_valid_len: zeros past it,
//     so a key the forward never read cannot put a NaN into dQ); the (Q, dO)
//     tiles of 64 query rows, with their LSE and Delta (bulk copies from rows
//     the caller pads to a multiple of 64), stream through a 2-stage
//     full / empty mbarrier ring. Maps past D read zeros (D 40 and 80 run
//     as 64 and 128, every family).
//   * Per consumer and Q tile, K8's order: S^T = K Q^T by wgmma from shared
//     memory; P^T in registers, rounded at once to bf16 (dV's A) and fp16
//     (for dS^T: bf16's 7 mantissa bits put dQ / dK 40% further off in K8;
//     with CAP it holds P^T (1 - t^2), which is all dS^T needs, so the
//     Jacobian takes no register beyond the pair in flight; with CAP and
//     DBIAS a second fp16 copy holds P^T itself, for dbias = dL^T before the
//     Jacobian);
//     then dP^T = V dO^T and dV += P^T dO (A from registers) together;
//     dL^T = P^T (dP^T - Delta) (stored as dbias from the accumulator
//     fragments with DBIAS), dS^T = dL^T scale; dK += dS^T Q.
//   * dQ = dS K by wgmma from the double-buffered bf16 dS^T in shared memory
//     (M-major A) against K (N-major B), each consumer for 64 of D's
//     columns, staged as f32 [64][d] (exactly d columns, so a padded column
//     never reaches dQ) and added to dQ by ONE
//     cp.reduce.async.bulk per tile of the tile's q_rows * d * 4 bytes: dQ is
//     [B, Hq, Nq, d] contiguous, so a full 64 rows on the last, partial Q
//     tile, or a row of D > d columns, would add into the next rows.
//   * With the bias (BIAS): the bias tile, 64 query rows x 128 keys of f32
//     (32 KB), comes by TMA too, as 4 boxes of 32 columns with the 128-byte
//     swizzle: a broadcast dim of the bias is a dim of extent 1 in its map
//     (coordinate 0), which TMA takes where it would refuse a zero stride,
//     and a row-broadcast [B, H, 1, Nk] bias is one row a box. Columns past
//     kv_valid_len and rows past Nq read zeros. The swizzle puts 16-byte
//     chunk c of row r at c ^ (r % 8), so the 4 query rows a consumer warp
//     reads at once (2t + e) land on 4 distinct pairs of chunks: 32 banks, no
//     conflict. Shared memory at D 128: K, V 64 KB; 2 x (Q, dO) 64 KB; dS^T
//     2 x 16 KB; the dQ stage 32 KB; one bias stage 32 KB: 226 KB of the 227.
//     So the bias has one stage of its own (two at D 64, where everything
//     else halves), on its own full / empty barriers: each consumer warp
//     releases it as soon as P^T is formed, and the producer refills it with
//     the next tile's bias while dP^T, dV, dK and dQ of this tile run. dbias
//     is stored from the dL^T fragments (8 lanes write 32 contiguous bytes of
//     one dbias row: whole sectors, streaming stores).
//   * With segment ids (SEG, flash_bwd_split_sm90.cu): the wrapper gives each
//     Q tile's (64 rows) and each KV tile's (128 keys) [min, max] id, as the
//     forward's dense route takes them (ops/flash_fwd.py::sm90_segments). Warp
//     0 compacts, once, the Q tiles of the band whose range meets the CTA's
//     KV tile's into a list in shared memory (the room the bias stage takes
//     in the BIAS family), each marked when both tiles are one single
//     document; producer and consumers walk that one list. The KV tile's 128
//     ids come with K and V, each Q tile's 64 (the wrapper pads the rows to
//     whole tiles) by a bulk copy on the stage's barrier; pairs are tested
//     per id only on tiles that a document edge cuts. An empty list leaves
//     the tile's dK / dV rows zero, as a tile past kv_valid_len.
//   * With segment ids and the bias (BIAS and SEG, bwd_bias_sm90.cu): at D
//     128 the family leaves 968 B of shared memory, which holds neither the
//     list (16 KB) nor the KV tile's ids beside two stages' Q ids (1 KB).
//     So the KV tile's ids go to registers (each consumer thread reads its
//     two rows' ids from global memory once: they are fixed for the CTA),
//     each stage's 64 Q ids come by the bulk copy on the stage's barrier
//     (512 B for two stages), and the producer and the consumers each test
//     every (query head, Q tile) pair of the band against the KV tile's id
//     range as they walk them -- the ranges every thread reads, so all walk
//     the same pairs -- in place of a list.

#pragma once

#include "sm90.cuh"

namespace {

using namespace fa;

constexpr int BB_BLOCK_N = 128;  // KV rows per CTA: two consumer warpgroups of 64
constexpr int BB_BLOCK_M = 64;   // query rows per streamed tile
constexpr int BB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int BB_BIAS_BOX = 32;  // f32 columns per bias box: the 128-byte swizzle's span
constexpr float NEG_GUARD = 0.5f * MASK_VALUE;
constexpr int BB_SEG_LIST = 4096;  // SEG: the most Q tiles one CTA can visit (Nq <= 262144)

// K3's parameters (the family without a bias).
struct BwdDenseParams {
  const float* lse;    // [B, Hq, nq_pad] f32, natural log (ln2 * mask: a dead row)
  const float* delta;  // [B, Hq, nq_pad] f32
  float* dq;           // [B, Hq, Nq, d] f32 contiguous, zeroed
  float* dk;           // [B, Hq, Nk, d] f32 contiguous, written
  float* dv;
  int hq, rep, nq, nq_pad, nk, kv_valid_len, d;
  int lo, hi;          // band: row - lo <= col <= row + hi (NO_BOUND: none)
  float scale, scale_log2;
};

// K5 + K6 without a bias: K3's, the segment ids (SEG) and the softcap (CAP).
struct BwdSplitParams : BwdDenseParams {
  const int* seg_q;      // [B, q_tiles * 64] ids, contiguous, rows padded to whole tiles
  const int* seg_kv;     // [B, kv_tiles * 128] ids, contiguous, rows padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 64-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) of each 128-key tile's keys below kv_valid_len
  int q_tiles, kv_tiles;   // ceil(Nq / 64), ceil(kv_valid_len / 128)
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
};

// K5 + K6's bias route: the split route's (dk / dv [B, Hkv, Nk, d] per KV
// head) and the bias.
struct BwdBiasParams : BwdSplitParams {
  float* dbias;        // [B, Hq, Nq, Nk] f32 contiguous (the DBIAS instantiations)
  int bias_rows;       // rows of a bias box: 64, or 1 for a row-broadcast bias
  int bias_b, bias_h;  // whether the bias has the batch / head dim (else: coordinate 0)
};

// Shared-memory layout (bytes, from a 1024-byte-aligned base): K and V (D /
// 64 boxes of 128 rows), 2 stages of (Q, dO) (D / 64 boxes of 64 rows each),
// 2 dS^T buffers (128 KV rows x 64 query columns, 128-byte swizzle), the f32
// dQ stage [64][D], with BIAS BSTAGES bias tiles (4 boxes of 64 rows x 32
// f32), with SEG the ids (without BIAS the KV tile's [128]; each stage's Q
// tile's [2][64]; without BIAS the list's length, padded to 16 bytes, and
// the list [BB_SEG_LIST]), the LSE and Delta rows [2][64] each, then the mbarriers
// kv_full, full[2], empty[2] and with BIAS bias_full[BSTAGES],
// bias_empty[BSTAGES].
template <int D, bool BIAS = true, bool SEG = false>
struct BbSmem {
  static constexpr int BSTAGES = BIAS ? (D == 64 ? 2 : 1) : 0;
  static constexpr int KV = BB_BLOCK_N * D * 2;
  static constexpr int QT = BB_BLOCK_M * D * 2;
  static constexpr int STAGE = 2 * QT;
  static constexpr int DST = BB_BLOCK_N * BB_BLOCK_M * 2;
  static constexpr int BIAS_BOX = BB_BLOCK_M * BB_BIAS_BOX * 4;
  static constexpr int BIAS_TILE = BB_BLOCK_M * BB_BLOCK_N * 4;
  static constexpr int OFF_V = KV;
  static constexpr int OFF_STAGE = 2 * KV;
  static constexpr int OFF_DST = OFF_STAGE + 2 * STAGE;
  static constexpr int OFF_DQ = OFF_DST + 2 * DST;
  static constexpr int OFF_BIAS = OFF_DQ + BB_BLOCK_M * D * 4;
  static constexpr int OFF_SEG = OFF_BIAS + BSTAGES * BIAS_TILE;
  static constexpr int SEG_Q = BIAS ? 0 : BB_BLOCK_N * 4;   // offsets in the SEG region
  static constexpr int SEG_COUNT = SEG_Q + 2 * BB_BLOCK_M * 4;
  static constexpr int SEG_LIST = SEG_COUNT + 16;
  static constexpr int SEG_BYTES = !SEG ? 0 : BIAS ? SEG_COUNT : SEG_LIST + BB_SEG_LIST * 4;
  static constexpr int OFF_STATS = OFF_SEG + SEG_BYTES;
  static constexpr int BARS = OFF_STATS + 2 * 2 * BB_BLOCK_M * 4;
  static constexpr int BYTES = 1024 + BARS + (5 + 2 * BSTAGES) * 8;
  static_assert(KV % 1024 == 0 && QT % 1024 == 0 && DST % 1024 == 0 && BIAS_BOX % 1024 == 0 &&
                    OFF_BIAS % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

__device__ __forceinline__ float lds_f1(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The body of every family: BIAS, K5 + K6's bias route (Params
// BwdBiasParams, dbias with DBIAS, segment ids with SEG, the softcap with
// CAP); else K3 (Params BwdDenseParams) or, with SEG and / or CAP, K5 + K6
// without a bias (Params BwdSplitParams); each any head dim p.d up to D, the
// band as runtime ints. p
// comes by value: bound by reference to the kernel's parameter, its fields were
// reloaded in the P^T loop and its masks became branches (+160 SASS
// instructions in each bias-route instantiation, 4.7% slower on path A's
// backward: chip_ab.py).
template <int D, bool BIAS, bool DBIAS, bool SEG = false, bool CAP = false, typename Params>
__device__ __forceinline__ void bwd_sm90_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                              const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                              const CUtensorMap* tm_bias, const Params p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  static_assert(BIAS || !DBIAS, "dbias needs the bias");
  using S = BbSmem<D, BIAS, SEG>;
  constexpr int BOXES = D / 64;
  constexpr int BST = BIAS ? S::BSTAGES : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + 2;
  uint64_t* bias_full = empty + 2;
  uint64_t* bias_empty = bias_full + BST;
  float* s_stats = reinterpret_cast<float*>(smem + S::OFF_STATS);  // lse[2][64], delta[2][64]
  // SEG: the KV tile's ids, the stages' Q ids, the list of Q tiles (2 * tile
  // + whether both tiles are one document) and its length (the stages' Q ids
  // alone with BIAS).
  int* seg_kv_s = reinterpret_cast<int*>(smem + S::OFF_SEG);
  int* seg_q_s = reinterpret_cast<int*>(smem + S::OFF_SEG + S::SEG_Q);
  int* seg_count = reinterpret_cast<int*>(smem + S::OFF_SEG + S::SEG_COUNT);
  int* seg_list = reinterpret_cast<int*>(smem + S::OFF_SEG + S::SEG_LIST);

  // The CTA's owner (BIAS: its KV head hk, the query heads hk * rep + hr;
  // else the query head h0 of KV head hk), its KV tile n0 and the Q tiles
  // from m_begin (n_m of them) that meet the tile's band; none when the tile
  // lies past kv_valid_len -- its dK / dV rows are then zeros.
  int hk, h0, heads;
  if constexpr (BIAS) {
    hk = blockIdx.x;
    h0 = hk * p.rep;
    heads = p.rep;
  } else {
    h0 = blockIdx.x;
    hk = h0 / p.rep;
    heads = 1;
  }
  // A left bound alone: the late KV tiles meet the most Q tiles; run them
  // first (causal's first tiles are its longest already).
  const int n_tile =
      p.lo < NO_BOUND && p.hi >= NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int n0 = n_tile * BB_BLOCK_N;  // first KV row of the tile
  // Rows [n0 - hi, n0 + 127 + lo] meet the tile's columns.
  const int m_begin = p.hi < NO_BOUND ? max(0, n0 - p.hi) / BB_BLOCK_M * BB_BLOCK_M : 0;
  const int m_end = p.lo < NO_BOUND ? min(p.nq, n0 + BB_BLOCK_N + p.lo) : p.nq;
  const int n_m = n0 < p.kv_valid_len && m_end > m_begin
                      ? (m_end - m_begin + BB_BLOCK_M - 1) / BB_BLOCK_M
                      : 0;
  // SEG: the KV tile's id range.
  int2 k_rng = make_int2(0, 0);
  if constexpr (SEG) {
    if (n_m > 0) k_rng = p.kv_range[blockIdx.z * p.kv_tiles + n_tile];
  }
  if constexpr (SEG && !BIAS) {
    // Warp 0 keeps the band's Q tiles whose id range meets the KV tile's,
    // in order, 32 a ballot; the barrier below publishes the list.
    if (n_m > 0 && threadIdx.x < 32) {
      const int t0 = m_begin / BB_BLOCK_M;
      int n = 0;
      for (int c = 0; c < n_m; c += 32) {
        const int i = c + threadIdx.x;
        bool meet = false, one = false;
        if (i < n_m) {
          const int2 q_rng = p.q_range[blockIdx.z * p.q_tiles + t0 + i];  // bwd seg tile range
          meet = ranges_meet(q_rng, k_rng);
          one = q_rng.x == q_rng.y && k_rng.x == k_rng.y && q_rng.x == k_rng.x;
        }
        const unsigned kept = __ballot_sync(0xffffffffu, meet);
        if (meet) seg_list[n + __popc(kept & ((1u << threadIdx.x) - 1))] = 2 * (t0 + i) + one;
        n += __popc(kept);
      }
      if (threadIdx.x == 0) *seg_count = n;  // bwd seg list length
    }
  }
  const int b = blockIdx.z;
  int total = heads * n_m;  // (query head, Q tile) pairs, head-major
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::OFF_STAGE + (j & 1) * S::STAGE; };
  auto bias_tile = [&](int j) { return smem + S::OFF_BIAS + (j % BST) * S::BIAS_TILE; };
  // Pair i of the walk: its query head h0 + hr, its Q tile's first row m0,
  // whether the Q tile and the KV tile are one single document (SEG), and
  // whether the pair is visited (SEG with BIAS: its Q tile's id range meets
  // the KV tile's); j, the visits before it, numbers the stages.
  auto pair_of = [&](int i, int& hr, int& m0, bool& one_doc) {
    one_doc = false;
    if constexpr (SEG && !BIAS) {
      const int entry = seg_list[i];
      hr = 0;
      m0 = (entry >> 1) * BB_BLOCK_M;
      one_doc = entry & 1;
      return true;
    } else {
      hr = i / n_m;
      m0 = m_begin + (i - hr * n_m) * BB_BLOCK_M;
      if constexpr (SEG) {
        const int2 q_rng = p.q_range[blockIdx.z * p.q_tiles + m0 / BB_BLOCK_M];
        one_doc = q_rng.x == q_rng.y && k_rng.x == k_rng.y && q_rng.x == k_rng.x;
        return ranges_meet(q_rng, k_rng);  // bias bwd seg tile range
      }
      return true;
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    if constexpr (BIAS) {
      for (int s = 0; s < BST; ++s) {
        mbar_init(&bias_full[s], 1);
        mbar_init(&bias_empty[s], 8);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (SEG && !BIAS) total = total > 0 ? *seg_count : 0;  // the listed Q tiles

  if (wg == 0) {
    // Producer: thread 0 issues the copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && total > 0) {
      mbar_expect_tx(kv_full, 2 * S::KV + (SEG && !BIAS ? BB_BLOCK_N * 4 : 0));
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * BB_BLOCK_N * SW128_ROW, &tm_k, kv_full, 64 * x, n0, hk, b);
        tma_load_4d(smem + S::OFF_V + x * BB_BLOCK_N * SW128_ROW, &tm_v, kv_full, 64 * x, n0,
                    hk, b);
      }
      if constexpr (SEG && !BIAS) {
        bulk_load(seg_kv_s, p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * BB_BLOCK_N + n0,
                  BB_BLOCK_N * 4, kv_full);
      }
      uint32_t bias_bytes = 0;
      if constexpr (BIAS) bias_bytes = BB_BLOCK_N / BB_BIAS_BOX * p.bias_rows * SW128_ROW;
      int j = 0;  // pairs visited
      for (int i = 0; i < total; ++i) {
        int hr, m0;
        bool one_doc;
        if (!pair_of(i, hr, m0, one_doc)) continue;
        const int s = j & 1;
        const int h = h0 + hr;
        unsigned char* st = stage(j);
        mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::QT + 2 * BB_BLOCK_M * 4 + (SEG ? BB_BLOCK_M * 4 : 0));
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * BB_BLOCK_M * SW128_ROW, &tm_q, &full[s], 64 * x, m0, h, b);
          tma_load_4d(st + S::QT + x * BB_BLOCK_M * SW128_ROW, &tm_do, &full[s], 64 * x, m0, h,
                      b);
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.nq_pad + m0;
        bulk_load(s_stats + s * BB_BLOCK_M, p.lse + row, BB_BLOCK_M * 4, &full[s]);
        bulk_load(s_stats + (2 + s) * BB_BLOCK_M, p.delta + row, BB_BLOCK_M * 4, &full[s]);
        if constexpr (SEG) {
          bulk_load(seg_q_s + s * BB_BLOCK_M,
                    p.seg_q + static_cast<int64_t>(b) * p.q_tiles * BB_BLOCK_M + m0,
                    BB_BLOCK_M * 4, &full[s]);
        }
        if constexpr (BIAS) {
          const int bs = j % BST;
          mbar_wait(&bias_empty[bs], ((j / BST) & 1) ^ 1);
          mbar_expect_tx(&bias_full[bs], bias_bytes);
          unsigned char* bt = bias_tile(j);
#pragma unroll
          for (int x = 0; x < BB_BLOCK_N / BB_BIAS_BOX; ++x) {
            tma_load_4d(bt + x * S::BIAS_BOX, tm_bias, &bias_full[bs], n0 + BB_BIAS_BOX * x,
                        p.bias_rows == 1 ? 0 : m0, p.bias_h ? h : 0, p.bias_b ? b : 0);
          }
        }
        ++j;
      }
    }
  } else {
    // Consumers: warpgroup 1 owns the tile's KV rows 0..63, warpgroup 2 64..127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int half = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int cw = n0 + half * 64;       // first KV row of this warpgroup
    const int kv0 = cw + warp * 16 + g;  // KV row of this thread's row g
    const unsigned char* k_s = smem + half * 64 * SW128_ROW;
    const unsigned char* v_s = smem + S::OFF_V + half * 64 * SW128_ROW;
    float* dq_stage = reinterpret_cast<float*>(smem + S::OFF_DQ);
    // The thread that issues the dQ reductions (warp 0 of warpgroup 1).
    const bool issuer_warp = half == 0 && warp == 0;
    const bool issuer = issuer_warp && lane == 0;
    const bool does_dq = half < BOXES;  // this warpgroup's 64 columns of dQ
    // d: the columns of dQ / dK / dV, p.d <= D (the boxes read zeros past it).
    const int d = p.d;

    // The bias of S^T's element (KV row g + 8r, query column 8jj + 2t + e) in
    // the swizzled tile: box (its KV column) / 32, row 8jj + 2t + e (row 0
    // of a row-broadcast bias), chunk c ^ (row % 8) with row % 8 = 2t + e.
    bool bias_rows = false;
    uint32_t jj_step = 0;
    uint32_t b_off[2][2];
    if constexpr (BIAS) {
      bias_rows = p.bias_rows != 1;
      jj_step = bias_rows ? 8 * SW128_ROW : 0;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = bias_rows ? 2 * t + e : 0;
          const int chunk = (warp & 1) * 4 + (g >> 2) + 2 * r;
          b_off[r][e] = (half * 2 + (warp >> 1)) * S::BIAS_BOX + row * SW128_ROW +
                        ((chunk ^ row) << 4) + (g & 3) * 4;  // bias bwd column
        }
      }
    }

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (total > 0) mbar_wait(kv_full, 0);
    // SEG: the ids of this thread's KV rows kv0 and kv0 + 8 (with BIAS from
    // global memory: the wrapper pads seg_kv's rows to whole tiles).
    int kv_seg[2] = {0, 0};
    if constexpr (SEG) {
      if (total > 0) {
        if constexpr (BIAS) {
          const int* ids = p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * BB_BLOCK_N + kv0;
          kv_seg[0] = ids[0];  // bias bwd seg ids
          kv_seg[1] = ids[8];
        } else {
          kv_seg[0] = seg_kv_s[kv0 - n0];
          kv_seg[1] = seg_kv_s[kv0 - n0 + 8];
        }
      }
    }
    int j = 0;  // pairs visited
    for (int i = 0; i < total; ++i) {
      int hr, m0;
      bool one_doc;  // SEG: the Q tile and the KV tile are one single document
      if (!pair_of(i, hr, m0, one_doc)) continue;
      const int s = j & 1;
      const int h = h0 + hr;
      const unsigned char* q_st = stage(j);
      const unsigned char* do_st = q_st + S::QT;
      mbar_wait(&full[s], (j >> 1) & 1);

      // S^T = K Q^T: rows are this warpgroup's KV rows, columns the tile's
      // 64 query rows.
      float sc[32], dp[32];
      issue_qk<D, BB_BLOCK_N, BB_BLOCK_M>(sc, k_s, q_st);
      const int bs = j % BST;
      if constexpr (BIAS) mbar_wait(&bias_full[bs], (j / BST) & 1);
      wgmma_wait<0>();
      fence_regs(sc);

      // P^T: sc[4jj + 2r + e] is KV row kv0 + 8r, query row m0 + 8jj + 2t + e;
      // a dead row's LSE becomes +inf (P = 0 exactly). Edge tiles: those that
      // the tails or the band cut for this warpgroup's rows.
      const bool edge = m0 + BB_BLOCK_M > p.nq || cw + 64 > p.kv_valid_len ||
                        cw + 63 - m0 > p.hi || m0 + 63 - cw > p.lo;
      const uint32_t lse_addr = smem_u32(s_stats + s * BB_BLOCK_M + 2 * t);
      const uint32_t dlt_addr = smem_u32(s_stats + (2 + s) * BB_BLOCK_M + 2 * t);
      const uint32_t bias_addr = smem_u32(bias_tile(j));
      const int* q_ids = seg_q_s + s * BB_BLOCK_M + 2 * t;  // SEG: this thread's query ids
      // P^T in fp16 for dS^T; with CAP formed in the loop as P^T (1 - t^2).
      uint32_t ph[16];
      // CAP with DBIAS: P^T in fp16 as well, for dbias = dL^T (before the Jacobian).
      uint32_t pl[CAP && DBIAS ? 16 : 1];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 lv = lds_f2(lse_addr + 32 * jj);
        float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l2[e] = l2[e] <= NEG_GUARD ? INFINITY : l2[e];  // bias bwd dead row
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float jac[2];  // CAP: 1 - t^2 of the pair
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * r + e;
            float x;
            if constexpr (CAP) {
              // The forward's accurate tanhf (fwd_sm90_tile.cuh), not tanh.approx.
              const float tc = tanhf(sc[i] * p.cap_scale);
              x = p.cap_log2 * tc;
              jac[e] = 1.f - tc * tc;  // bwd softcap jacobian
            } else {
              x = sc[i] * p.scale_log2;
            }
            if constexpr (BIAS) {
              const float bv = lds_f1(bias_addr + b_off[r][e] + jj * jj_step);
              x = fmaxf(x + bv * LOG2E, MASK_VALUE);
            }
            float pe = ex2(x - l2[e]);
            if (edge) {
              const int col = kv0 + 8 * r;
              const int row = m0 + 8 * jj + 2 * t + e;
              if (row >= p.nq || col >= p.kv_valid_len || col - row > p.hi ||
                  row - col > p.lo) {  // K3 band mask
                pe = 0.f;
              }
            }
            sc[i] = pe;
          }
          if constexpr (CAP) {
            ph[2 * jj + r] =
                pack_half(sc[4 * jj + 2 * r] * jac[0], sc[4 * jj + 2 * r + 1] * jac[1]);
          }
        }
      }
      if constexpr (SEG) {
        // A document edge cuts the tiles: P^T = 0 (and, with CAP, its half
        // in ph) on the pairs whose ids differ, two query ids a load.
        if (!one_doc) {  // bwd seg edge
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int2 qi = *reinterpret_cast<const int2*>(q_ids + 8 * jj);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (qi.x != kv_seg[r]) {  // bwd seg pair mask
                sc[4 * jj + 2 * r] = 0.f;
                if constexpr (CAP) ph[2 * jj + r] &= 0xffff0000u;
              }
              if (qi.y != kv_seg[r]) {
                sc[4 * jj + 2 * r + 1] = 0.f;
                if constexpr (CAP) ph[2 * jj + r] &= 0x0000ffffu;
              }
            }
          }
        }
      }
      if constexpr (BIAS) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&bias_empty[bs]);  // this warp is done with the bias tile
      }

      // P^T in bf16 (the A fragments of dV's product) and in fp16 (for dS^T)
      // before dP^T = V dO^T is issued, as K8 orders them.
      uint32_t pa[4][4], da[4][4];
      pack_p(pa, sc);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if constexpr (!CAP) ph[i] = pack_half(sc[2 * i], sc[2 * i + 1]);
        if constexpr (CAP && DBIAS) pl[i] = pack_half(sc[2 * i], sc[2 * i + 1]);
      }
      issue_qk<D, BB_BLOCK_N, BB_BLOCK_M>(dp, v_s, do_st);
      issue_pv<D, BB_BLOCK_M>(dv, pa, do_st);
      wgmma_wait<1>();  // dP^T has retired
      fence_regs(dp);
      // dL^T = P^T (dP^T - Delta) is dbias; dS^T = dL^T scale in place of
      // dP^T (with CAP, ph's P^T (1 - t^2) makes it dL^T (1 - t^2) scale,
      // and dbias comes from pl's P^T: the Jacobian is not dbias's).
      // ph[2jj + r] holds row g + 8r, columns 8jj + 2t and + 1.
      float* db_row = nullptr;
      if constexpr (DBIAS) {
        db_row = p.dbias + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m0) * p.nk + kv0;
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pv = unpack_half(ph[2 * jj + r]);
          const float d0 = pv.x * (dp[4 * jj + 2 * r] - dl.x);
          const float d1 = pv.y * (dp[4 * jj + 2 * r + 1] - dl.y);
          if constexpr (DBIAS) {
            float b0 = d0, b1 = d1;
            if constexpr (CAP) {
              const float2 pd = unpack_half(pl[2 * jj + r]);  // bwd cap dbias
              b0 = pd.x * (dp[4 * jj + 2 * r] - dl.x);
              b1 = pd.y * (dp[4 * jj + 2 * r + 1] - dl.y);
            }
            const int row = m0 + 8 * jj + 2 * t;
            if (kv0 + 8 * r < p.nk) {
              float* dst = db_row + (8 * jj + 2 * t) * p.nk + 8 * r;
              if (row < p.nq) __stcs(dst, b0);
              if (row + 1 < p.nq) __stcs(dst + p.nk, b1);
            }
          }
          dp[4 * jj + 2 * r] = d0 * p.scale;
          dp[4 * jj + 2 * r + 1] = d1 * p.scale;
        }
      }
      pack_p(da, dp);

      // dS^T (bf16) into this tile's buffer, rows half * 64 + warp * 16 + g
      // (+ 8), the 128-byte swizzle's chunk order: 16-byte chunk jj of row R
      // at jj ^ (R % 8), R % 8 being g.
      unsigned char* dst = smem + S::OFF_DST + (j & 1) * S::DST;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = half * 64 + warp * 16 + g + 8 * (i & 1);
          const int jj = 2 * kk + (i >> 1);
          *reinterpret_cast<uint32_t*>(dst + row * SW128_ROW + ((jj ^ g) << 4) + 4 * t) =
              da[kk][i];
        }
      }
      fence_proxy_async();
      if (issuer) bulk_wait_read();  // the last tile's reduction has read the dQ stage
      named_sync(1, 256);            // both halves of dS^T written, the dQ stage free
      issue_pv<D, BB_BLOCK_M>(dk, da, q_st);

      // dQ (64 query rows x this warpgroup's 64 columns) = dS K over the
      // tile's 128 KV rows: dS^T as the M-major A, K as the N-major B.
      float dq[32];
      if (does_dq) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BB_BLOCK_N / 16; ++kk) {
          wgmma_ss_tt_m64n64k16(
              dq, smem_desc(dst + kk * 16 * SW128_ROW, BB_BLOCK_N * SW128_ROW, 1024),
              smem_desc(smem + half * BB_BLOCK_N * SW128_ROW + kk * 16 * SW128_ROW,
                        BB_BLOCK_N * SW128_ROW, 1024),
              kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // dV and dK have retired
      } else {
        wgmma_wait<0>();
      }
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with (Q, dO, LSE, Delta)

      if (does_dq) {
        wgmma_wait<0>();
        fence_regs(dq);
        // dq[4jj + 2r + e]: query row warp * 16 + g + 8r, column half * 64 +
        // 8jj + 2t + e, into the stage's row-major [64][d] (dQ's own layout).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* srow = dq_stage + (warp * 16 + g + 8 * r) * d + half * 64;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            if (half * 64 + 8 * jj + 2 * t >= d) continue;  // K3 dQ stage columns
            *reinterpret_cast<float2*>(srow + 8 * jj + 2 * t) =
                make_float2(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
          }
        }
        fence_proxy_async();
      }
      if (issuer_warp) {
        named_sync(2, 256);  // the whole dQ tile is staged
        if (lane == 0) {
          // Only the tile's rows below Nq: dQ is [B, Hq, Nq, d] contiguous, so
          // a full 64 rows on the last tile would add into the next head's.
          const int q_rows = min(BB_BLOCK_M, p.nq - m0);
          bulk_reduce_add_f32(p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m0) * d,
                              dq_stage, q_rows * d * 4);  // bias bwd dQ reduce
          bulk_commit();
        }
      } else {
        named_arrive(2, 256);
      }
      ++j;
    }
    if (issuer) bulk_wait();

    // The tile's dK / dV rows below Nk (zeros past kv_valid_len: P is 0
    // there), the owner's rows of [B, owners, Nk, d].
    int64_t row0;
    if constexpr (BIAS) {
      row0 = (static_cast<int64_t>(b) * (p.hq / p.rep) + hk) * p.nk + kv0;
    } else {
      row0 = (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * p.nk + kv0;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kv0 + 8 * r >= p.nk) continue;
      float* dk_row = p.dk + (row0 + 8 * r) * d;
      float* dv_row = p.dv + (row0 + 8 * r) * d;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (8 * jj + 2 * t >= d) continue;
        *reinterpret_cast<float2*>(dk_row + 8 * jj + 2 * t) =
            make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv_row + 8 * jj + 2 * t) =
            make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

}  // namespace
