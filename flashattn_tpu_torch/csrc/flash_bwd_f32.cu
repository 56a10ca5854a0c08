// The f32 attention backward for Hopper (sm_90a): one body for K3 and for
// K5 + K6 on f32 inputs, with or without a bias, KV-major, one launch writing
// dQ, dK, dV and (on request) dbias to f32 accuracy as the TPU kernels
// compute their f32 calls at Precision.HIGHEST: on bf16 pieces. Kernels
// bwd_f32_kernel<D, SEG, CAP, BIAS> (D 64 and 128, every D <= 128 that is a
// multiple of 8 by the TMA boxes' zero fill; segment ids, the logit softcap
// and the bias as compile-time flags, none being K3's call; dbias a runtime
// null pointer, so it adds no instantiation) and the C entry fa_bwd_f32.
//
// Replaces, on f32 inputs, flashattn_tpu/ops/flash_bwd_fused.py::
// _bwd_fused_kernel (K3, :110) and _bwd_causal_resident_kernel (K4, :336),
// and flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5, :139) with _dq_kernel
// (K6, :234), with the bias (BIAS) as K5 + K6's bias route (bwd_bias_sm90.cu).
// With the forward's LSE (natural log; ln2 * mask on a dead row) and Delta =
// rowsum(dO * O) it computes what bwd_sm90_tile.cuh computes for K3, the
// split route and the bias route, for each (query row i, key j):
//   x = S scale log2 e, S = Q K^T (with the softcap, CAP: x = cap log2 e t,
//       t = tanh(S scale / cap), the accurate tanhf); BIAS: + bias log2 e,
//       in f32 (not split), floored at the mask value, as the forward adds it;
//   P = exp2(x - LSE log2 e) by exp2f, exactly 0 on keys at or past
//       kv_valid_len, on rows past Nq, outside the band (row i sees key j iff
//       i - lo <= j <= i + hi, shifted by q / kv offsets: common.cuh
//       band_bounds), on a pair whose segment ids differ (SEG) and on a dead
//       row (LSE log2 e <= mask / 2);
//   dL = P (dP - Delta), dP = dO V^T;  dS = dL scale (CAP: dL (1 - t^2) scale);
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,  dbias = dL (f32, before the
//       scale and the cap's Jacobian: the JAX kernel's, flash_bwd.py:300-302;
//       written only when the caller passes dbias),
// with dK / dV per query head (the caller sums each KV head's group) and dQ
// added into a zeroed f32 dQ. Every one of the five products is the six bf16
// products a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0 of three-piece
// operands (split_bf16x3.cu: Q, K, V and dO; P^T and dS^T are split in
// registers), summed in f32. The C entry splits Q, K, V and dO in one
// launch before the kernel, into scratch the caller gives.
//
// What bounds it: operations. At the f32 LM's attention (B1 Hq16 Hkv8 N2049
// D128 causal) the five f32 products are 43 GFLOP, six bf16 products each:
// 0.26 ms at 989 / 6 = 165 TFLOP/s, against 60 MB of inputs and outputs
// (0.018 ms at 3.35 TB/s). The body is bwd_sm90_tile.cuh's KV-major scheme on
// pieces, cut to the shared memory three pieces take:
//
//   * One CTA owns 64 keys of one (batch, query head): warpgroup 0 is the
//     producer (one thread issues every copy), warpgroup 1 the consumer, its
//     f32 dK and dV (2 x D / 2 registers a thread) across every Q tile of 32
//     rows that the band leaves (SEG: whose id range meets the KV tile's,
//     from the wrapper's tile ranges; producer and consumer walk the same
//     tiles). Each (query row, key) pair belongs to one CTA, so dbias
//     [B, Hq, Nq, Nk] takes plain stores; the pairs of the Q tiles a CTA
//     skips (the band, the ids) and the keys of the CTAs past kv_valid_len
//     are never written: the wrapper zero-fills dbias for such calls.
//   * Shared memory at D 128: K's and V's pieces for 64 keys, 2 x 3 x 16 KB =
//     96 KB, once by TMA (rows past kv_valid_len read zeros, so a key the
//     forward never read cannot put a NaN into dQ); two stages of (Q, dO)
//     pieces with their LSE, Delta and (SEG) ids, 2 x 48 KB; dS's pieces 12
//     KB; dQ's f32 stage 32 x 128 x 4 = 16 KB: 220 KB of the 227. 128 keys
//     (two consumers) would take 192 KB for K and V alone, and 64-row Q
//     tiles 96 KB a stage.
//   * A Q / dO stage holds the three pieces stacked, rows 32p..32p+31 of a
//     96-row tile. S^T = K Q^T and dP^T = V dO^T are each six chains of
//     wgmma m64n32k16 from shared memory into one accumulator, issued
//     together; P^T is formed while dP^T runs. ptxas 12.9 crashes (exit 139)
//     on this kernel whenever a chain of six products is unrolled -- by 2, 3
//     or 6, at m64n32k16 or m64n64k16, with a fence per product, or as
//     chains of mixed widths sharing one accumulator, which would read
//     shared memory a third less -- and on small changes to the loop form
//     (chip_variants.py f32), so each chain is a loop over the products,
//     and ptxas serializes the wgmma across its iterations (C7520).
//   * BIAS: shared memory has no room for a bias tile (32 rows x 64 keys of
//     f32 is 8 KB; 7 KB are left at D 128 beside two (Q, dO) stages), so
//     each consumer thread reads its 16 values of the tile from global
//     memory (L2) straight into S^T's fragment layout -- query row m + 8jj +
//     2t + e, key 16w + g + 8r: each load instruction covers 8 keys of 4
//     rows, four whole 32-byte sectors -- issued right after S^T and dP^T,
//     so that they land while the products run (chip_variants.py f32bias
//     times this against loads issued after S^T has retired). One (Q, dO)
//     stage to make room would lose the overlap of the next tile's loads,
//     and dS's region is busy with the previous tile's dQ until this
//     tile's loop starts. dbias is stored from the same layout, P^T (dP^T -
//     Delta) taken once dP^T has retired (streaming stores, whole sectors).
//   * P^T and dS^T are split into three bf16 A fragments each (the
//     accumulator layout is the A layout); dV += P^T dO and dK += dS^T Q are
//     six chains of wgmma m64nDk16 with A from registers and the stacked
//     pieces as the N-major B. dS's pieces go to shared memory as [96 rows
//     (piece, query)][64 keys], and dQ^T = K^T dS^T is computed per 64 of D's
//     columns as S^T is, K's box the M-major A and dS's pieces the K-major B
//     (a 32-row dQ tile is below wgmma's 64 rows; its transpose is not); it
//     is staged as f32 [32][d] (exactly d columns) and added to dQ
//     by ONE cp.reduce.async.bulk per tile, for the tile's rows below Nq only
//     (dQ is [B, Hq, Nq, d] contiguous: a full tile on the last, partial Q
//     tile, or a row of D > d columns, would add into the next rows). dQ's
//     sums therefore vary in their last bits from run to run.

#include "sm90.cuh"
#include "split_bf16x3.cuh"

namespace fa {

struct BwdF32Params {
  const float* lse;      // [B, Hq, nq_pad] f32, natural log (ln2 * mask: a dead row)
  const float* delta;    // [B, Hq, nq_pad] f32
  float* dq;             // [B, Hq, Nq, d] f32 contiguous, zeroed, added to
  float* dk;             // [B, Hq, Nk, d] f32 contiguous, written
  float* dv;
  const int* seg_q;      // [B, q_tiles * 32] ids, contiguous, rows padded to whole tiles
  const int* seg_kv;     // [B, kv_tiles * 64] ids, contiguous, rows padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 32-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) id of each 64-key tile's keys
  int batch, hq, rep, nq, nq_pad, nk, kv_valid_len, d;
  int lo, hi;              // band: row - lo <= key <= row + hi (NO_BOUND: none)
  int q_tiles, kv_tiles;   // ceil(Nq / 32), ceil(kv_valid_len / 64)
  float scale, scale_log2;
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
  const float* bias;     // BIAS: f32 [B|1, Hq|1, Nq|1, Nk], unit column stride
  float* dbias;          // BIAS: [B, Hq, Nq, Nk] f32 contiguous, or null (no dbias)
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
};

}  // namespace fa

namespace {

using namespace fa;

constexpr int F32B_BLOCK_N = 64;   // keys per CTA: one consumer warpgroup
constexpr int F32B_BLOCK_M = 32;   // query rows per Q tile
constexpr int F32B_STACK = 3 * F32B_BLOCK_M;  // rows of a stacked tile: three pieces
constexpr int F32B_THREADS = 256;  // producer warpgroup + consumer warpgroup
constexpr float F32B_NEG_GUARD = 0.5f * MASK_VALUE;

// Shared-memory layout (bytes, from a 1024-byte-aligned base): K's three
// pieces, V's three pieces (each D / 64 boxes of 64 rows), 2 stages of (Q,
// dO) as stacked tiles (D / 64 boxes of 96 rows each, piece p at rows
// 32p..), dS's stacked tile [96][64] bf16, the f32 dQ stage [32][d], the ids
// (the KV tile's [64], each stage's Q tile's [2][32]), LSE and Delta [2][32]
// each, then the mbarriers kv_full, full[2], empty[2].
template <int D>
struct F32BwdSmem {
  static constexpr int KVP = F32B_BLOCK_N * D * 2;  // one piece of K or V
  static constexpr int OFF_V = 3 * KVP;
  static constexpr int QT = F32B_STACK * D * 2;     // a stacked Q or dO tile
  static constexpr int OFF_STAGE = 6 * KVP;
  static constexpr int STAGE = 2 * QT;
  static constexpr int OFF_DS = OFF_STAGE + 2 * STAGE;
  static constexpr int OFF_DQ = OFF_DS + F32B_STACK * F32B_BLOCK_N * 2;
  static constexpr int OFF_SEG = OFF_DQ + F32B_BLOCK_M * D * 4;
  static constexpr int OFF_STATS = OFF_SEG + (F32B_BLOCK_N + 2 * F32B_BLOCK_M) * 4;
  static constexpr int BARS = OFF_STATS + 2 * 2 * F32B_BLOCK_M * 4;
  static constexpr int BYTES = 1024 + BARS + 5 * 8;
  static_assert(KVP % 1024 == 0 && QT % 1024 == 0 && OFF_DS % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// acc = the six bf16 products of A's pieces (a_s: piece 0, pieces
// a_piece bytes apart) and B's (b_s: a stacked K-major tile, piece p at rows
// 32p..), the small terms first, over K_STEPS k-steps of 16 along the
// reduction; a_k(kk) / b_k(kk) give k-step kk's byte offset in A's / B's
// layout, a_lbo A's leading byte offset (M-major A: its box size).
template <int TA, int K_STEPS, typename AK, typename BK>
__device__ __forceinline__ void issue_ss6(float (&acc)[16], const unsigned char* a_s, int a_piece,
                                          const unsigned char* b_s, AK a_k, BK b_k,
                                          uint32_t a_lbo) {
  const uint64_t a0 = opaque(smem_desc(a_s, a_lbo, 1024));
  const uint64_t b0 = opaque(smem_desc(b_s, 16, 1024));
  wgmma_fence();
#pragma unroll 1  // unrolled, the chains crash ptxas 12.9 (the header)
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < K_STEPS; ++kk) {
      wgmma_ss_m64n32k16<TA>(acc, a0 + ((pair_a(x) * a_piece + a_k(kk)) >> 4),
                             b0 + ((pair_b(x) * F32B_BLOCK_M * SW128_ROW + b_k(kk)) >> 4),
                             x > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// acc += the six bf16 products of a's pieces (A fragments of 2 k-steps, 32
// query rows) and a stacked N-major B tile (b_s: rows 32p.. piece p, boxes
// of 96 rows), the small terms first.
template <int D>
__device__ __forceinline__ void issue_rs6(float (&acc)[D / 2], const uint32_t (&a)[3][2][4],
                                          const unsigned char* b_s) {
  const uint64_t b0 = opaque(smem_desc(b_s, F32B_STACK * SW128_ROW, 1024));
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_pv<D>(acc, a[pair_a(x)][kk],
                  b0 + (((F32B_BLOCK_M * pair_b(x) + 16 * kk) * SW128_ROW) >> 4));
    }
  }
  wgmma_commit();
}

template <int D, bool SEG, bool CAP, bool BIAS>
__global__ void __launch_bounds__(F32B_THREADS, 1)
    bwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const BwdF32Params p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  using S = F32BwdSmem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + 2;
  int* seg_kv_s = reinterpret_cast<int*>(smem + S::OFF_SEG);
  int* seg_q_s = seg_kv_s + F32B_BLOCK_N;                            // [2][32]
  float* s_stats = reinterpret_cast<float*>(smem + S::OFF_STATS);   // lse[2][32], delta[2][32]
  auto stage = [&](int s) { return smem + S::OFF_STAGE + s * S::STAGE; };

  const int h = blockIdx.x;
  const int hk = h / p.rep;
  // A left bound alone: the late KV tiles meet the most Q tiles; run them
  // first (causal's first tiles are its longest already).
  const int n_tile =
      p.lo < NO_BOUND && p.hi >= NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int n0 = n_tile * F32B_BLOCK_N;
  const int b = blockIdx.z;
  // Rows [n0 - hi, n0 + 63 + lo] meet the tile's keys; none when the tile
  // lies past kv_valid_len (its dK / dV rows are then zeros).
  const int m_begin = p.hi < NO_BOUND ? max(0, n0 - p.hi) / F32B_BLOCK_M * F32B_BLOCK_M : 0;
  const int m_end = p.lo < NO_BOUND ? min(p.nq, n0 + F32B_BLOCK_N + p.lo) : p.nq;
  const int n_m = n0 < p.kv_valid_len && m_end > m_begin
                      ? (m_end - m_begin + F32B_BLOCK_M - 1) / F32B_BLOCK_M
                      : 0;
  const int t0 = m_begin / F32B_BLOCK_M;
  int2 k_rng = make_int2(0, 0);
  if constexpr (SEG) {
    if (n_m > 0) k_rng = p.kv_range[b * p.kv_tiles + n_tile];
  }
  // The first visited Q tile at or after i (SEG: whose id range meets the KV
  // tile's); producer and consumer walk the same tiles.
  auto next_visit = [&](int i) {
    if constexpr (SEG) {
      while (i < n_m && !ranges_meet(p.q_range[b * p.q_tiles + t0 + i], k_rng)) ++i;
    }
    return i;
  };
  const int first = next_visit(0);
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 issues the copies.
    if (tid == 0 && first < n_m) {
      mbar_expect_tx(kv_full, 6 * S::KVP + (SEG ? F32B_BLOCK_N * 4 : 0));
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(smem + pc * S::KVP + x * F32B_BLOCK_N * SW128_ROW, &tm_k, kv_full, 64 * x,
                      n0, hk, pc * p.batch + b);
          tma_load_4d(smem + S::OFF_V + pc * S::KVP + x * F32B_BLOCK_N * SW128_ROW, &tm_v,
                      kv_full, 64 * x, n0, hk, pc * p.batch + b);
        }
      }
      if constexpr (SEG) {
        bulk_load(seg_kv_s, p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * F32B_BLOCK_N + n0,
                  F32B_BLOCK_N * 4, kv_full);
      }
      int it = 0;
      for (int i = first; i < n_m; i = next_visit(i + 1), ++it) {
        const int s = it & 1;
        const int m = m_begin + i * F32B_BLOCK_M;
        unsigned char* st = stage(s);
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::QT + 2 * F32B_BLOCK_M * 4 + (SEG ? F32B_BLOCK_M * 4 : 0));
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
          for (int x = 0; x < BOXES; ++x) {
            const int off = (x * F32B_STACK + pc * F32B_BLOCK_M) * SW128_ROW;
            tma_load_4d(st + off, &tm_q, &full[s], 64 * x, m, h, pc * p.batch + b);
            tma_load_4d(st + S::QT + off, &tm_do, &full[s], 64 * x, m, h, pc * p.batch + b);
          }
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.nq_pad + m;
        bulk_load(s_stats + s * F32B_BLOCK_M, p.lse + row, F32B_BLOCK_M * 4, &full[s]);
        bulk_load(s_stats + (2 + s) * F32B_BLOCK_M, p.delta + row, F32B_BLOCK_M * 4, &full[s]);
        if constexpr (SEG) {
          bulk_load(seg_q_s + s * F32B_BLOCK_M,
                    p.seg_q + static_cast<int64_t>(b) * p.q_tiles * F32B_BLOCK_M + m,
                    F32B_BLOCK_M * 4, &full[s]);
        }
      }
    }
  } else {
    // Consumer: warpgroup 1, the tile's 64 keys.
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int kv0 = n0 + warp * 16 + g;  // this thread's keys kv0 and kv0 + 8
    const unsigned char* k_s = smem;
    const unsigned char* v_s = smem + S::OFF_V;
    unsigned char* ds_s = smem + S::OFF_DS;
    float* dq_stage = reinterpret_cast<float*>(smem + S::OFF_DQ);
    const bool issuer = tid == 0;  // issues the dQ reductions
    const int d = p.d;  // the columns of dQ / dK / dV, d <= D (the boxes read zeros past it)
    // K steps: along D (S^T, dP^T: 32 bytes into a row, a box every 4) and
    // along the tile's 64 keys (dQ^T: 16 rows of K, 32 bytes into dS's rows).
    auto d_step = [](int kk) { return (kk % 4) * 32; };

    float dk[D / 2], dv[D / 2];
    zero(dk);
    zero(dv);
    int kv_seg[2] = {0, 0};  // SEG: the ids of this thread's keys
    if (first < n_m) {
      mbar_wait(kv_full, 0);
      if constexpr (SEG) {
        kv_seg[0] = seg_kv_s[kv0 - n0];
        kv_seg[1] = seg_kv_s[kv0 - n0 + 8];
      }
    }
    int it = 0;
    for (int i = first; i < n_m; i = next_visit(i + 1), ++it) {
      const int s = it & 1;
      const int m = m_begin + i * F32B_BLOCK_M;  // the tile's first row
      const unsigned char* q_st = stage(s);
      const unsigned char* do_st = q_st + S::QT;
      mbar_wait(&full[s], (it >> 1) & 1);
      // This thread's coordinates, opaque to the compiler: the ~60 addresses
      // derived from them (LSE / Delta, the dS and dQ stage stores) are
      // recomputed each tile instead of being held in registers across the
      // loop, which spilled.
      const int tw = opaque(warp), tg = opaque(g), tt = opaque(t);
      const int kvt = n0 + tw * 16 + tg;  // this thread's keys kvt and kvt + 8

      // Edge tiles: those that the tails, the band or (SEG) a document edge cut.
      bool edge = m + F32B_BLOCK_M > p.nq || n0 + F32B_BLOCK_N > p.kv_valid_len ||
                  n0 + F32B_BLOCK_N - 1 - m > p.hi || m + F32B_BLOCK_M - 1 - n0 > p.lo;
      if constexpr (SEG) {
        const int2 q_rng = p.q_range[b * p.q_tiles + m / F32B_BLOCK_M];
        edge = edge || !(q_rng.x == q_rng.y && k_rng.x == k_rng.y && q_rng.x == k_rng.x);
      }

      // S^T = K Q^T and dP^T = V dO^T: rows are the tile's keys, columns its
      // 32 query rows; dP^T runs while P^T is formed.
      float sc[16], dp[16];
      auto a_d = [](int kk) { return (kk / 4) * F32B_BLOCK_N * SW128_ROW + (kk % 4) * 32; };
      auto b_d = [](int kk) { return (kk / 4) * F32B_STACK * SW128_ROW + (kk % 4) * 32; };
      issue_ss6<0, D / 16>(sc, k_s, S::KVP, q_st, a_d, b_d, 16);
      issue_ss6<0, D / 16>(dp, v_s, S::KVP, do_st, a_d, b_d, 16);
      // BIAS: bv[4jj + 2r + e] the bias of query row m + 8jj + 2t + e, key kvt
      // + 8r (S^T's layout), loaded while the products run; an edge tile
      // reads only rows below Nq and keys below kv_valid_len.
      float bv[BIAS ? 16 : 1];
      if constexpr (BIAS) {  // bwd f32 bias prefetch
        const float* brow = p.bias + b * p.bias_sb + h * p.bias_sh +
                            static_cast<int64_t>(m + 2 * tt) * p.bias_sn + kvt;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = m + 8 * jj + 2 * tt + e;
              const bool in = !edge || (row < p.nq && kvt + 8 * r < p.kv_valid_len);
              bv[4 * jj + 2 * r + e] = in ? __ldg(brow + (8 * jj + e) * p.bias_sn + 8 * r) : 0.f;
            }
          }
        }
      }
      wgmma_wait<1>();
      fence_regs(sc);

      // P^T: sc[4jj + 2r + e] is key kvt + 8r, query row m + 8jj + 2t + e; a
      // dead row's LSE becomes +inf (P = 0 exactly).
      const uint32_t lse_addr = smem_u32(s_stats + s * F32B_BLOCK_M + 2 * tt);
      const uint32_t dlt_addr = smem_u32(s_stats + (2 + s) * F32B_BLOCK_M + 2 * tt);
      const int* q_ids = seg_q_s + s * F32B_BLOCK_M + 2 * tt;  // SEG: this thread's query ids
      float pj[16];  // P^T (CAP: P^T (1 - tt^2)), all dS^T needs
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 lv = lds_f2(lse_addr + 32 * jj);
        float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
        int2 qi = make_int2(0, 0);
        if (SEG && edge) qi = *reinterpret_cast<const int2*>(q_ids + 8 * jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) l2[e] = l2[e] <= F32B_NEG_GUARD ? INFINITY : l2[e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * r + e;
            float x, jac = 1.f;
            if constexpr (CAP) {
              // The forward's accurate tanhf (flash_fwd_f32.cu), not tanh.approx.
              const float tc = tanhf(sc[i] * p.cap_scale);
              x = p.cap_log2 * tc;
              jac = 1.f - tc * tc;  // bwd f32 softcap jacobian
            } else {
              x = sc[i] * p.scale_log2;
            }
            if constexpr (BIAS) x = fmaxf(x + bv[i] * LOG2E, MASK_VALUE);
            float pe = exp2f(x - l2[e]);
            if (edge) {
              const int key = kvt + 8 * r;
              const int row = m + 8 * jj + 2 * tt + e;
              if (row >= p.nq || key >= p.kv_valid_len || key - row > p.hi ||
                  row - key > p.lo) {  // bwd f32 band mask
                pe = 0.f;
              }
              if (SEG && (e ? qi.y : qi.x) != kv_seg[r]) pe = 0.f;
            }
            sc[i] = pe;
            pj[i] = pe * jac;
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      if constexpr (BIAS) {
        if (p.dbias != nullptr) {
          // dbias = dL^T = P^T (dP^T - Delta), before the scale and the cap's
          // Jacobian (pj holds P^T (1 - t^2)): 8 lanes store 8 keys of a row.
          float* db = p.dbias +
                      ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m + 2 * tt) * p.nk + kvt;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * jj + 2 * r + e;
                if (m + 8 * jj + 2 * tt + e < p.nq && kvt + 8 * r < p.nk) {
                  __stcs(db + static_cast<int64_t>(8 * jj + e) * p.nk + 8 * r,
                         sc[i] * (dp[i] - (e ? dl.y : dl.x)));  // bwd f32 dbias
                }
              }
            }
          }
        }
      }

      // dV += P^T dO, its six products with A from registers; dS^T = P^T
      // (dP^T - Delta) scale (CAP: P^T (1 - tt^2)) meanwhile. P^T's and dS^T's
      // pieces are not live together: 48 registers would pass the 255.
      {
        uint32_t pa[3][2][4];
        split3_frags<2>(pa, sc);
        issue_rs6<D>(dv, pa, do_st);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * jj + 2 * r;
            dp[i] = pj[i] * (dp[i] - dl.x) * p.scale;
            dp[i + 1] = pj[i + 1] * (dp[i + 1] - dl.y) * p.scale;
          }
        }
        wgmma_wait<0>();  // dV has retired
        fence_regs(dv);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) fence_regs(pa[pc][kk]);
        }
      }
      // dK += dS^T Q, and dS's pieces into the stacked [96][64] tile (rows 32p
      // + query, keys along the 128-byte rows, the swizzle's chunk order:
      // 16-byte chunk c of row R at c ^ (R % 8)): da[p][kk][i] holds key kvt +
      // 8 (i & 1), queries 16kk + 8 (i >> 1) + 2t and + 1.
      uint32_t da[3][2][4];
      split3_frags<2>(da, dp);
      issue_rs6<D>(dk, da, q_st);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = tw * 16 + tg + 8 * (i & 1);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = F32B_BLOCK_M * pc + 16 * kk + 8 * (i >> 1) + 2 * tt + e;
              *reinterpret_cast<uint16_t*>(ds_s + row * SW128_ROW +
                                           (((key >> 3) ^ (row & 7)) << 4) + (key & 7) * 2) =
                  static_cast<uint16_t>(da[pc][kk][i] >> (16 * e));
            }
          }
        }
      }
      fence_proxy_async();
      wgmma_wait<0>();  // dK has retired
      fence_regs(dk);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) fence_regs(da[pc][kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this tw is done with (Q, dO, LSE, Delta)
      if (issuer) bulk_wait_read();  // the last tile's reduction has read the dQ stage
      named_sync(1, 128);            // dS written by every tw, the dQ stage free

      // dQ^T = K^T dS^T, 64 of D's columns at a time: dq[4jj + 2r + e] is
      // column 64x + 16 tw + tg + 8r, query row 8jj + 2t + e, staged into
      // the row-major [32][d] tile (dQ's own layout).
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        float dq[16];
        issue_ss6<1, F32B_BLOCK_N / 16>(
            dq, k_s + x * F32B_BLOCK_N * SW128_ROW, S::KVP, ds_s,
            [](int kk) { return kk * 16 * SW128_ROW; }, d_step, F32B_BLOCK_N * SW128_ROW);
        wgmma_wait<0>();
        fence_regs(dq);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 64 * x + tw * 16 + tg + 8 * r;
          if (col >= d) continue;  // bwd f32 dQ stage columns
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dq_stage[(8 * jj + 2 * tt) * d + col] = dq[4 * jj + 2 * r];
            dq_stage[(8 * jj + 2 * tt + 1) * d + col] = dq[4 * jj + 2 * r + 1];
          }
        }
      }
      fence_proxy_async();
      named_sync(2, 128);  // the whole dQ tile is staged; dS is free for the next tile
      if (issuer) {
        // Only the tile's rows below Nq: dQ is [B, Hq, Nq, d] contiguous, so
        // a full 32 rows on the last tile would add into the next head's.
        const int q_rows = min(F32B_BLOCK_M, p.nq - m);
        bulk_reduce_add_f32(p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m) * d,
                            dq_stage, q_rows * d * 4);  // bwd f32 dQ reduce
        bulk_commit();
      }
    }
    if (issuer) bulk_wait();

    // dK and dV of this thread's keys, per query head; every key below Nk is
    // written (zeros for keys no row reached).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kv0 + 8 * r;
      if (key >= p.nk) continue;
      const int64_t off = ((static_cast<int64_t>(b) * p.hq + h) * p.nk + key) * d + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        if (8 * jj + 2 * t >= d) continue;
        *reinterpret_cast<float2*>(p.dk + off + 8 * jj) =
            make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<float2*>(p.dv + off + 8 * jj) =
            make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool SEG, bool CAP, bool BIAS>
cudaError_t bwd_f32_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                           const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                           const BwdF32Params& p, cudaStream_t stream) {
  auto kernel = bwd_f32_kernel<D, SEG, CAP, BIAS>;
  constexpr int smem = F32BwdSmem<D>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nk + F32B_BLOCK_N - 1) / F32B_BLOCK_N, p.batch);
  kernel<<<grid, F32B_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

template <int D, bool BIAS>
cudaError_t bwd_f32_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                             const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                             const BwdF32Params& p, bool seg, bool cap, cudaStream_t stream) {
  if (seg) {
    return cap ? bwd_f32_launch<D, true, true, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream)
               : bwd_f32_launch<D, true, false, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream);
  }
  return cap ? bwd_f32_launch<D, false, true, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream)
             : bwd_f32_launch<D, false, false, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream);
}

}  // namespace

extern "C" {

// dQ, dK, dV (and dbias) of attention on f32 inputs: the argument list of
// fa_bwd_split_sm90 (flash_bwd_split_sm90.cu) in its order, then the bias and
// dbias before the stream, on f32 q / dout
// [B, Hq, Nq, D] and k / v [B, Hkv, Nk, D] (unit stride on D, other strides
// in elements, any alignment), and after dv `pieces`: bf16 scratch of 3 DB (2
// B Hq Nq + 2 B Hkv kv_valid_len) elements, 16-byte aligned (DB = 64 for D <=
// 64, else 128). One launch of the split (split_bf16x3.cu) writes the three
// bf16 pieces of q's and dout's rows and of k's and v's first kv_valid_len
// rows there (q, k, v, dout in that order, each [3, B, H, N, DB]); the
// attention kernel then reads them. lse / delta [B, Hq, nq_pad] f32
// contiguous (nq_pad a multiple of 32, rows past Nq never read as live), dq
// [B, Hq, Nq, D] f32 contiguous, zeroed and added to, dk / dv [B, Hq, Nk, D]
// f32 contiguous per query head (every row written); causal, the window (wl,
// wr; a negative bound is none) and the absolute offsets (q_off, kv_off) as
// in K3's fa_bwd_sm90; segment ids as four pointers or none --
//   seg_q [B, q_tiles * 32] and seg_kv [B, kv_tiles * 64] int32 contiguous,
//     16-byte aligned: the ids of the rows below Nq and of the keys below
//     kv_valid_len, each row padded to whole tiles;
//   q_range [B, q_tiles] and kv_range [B, kv_tiles] int32 (min, max) pairs:
//     each 32-row Q tile's and each 64-key tile's id range,
// with q_tiles = ceil(Nq / 32) and kv_tiles = ceil(kv_valid_len / 64);
// softcap > 0 the forward's cap, 0 none; bias an f32 [B|1, Hq|1, Nq|1, Nk]
// (unit column stride, 4-byte aligned, (batch, head, row) strides in
// elements, 0 on broadcast dims) added to the (capped) scores as the forward
// added it, or null; dbias, with a bias, [B, Hq, Nq, Nk] f32 contiguous or
// null: P (dP - Delta) on every pair of the Q tiles the kernel visits (0 on
// the pairs the masks drop), nothing elsewhere; none of the three options is
// K3's call. Requires kv_valid_len >= 1 (without keys every gradient is 0). Returns a
// cudaError_t (0: success; cudaErrorInvalidValue for arguments it does not
// take, cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or
// refuses a tensor map).
int fa_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, void* pieces, const void* seg_q,
               const void* seg_kv, const void* q_range, const void* kv_range, int batch, int hq,
               int hkv, int nq, int nk, int d, int kv_valid_len, int causal, int wl, int wr,
               int q_off, int kv_off, int nq_pad, float scale, float softcap, int64_t q_sb,
               int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
               int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh,
               int64_t do_sn, const void* bias, void* dbias, int64_t bias_sb, int64_t bias_sh,
               int64_t bias_sn, void* stream) {
  const bool seg = seg_q != nullptr;
  const bool cap = softcap > 0.f;
  const bool has_bias = bias != nullptr;
  if (d < 8 || d > 128 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq > 65535 || hq % hkv != 0 || nq < 1 || nk < 1 ||
      (nk + F32B_BLOCK_N - 1) / F32B_BLOCK_N > 65535 || kv_valid_len < 1 ||
      kv_valid_len > nk || nq_pad < nq || nq_pad % F32B_BLOCK_M || !(softcap >= 0.f) ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) ||
      (seg && (!aligned(seg_q, 16) || !aligned(seg_kv, 16) || !aligned(q_range, 8) ||
               !aligned(kv_range, 8))) ||
      !aligned(pieces, 16) || !aligned(lse, 16) || !aligned(delta, 16) || !aligned(dq, 16) ||
      !aligned(dk, 8) || !aligned(dv, 8) || (dbias != nullptr && !has_bias) ||
      (has_bias && (!aligned(bias, 4) || bias_sb < 0 || bias_sh < 0 || bias_sn < 0)) ||
      !aligned(dbias, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The pieces: q's [3, B, Hq, Nq, DB], k's and v's [3, B, Hkv, kv_valid_len,
  // DB], dout's [3, B, Hq, Nq, DB].
  const int db = d <= 64 ? 64 : 128;
  const int64_t q_head = static_cast<int64_t>(db) * nq;
  const int64_t kv_head = static_cast<int64_t>(db) * kv_valid_len;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* kp = qp + 3 * q_head * hq * batch;
  __nv_bfloat16* vp = kp + 3 * kv_head * hkv * batch;
  __nv_bfloat16* dop = vp + 3 * kv_head * hkv * batch;
  const fa::SplitArg split[4] = {{q, qp, batch, hq, nq, d, q_sb, q_sh, q_sn},
                                 {k, kp, batch, hkv, kv_valid_len, d, k_sb, k_sh, k_sn},
                                 {v, vp, batch, hkv, kv_valid_len, d, v_sb, v_sh, v_sn},
                                 {dout, dop, batch, hq, nq, d, do_sb, do_sh, do_sn}};
  cudaError_t e = fa::split_bf16x3(split, 4, db, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  if (!make_bhnd_map(&tm_q, qp, 3 * batch, hq, nq, d, q_head * hq, q_head, db, F32B_BLOCK_M) ||
      !make_bhnd_map(&tm_k, kp, 3 * batch, hkv, kv_valid_len, d, kv_head * hkv, kv_head, db,
                     F32B_BLOCK_N) ||
      !make_bhnd_map(&tm_v, vp, 3 * batch, hkv, kv_valid_len, d, kv_head * hkv, kv_head, db,
                     F32B_BLOCK_N) ||
      !make_bhnd_map(&tm_do, dop, 3 * batch, hq, nq, d, q_head * hq, q_head, db,
                     F32B_BLOCK_M)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::BwdF32Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.batch = batch;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq_pad;
  p.nk = nk;
  p.kv_valid_len = kv_valid_len;
  p.d = d;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.q_tiles = (nq + F32B_BLOCK_M - 1) / F32B_BLOCK_M;
  p.kv_tiles = (kv_valid_len + F32B_BLOCK_N - 1) / F32B_BLOCK_N;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  p.bias = static_cast<const float*>(bias);
  p.dbias = static_cast<float*>(dbias);
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
  if (has_bias) {
    e = d <= 64 ? bwd_f32_dispatch<64, true>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s)
                : bwd_f32_dispatch<128, true>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s);
  } else {
    e = d <= 64 ? bwd_f32_dispatch<64, false>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s)
                : bwd_f32_dispatch<128, false>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
