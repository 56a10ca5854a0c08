// The single-pass TMA + wgmma attention backward for Hopper (sm_90a) at head
// dims 136-256: the D 256 form of K3 (flash_bwd_sm90.cu, bwd_sm90_kernel<256>),
// of K5 + K6 without a bias (flash_bwd_split_sm90.cu,
// bwd_split_sm90_kernel<256, SEG, CAP>: segment ids, the logit softcap or
// both) and of K5 + K6's bias route (bwd_bias_sm90.cu,
// bwd_bias_wide_kernel<SEG, CAP>: BIAS, with or without segment ids and the
// softcap; dbias on a runtime pointer). It computes what bwd_sm90_tile.cuh
// computes for those families (the formulas are in its header): P^T from the
// forward's LSE (BIAS: the score + bias log2 e, floored at the mask value),
// exactly 0 on keys at or past kv_valid_len, rows past Nq, outside the band
// (common.cuh band_bounds: causal, a window, q / kv offsets), on a pair whose
// ids differ (SEG) and on a dead row; dS^T = P^T (dP^T - Delta) scale, with
// CAP P^T (1 - t^2) in the fp16 copy that forms it; dbias = P^T (dP^T -
// Delta) from the f32 P^T, before the scale and the cap's Jacobian; dV = P^T
// dO, dK = dS^T Q per query head, dQ = dS K added into a zeroed f32 dQ. Every
// p.d <= 256 that is a multiple of 8 runs in the 256 box: the TMA maps read
// zeros past d (a box wholly past d reads zeros too), as D 40 and 80 run in
// 64 and 128.
//
// Why not bwd_sm90_tile.cuh at D 256: its 128 KV rows a CTA keep each
// consumer's f32 dK and dV for 64 keys x D columns in registers, 256 a
// thread at D 256, past the 240 that setmaxnreg gives a consumer; and its
// shared memory (K, V, two (Q, dO) stages of 64 rows, two dS^T buffers, the
// dQ stage) would take ~352 KB of the 227. So here (FlashAttention-3's
// Hopper backward at head dim 256 takes the same tiles, 64 x 64, with two
// MMA warpgroups):
//
//   * One CTA owns 64 keys of one (batch, query head) -- dK / dV per query
//     head, which the caller sums over each KV head's group, as K3's grid --
//     warpgroup 0 the producer (one thread issues every copy; setmaxnreg
//     gives its registers away), warpgroups 1 and 2 the consumers. Consumer
//     c keeps dK and dV of the 64 keys for D's columns 128c..128c+127 in
//     registers: two m64n128 accumulators, 128 f32 a thread.
//   * S^T = K Q^T and dP^T = V dO^T run over the whole 256-deep contraction,
//     split between the consumers along the query columns: consumer c forms
//     P^T and dS^T for the tile's query rows 32c..32c+31 (wgmma m64n32k16
//     from shared memory, 16 k-steps each, 16 accumulators each) and writes
//     them, bf16, into the shared P^T and dS^T tiles [64 keys][64 queries]
//     (128-byte swizzle). After a named barrier each consumer runs dV += P^T
//     dO and dK += dS^T Q on its 128 columns (A K-major and B N-major, both
//     from shared memory) and dQ = dS K on its 128 columns, as two m64n64
//     products in turn (dS^T the M-major A, K the N-major B; 32 accumulators,
//     so dK, dV and dQ together hold 160 registers and not 192).
//   * One (Q, dO) stage of 64 rows (with its LSE, Delta and, SEG, ids): the
//     consumers release it once dV and dK have retired, so the producer loads
//     the next Q tile while dQ is formed and reduced.
//   * dQ is staged as f32 [64][d] (exactly d columns) and added to dQ by ONE
//     cp.reduce.async.bulk per tile of the tile's q_rows * d * 4 bytes: dQ is
//     [B, Hq, Nq, d] contiguous, so a full 64 rows on the last Q tile, or a
//     row of 256 > d columns, would add into the next rows or head.
//   * Shared memory: K and V 2 x 32 KB (four boxes of 64 columns x 64 rows
//     each), the (Q, dO) stage 2 x 32 KB, P^T and dS^T 2 x 8 KB, the dQ stage
//     64 KB, ids 512 B, LSE and Delta 512 B, three mbarriers: 210 KB + the
//     1024-byte alignment of 227 KB. A second (Q, dO) stage would need 64 KB
//     more. Registers: consumers 240 (setmaxnreg), of which dK and dV take
//     128; the shared-memory descriptors derive from two opaque() bases a
//     tile, so the compiler cannot hoist ~90 of them (two registers each)
//     out of the Q-tile loop.
//   * BIAS: shared memory has no room for a bias tile (a [64 keys x 64
//     queries] f32 tile is 16 KB beside the 210 KB above), so each consumer
//     thread reads its 16 values of a tile from global memory (L2) straight
//     into S^T's fragment layout -- query row mc + 8jj + 2t + e, key kv0 + 8r:
//     the 8 lanes of a t cover 8 consecutive keys of one row, a whole 32-byte
//     sector -- issued right after S^T and dP^T, so they land while the
//     products run (as flash_bwd_f32.cu reads its bias). Each (query head,
//     key) pair has one owning CTA, so dbias [B, Hq, Nq, Nk] takes plain
//     (streaming) stores from the same layout once dP^T has retired; the
//     pairs of the Q tiles that the band or the ids skip are never written
//     (the wrapper zero-fills dbias for such calls, flash_bwd.dbias_skips).
//     dK / dV come per query head, as K3's, and the wrapper sums each KV
//     head's group.
//   * SEG: the split route's wrapper gives each 64-row Q tile's and each
//     128-key tile's [min, max] id (ops/flash_fwd.py::sm90_segments, the
//     tiles of the D <= 128 form); the CTA's 64 keys take their 128-key
//     tile's range (a superset: a Q tile it skips holds no pair of theirs,
//     and a tile pair it marks one document is one). Producer and consumers
//     walk the band's Q tiles whose range meets it (no list in shared
//     memory: it would not fit); pairs are tested per id only on tiles that a
//     document edge cuts. A CTA that visits no Q tile leaves its dK / dV rows
//     zero, as a tile past kv_valid_len.
//
// What bounds it: at the path's attention (an LM with 8 query and 4 KV heads
// of 256, B1 N2048 causal) the five products are 43 GFLOP, 0.043 ms at 989
// TFLOP/s: operations, as K3 at the LM's D 128.

#pragma once

#include "bwd_sm90_tile.cuh"

namespace {

using namespace fa;

constexpr int BW_D = 256;        // the head-dim box
constexpr int BW_BLOCK_N = 64;   // keys per CTA
constexpr int BW_BLOCK_M = 64;   // query rows per Q tile
constexpr int BW_HALF_M = 32;    // query rows of S^T per consumer
constexpr int BW_SEG_KV_TILE = 128;  // keys of the wrapper's id ranges (as BB_BLOCK_N)

// Shared-memory layout (bytes, from a 1024-byte-aligned base): K, V (four
// boxes of 64 rows each), Q, dO (the same), P^T, dS^T ([64][64] bf16), the f32
// dQ stage [64][d], the ids (the CTA's keys' [64], the Q tile's [64]), LSE and
// Delta [64] each, then the mbarriers kv_full, full, empty.
struct BwSmem {
  static constexpr int KV = BW_BLOCK_N * BW_D * 2;
  static constexpr int QT = BW_BLOCK_M * BW_D * 2;
  static constexpr int PT = BW_BLOCK_N * BW_BLOCK_M * 2;
  static constexpr int OFF_V = KV;
  static constexpr int OFF_Q = 2 * KV;
  static constexpr int OFF_DO = OFF_Q + QT;
  static constexpr int OFF_PT = OFF_DO + QT;
  static constexpr int OFF_DS = OFF_PT + PT;
  static constexpr int OFF_DQ = OFF_DS + PT;
  static constexpr int OFF_SEG = OFF_DQ + BW_BLOCK_M * BW_D * 4;
  static constexpr int OFF_STATS = OFF_SEG + (BW_BLOCK_N + BW_BLOCK_M) * 4;
  static constexpr int BARS = OFF_STATS + 2 * BW_BLOCK_M * 4;
  static constexpr int BYTES = 1024 + BARS + 3 * 8;
  static_assert(KV % 1024 == 0 && QT % 1024 == 0 && PT % 1024 == 0 && OFF_DQ % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// A K3 / split-route CTA's shared memory and keys at head-dim box D: this
// body's at 256, bwd_sm90_tile.cuh's below (BbSmem<256> is never formed).
template <int D, bool SEG = false>
constexpr int bwd_smem_bytes() {
  if constexpr (D == BW_D) {
    return BwSmem::BYTES;
  } else {
    return BbSmem<D, false, SEG>::BYTES;
  }
}

// The head-dim box that takes a call at head dim d (a multiple of 8 up to
// 256: the TMA maps' zero fill runs it in the next box up), and a box's keys
// a CTA, which are also the K / V boxes' rows. The one place that says which
// form takes which d.
constexpr int bwd_box_d(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : BW_D; }
constexpr int bwd_block_n(int box_d) { return box_d == BW_D ? BW_BLOCK_N : BB_BLOCK_N; }

// The body of bwd_sm90_kernel<256> (K3: Params BwdDenseParams), of
// bwd_split_sm90_kernel<256, SEG, CAP> (Params BwdSplitParams) and of
// bwd_bias_wide_kernel<SEG, CAP> (BIAS: Params BwdBiasParams, its bias
// pointer and strides; dbias when p.dbias is not null), for any head dim p.d
// <= 256; launched as a grid (Hq, ceil(Nk / 64), B) of BB_THREADS threads
// with BwSmem::BYTES of shared memory. RING (K8's D 256 form, ring_bwd.cu:
// Params BwdDenseParams with q pre-scaled, scale = scale_log2 = 1): a grid
// (Hkv, ceil(Nk / 64), B) whose CTA walks the Q tiles of each query head of
// its KV head's group in turn (visit w: head h0 + w / n_m, Q tile w % n_m),
// so its dK / dV sum the group, and adds them into dk / dv [B, Hkv, Nk, d],
// the ring's rotating accumulators, which it alone owns.
template <bool SEG, bool CAP, bool BIAS = false, bool RING = false, typename Params>
__device__ __forceinline__ void bwd_wide_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                              const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                                              const Params p) {
  using S = BwSmem;
  constexpr int BOXES = BW_D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = kv_full + 2;
  float* s_stats = reinterpret_cast<float*>(smem + S::OFF_STATS);  // lse[64], delta[64]
  int* seg_kv_s = reinterpret_cast<int*>(smem + S::OFF_SEG);      // SEG: the keys' ids
  int* seg_q_s = seg_kv_s + BW_BLOCK_N;                           // SEG: the Q tile's ids

  static_assert(!(RING && (SEG || CAP || BIAS)), "K8 takes no ids, cap or bias");
  const int hk = RING ? blockIdx.x : blockIdx.x / p.rep;
  const int h0 = RING ? hk * p.rep : blockIdx.x;  // the first query head walked
  const int heads = RING ? p.rep : 1;             // K8 GQA heads
  // A left bound alone: the late KV tiles meet the most Q tiles; run them
  // first (causal's first tiles are its longest already).
  const int n_tile =
      p.lo < NO_BOUND && p.hi >= NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int n0 = n_tile * BW_BLOCK_N;
  const int b = blockIdx.z;
  // Rows [n0 - hi, n0 + 63 + lo] meet the tile's keys; none when the tile
  // lies past kv_valid_len (its dK / dV rows are then zeros).
  const int m_begin = p.hi < NO_BOUND ? max(0, n0 - p.hi) / BW_BLOCK_M * BW_BLOCK_M : 0;
  const int m_end = p.lo < NO_BOUND ? min(p.nq, n0 + BW_BLOCK_N + p.lo) : p.nq;
  const int n_m = n0 < p.kv_valid_len && m_end > m_begin
                      ? (m_end - m_begin + BW_BLOCK_M - 1) / BW_BLOCK_M
                      : 0;
  const int t0 = m_begin / BW_BLOCK_M;
  int2 k_rng = make_int2(0, 0);  // SEG: the id range of the keys' 128-key tile
  if constexpr (SEG) {
    if (n_m > 0) k_rng = p.kv_range[b * p.kv_tiles + n0 / BW_SEG_KV_TILE];
  }
  // The first visited Q tile at or after i (SEG: whose id range meets the
  // keys'); producer and consumers walk the same tiles.
  auto next_visit = [&](int i) {
    if constexpr (SEG) {
      while (i < n_m && !ranges_meet(p.q_range[b * p.q_tiles + t0 + i], k_rng)) ++i;
    }
    return i;
  };
  const int first = next_visit(0);
  const int n_w = heads * n_m;  // visits: the Q tiles of each head walked
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(full, 1);   // the TMA thread's expect_tx
    mbar_init(empty, 8);  // one arrival per consumer warp
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 issues the copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && first < n_m) {
      mbar_expect_tx(kv_full, 2 * S::KV + (SEG ? BW_BLOCK_N * 4 : 0));
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * BW_BLOCK_N * SW128_ROW, &tm_k, kv_full, 64 * x, n0, hk, b);
        tma_load_4d(smem + S::OFF_V + x * BW_BLOCK_N * SW128_ROW, &tm_v, kv_full, 64 * x, n0,
                    hk, b);
      }
      if constexpr (SEG) {
        bulk_load(seg_kv_s,
                  p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * BW_SEG_KV_TILE + n0,
                  BW_BLOCK_N * 4, kv_full);
      }
      int it = 0;
      for (int w = first; w < n_w; w = next_visit(w + 1), ++it) {
        const int m0 = m_begin + (RING ? w % n_m : w) * BW_BLOCK_M;
        const int h = RING ? h0 + w / n_m : h0;
        mbar_wait(empty, (it & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full, 2 * S::QT + 2 * BW_BLOCK_M * 4 + (SEG ? BW_BLOCK_M * 4 : 0));
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(smem + S::OFF_Q + x * BW_BLOCK_M * SW128_ROW, &tm_q, full, 64 * x, m0, h,
                      b);
          tma_load_4d(smem + S::OFF_DO + x * BW_BLOCK_M * SW128_ROW, &tm_do, full, 64 * x, m0,
                      h, b);
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.nq_pad + m0;
        bulk_load(s_stats, p.lse + row, BW_BLOCK_M * 4, full);
        bulk_load(s_stats + BW_BLOCK_M, p.delta + row, BW_BLOCK_M * 4, full);
        if constexpr (SEG) {
          bulk_load(seg_q_s, p.seg_q + static_cast<int64_t>(b) * p.q_tiles * BW_BLOCK_M + m0,
                    BW_BLOCK_M * 4, full);
        }
      }
    }
  } else {
    // Consumers: c = 0, 1 owns D's columns 128c..128c+127 of dK / dV / dQ and
    // the query rows 32c..32c+31 of each tile's S^T and dP^T.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int kv0 = n0 + warp * 16 + g;  // this thread's keys kv0 and kv0 + 8
    float* dq_stage = reinterpret_cast<float*>(smem + S::OFF_DQ);
    const bool issuer = c == 0 && tid == 0;  // issues the dQ reductions
    const int d = p.d;  // the columns of dQ / dK / dV, d <= 256 (the boxes read zeros past it)

    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    int kv_seg[2] = {0, 0};  // SEG: the ids of this thread's keys
    if (first < n_m) {
      mbar_wait(kv_full, 0);
      if constexpr (SEG) {
        kv_seg[0] = seg_kv_s[kv0 - n0];
        kv_seg[1] = seg_kv_s[kv0 - n0 + 8];
      }
    }
    int it = 0;
    for (int w = first; w < n_w; w = next_visit(w + 1), ++it) {
      const int m0 = m_begin + (RING ? w % n_m : w) * BW_BLOCK_M;  // the tile's first row
      const int h = RING ? h0 + w / n_m : h0;
      const int mc = m0 + BW_HALF_M * c;         // this consumer's first row of S^T
      mbar_wait(full, it & 1);
      // Every shared-memory operand from two bases the compiler cannot see
      // through: K-major tiles (LBO 16) and N-major ones (LBO a box, 8 KB).
      const uint64_t kmaj = opaque(smem_desc(smem, 16, 1024));
      const uint64_t nmaj = opaque(smem_desc(smem, BW_BLOCK_N * SW128_ROW, 1024));
      auto at = [](uint64_t base, int off) { return base + (static_cast<uint64_t>(off) >> 4); };

      // S^T = K Q^T and dP^T = V dO^T for this consumer's 32 query rows over
      // the 256 columns: k-step kk is 32 bytes into the rows of box kk / 4.
      float sc[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW_D / 16; ++kk) {
        const int koff = (kk / 4) * BW_BLOCK_N * SW128_ROW + (kk % 4) * 32;
        wgmma_ss_m64n32k16<0>(sc, at(kmaj, koff),
                              at(kmaj, S::OFF_Q + BW_HALF_M * c * SW128_ROW + koff), kk);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BW_D / 16; ++kk) {
        const int koff = (kk / 4) * BW_BLOCK_N * SW128_ROW + (kk % 4) * 32;
        wgmma_ss_m64n32k16<0>(dp, at(kmaj, S::OFF_V + koff),
                              at(kmaj, S::OFF_DO + BW_HALF_M * c * SW128_ROW + koff), kk);
      }
      wgmma_commit();

      // P^T: sc[4jj + 2r + e] is key kv0 + 8r, query row mc + 8jj + 2t + e; a
      // dead row's LSE becomes +inf (P = 0 exactly). Edge tiles: those that
      // the tails or the band cut for this consumer's rows.
      const bool edge = mc + BW_HALF_M > p.nq || n0 + BW_BLOCK_N > p.kv_valid_len ||
                        n0 + BW_BLOCK_N - 1 - mc > p.hi || mc + BW_HALF_M - 1 - n0 > p.lo;
      // BIAS: bv[4jj + 2r + e] the bias of (query row mc + 8jj + 2t + e, key
      // kv0 + 8r), in S^T's layout, loaded while the products run; an edge
      // tile reads only rows below Nq and keys below kv_valid_len.
      float bv[BIAS ? 16 : 1];
      if constexpr (BIAS) {  // bwd wide bias prefetch
        const float* brow = p.bias + b * p.bias_sb + h * p.bias_sh +
                            static_cast<int64_t>(mc + 2 * t) * p.bias_sn + kv0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool in = !edge || (mc + 8 * jj + 2 * t + e < p.nq &&
                                        kv0 + 8 * r < p.kv_valid_len);
              bv[4 * jj + 2 * r + e] =
                  in ? __ldg(brow + (8 * jj + e) * p.bias_sn + 8 * r) : 0.f;  // bwd wide bias key
            }
          }
        }
      }
      wgmma_wait<1>();  // S^T has retired
      fence_regs(sc);
      bool one_doc = true;  // SEG: the Q tile and the keys' tile are one single document
      if constexpr (SEG) {
        const int2 q_rng = p.q_range[b * p.q_tiles + m0 / BW_BLOCK_M];
        one_doc = q_rng.x == q_rng.y && k_rng.x == k_rng.y && q_rng.x == k_rng.x;
      }
      const uint32_t lse_addr = smem_u32(s_stats + BW_HALF_M * c + 2 * t);
      const uint32_t dlt_addr = smem_u32(s_stats + BW_BLOCK_M + BW_HALF_M * c + 2 * t);
      const int* q_ids = seg_q_s + BW_HALF_M * c + 2 * t;  // SEG: this thread's query ids
      uint32_t ph[8];  // P^T in fp16 for dS^T (CAP: P^T (1 - t^2))
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 lv = lds_f2(lse_addr + 32 * jj);
        float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 2; ++e) l2[e] = l2[e] <= NEG_GUARD ? INFINITY : l2[e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float jac[2];  // CAP: 1 - t^2 of the pair
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * r + e;
            float x;
            if constexpr (CAP) {
              // The forward's accurate tanhf, as bwd_sm90_tile.cuh.
              const float tc = tanhf(sc[idx] * p.cap_scale);
              x = p.cap_log2 * tc;
              jac[e] = 1.f - tc * tc;  // bwd wide softcap jacobian
            } else {
              x = sc[idx] * p.scale_log2;
            }
            if constexpr (BIAS) x = fmaxf(x + bv[idx] * LOG2E, MASK_VALUE);
            float pe = ex2(x - l2[e]);
            if (edge) {
              const int col = kv0 + 8 * r;
              const int row = mc + 8 * jj + 2 * t + e;
              if (row >= p.nq || col >= p.kv_valid_len || col - row > p.hi ||
                  row - col > p.lo) {  // bwd wide band mask
                pe = 0.f;
              }
            }
            sc[idx] = pe;
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
        if (!one_doc) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int2 qi = *reinterpret_cast<const int2*>(q_ids + 8 * jj);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (qi.x != kv_seg[r]) {  // bwd wide seg pair mask
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
      // The pair (key row R = warp * 16 + g + 8r, query columns 32c + 8jj +
      // 2t, + 1) of a [64][64] bf16 tile, the 128-byte swizzle's chunk order:
      // 16-byte chunk q of row R at q ^ (R % 8), R % 8 being g.
      auto pair_at = [&](unsigned char* tile, int jj, int r) {
        return reinterpret_cast<uint32_t*>(tile + (warp * 16 + g + 8 * r) * SW128_ROW +
                                           (((4 * c + jj) ^ g) << 4) + 4 * t);
      };
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *pair_at(smem + S::OFF_PT, jj, r) =
              pack_bf16(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]);
          if constexpr (!CAP) {
            ph[2 * jj + r] = pack_half(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]);
          }
        }
      }
      wgmma_wait<0>();  // dP^T has retired
      fence_regs(dp);
      // dS^T = P^T (dP^T - Delta) scale (CAP: ph's P^T (1 - t^2) makes it
      // dL^T (1 - t^2) scale), bf16, into its tile. BIAS with dbias: dL^T =
      // P^T (dP^T - Delta) from the f32 P^T, before the scale and the cap's
      // Jacobian, 8 lanes storing 8 keys of a row.
      float* db = nullptr;
      if constexpr (BIAS) {
        if (p.dbias != nullptr) {
          db = p.dbias + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + mc + 2 * t) * p.nk + kv0;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if constexpr (BIAS) {
            if (db != nullptr && kv0 + 8 * r < p.nk) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * jj + 2 * r + e;
                if (mc + 8 * jj + 2 * t + e < p.nq) {
                  __stcs(db + static_cast<int64_t>(8 * jj + e) * p.nk + 8 * r,
                         sc[i] * (dp[i] - (e ? dl.y : dl.x)));  // bwd wide dbias
                }
              }
            }
          }
          const float2 pv = unpack_half(ph[2 * jj + r]);
          *pair_at(smem + S::OFF_DS, jj, r) =
              pack_bf16(pv.x * (dp[4 * jj + 2 * r] - dl.x) * p.scale,
                        pv.y * (dp[4 * jj + 2 * r + 1] - dl.y) * p.scale);
        }
      }
      fence_proxy_async();
      if (issuer) bulk_wait_read();  // the last tile's reduction has read the dQ stage
      named_sync(1, 256);            // P^T and dS^T whole; the dQ stage free

      // dV += P^T dO and dK += dS^T Q on this consumer's 128 columns: A the
      // K-major [64 keys][64 queries] tile (k-step kk 32 bytes into its
      // rows), B the N-major boxes 2c and 2c + 1 (k-step kk 16 rows down).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW_BLOCK_M / 16; ++kk) {
        wgmma_ss_kn_m64n128k16(
            dv, at(kmaj, S::OFF_PT + kk * 32),
            at(nmaj, S::OFF_DO + (2 * c * BW_BLOCK_M + kk * 16) * SW128_ROW));
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BW_BLOCK_M / 16; ++kk) {
        wgmma_ss_kn_m64n128k16(
            dk, at(kmaj, S::OFF_DS + kk * 32),
            at(nmaj, S::OFF_Q + (2 * c * BW_BLOCK_M + kk * 16) * SW128_ROW));
      }
      wgmma_commit();

      // dQ = dS K, 64 query rows x this consumer's columns 128c + 64x.. in
      // two products: dS^T as the M-major A (k-step kk 16 keys down its rows),
      // K's box 2c + x as the N-major B.
      float dq[32];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BW_BLOCK_N / 16; ++kk) {
          wgmma_ss_tt_m64n64k16(
              dq, at(nmaj, S::OFF_DS + kk * 16 * SW128_ROW),
              at(nmaj, ((2 * c + x) * BW_BLOCK_N + kk * 16) * SW128_ROW), kk);
        }
        wgmma_commit();
        if (x == 0) {
          wgmma_wait<1>();  // dV and dK have retired
          fence_regs(dv);
          fence_regs(dk);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty);  // this warp is done with (Q, dO, LSE, Delta, ids)
        }
        wgmma_wait<0>();
        fence_regs(dq);
        // dq[4jj + 2r + e]: query row warp * 16 + g + 8r, column 128c + 64x +
        // 8jj + 2t + e, into the stage's row-major [64][d] (dQ's own layout).
        const int col0 = 128 * c + 64 * x;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* srow = dq_stage + (warp * 16 + g + 8 * r) * d + col0;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            if (col0 + 8 * jj + 2 * t >= d) continue;  // bwd wide dQ stage columns
            *reinterpret_cast<float2*>(srow + 8 * jj + 2 * t) =
                make_float2(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
          }
        }
      }
      fence_proxy_async();
      // The whole dQ tile is staged, and both consumers' products of this
      // tile have retired: P^T and dS^T are free for the next.
      named_sync(2, 256);
      if (issuer) {
        // Only the tile's rows below Nq: dQ is [B, Hq, Nq, d] contiguous, so
        // a full 64 rows on the last tile would add into the next head's.
        const int q_rows = min(BW_BLOCK_M, p.nq - m0);
        bulk_reduce_add_f32(p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m0) * d,
                            dq_stage, q_rows * d * 4);  // bwd wide dQ reduce
        bulk_commit();
      }
    }
    if (issuer) bulk_wait();

    // dK and dV of this thread's keys below Nk, columns 128c.. below d, per
    // query head (RING: per KV head, the grid's): dk[4jj + 2r + e] is key kv0
    // + 8r, column 128c + 8jj + 2t + e.
    const int64_t row0 = (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * p.nk + kv0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kv0 + 8 * r >= p.nk) continue;
      float* dk_row = p.dk + (row0 + 8 * r) * d + 128 * c;
      float* dv_row = p.dv + (row0 + 8 * r) * d + 128 * c;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        if (128 * c + 8 * jj + 2 * t >= d) continue;
        float2 k2 = make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        float2 v2 = make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
        if constexpr (RING) {  // K8: added to the ring's accumulators
          const float2 k0 = *reinterpret_cast<const float2*>(dk_row + 8 * jj + 2 * t);
          const float2 v0 = *reinterpret_cast<const float2*>(dv_row + 8 * jj + 2 * t);
          k2 = make_float2(k0.x + k2.x, k0.y + k2.y);
          v2 = make_float2(v0.x + v2.x, v0.y + v2.y);
        }
        *reinterpret_cast<float2*>(dk_row + 8 * jj + 2 * t) = k2;
        *reinterpret_cast<float2*>(dv_row + 8 * jj + 2 * t) = v2;  // bwd wide dV store
      }
    }
  }
}

}  // namespace
