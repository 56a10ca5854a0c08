// K5 + K6 with an additive bias for Hopper (sm_90a): one warp-specialised
// TMA + wgmma backward that writes dQ, dK, dV and, when the bias needs a
// gradient, dbias in a single KV-major pass, and the C entry
// fa_bwd_bias_sm90.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5,
// :139) and ::_dq_kernel (K6, :234) on the calls whose forward took K1's bias
// route (ops/flash_bwd.py::bias_bwd_route: bf16, D 64 or 128, a bias, no
// softcap, segment ids or window, not decode-shaped). With the forward's LSE
// (natural log; ln2 * mask on a row the bias kills) and Delta = rowsum(dO *
// O) it computes, for each (query row i, key j) that attends,
//   x = S scale log2 e + bias log2 e, floored at the mask value (K1's bias
//       route forms it so: fwd_bias_tile.cuh), S = Q K^T on the unscaled Q;
//   P = exp2(x - LSE log2 e), exactly 0 on keys at or past kv_valid_len, on
//       rows past Nq, above the top-left causal diagonal and on a dead row
//       (LSE log2 e <= mask / 2: K5 / K6's test);
//   dL = P (dP - Delta), dP = dO V^T;  dS = dL scale;
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,  dbias = dL (f32, before scale:
//       the JAX kernel's, flash_bwd.py:97-98, :135, :300-302).
// dK / dV come per KV head (summed over its Hq / Hkv query heads inside the
// CTA); dQ is added into a zeroed f32 dQ; dbias is written on every (Q tile,
// KV tile) pair the kernel visits (the caller zero-fills it when causal or
// kv_valid_len < Nk leaves pairs unvisited).
//
// What bounds it: at path A's shape (B4 H16 N2048 D128, non-causal) the five
// products are 344 GFLOP, 0.35 ms at 989 TFLOP/s: operations, with the mask
// arm's [4, 1, N, N] bias (67 MB); the learned arm's [4, 16, N, N] bias and
// its dbias are 1.07 GB each way, 0.64 ms at 3.35 TB/s: bytes. The mma.sync
// pair this replaces (K5 in dkv_tile.cuh, 4 warps x 16 KV rows per CTA with
// 32-row Q steps between block barriers and one dependent scalar __ldg of
// the bias per score; K6 in dq_tile.cuh recomputing S and dP: 7 products
// where a KV-major pass needs 5) ran it at 58 / 83 TFLOP/s. The design is
// K8's (ring_bwd.cu, FlashAttention-3's backward), with the bias streamed
// beside the (Q, dO) tiles:
//
//   * One CTA owns 128 KV rows of one (batch, KV head): warpgroup 0 is the
//     producer (one thread issues every copy; setmaxnreg gives its registers
//     away), warpgroups 1 and 2 the consumers, 64 KV rows each, their f32 dK
//     and dV tiles in registers across every query head of the KV head and
//     every Q tile that causal leaves. Grid (KV head, KV tile, batch): the
//     head varies fastest, so the CTAs that share a [B, 1, N, N] bias tile
//     stream it together and read it from HBM once.
//   * K and V come once by TMA (sequence extent kv_valid_len: zeros past it,
//     so a key the forward never read cannot put a NaN into dQ); the (Q, dO)
//     tiles of 64 query rows, with their LSE and Delta (bulk copies from rows
//     the caller pads to a multiple of 64), stream through a 2-stage
//     full / empty mbarrier ring.
//   * The bias tile, 64 query rows x 128 keys of f32 (32 KB), comes by TMA
//     too, as 4 boxes of 32 columns with the 128-byte swizzle: a broadcast
//     dim of the bias is a dim of extent 1 in its map (coordinate 0), which
//     TMA takes where it would refuse a zero stride, and a row-broadcast
//     [B, H, 1, Nk] bias is one row a box. Columns past kv_valid_len and
//     rows past Nq read zeros. The swizzle puts 16-byte chunk c of row r at
//     c ^ (r % 8), so the 4 query rows a consumer warp reads at once (2t + e)
//     land on 4 distinct pairs of chunks: 32 banks, no conflict. One thread
//     issues the copies, so the producer keeps 24 registers and the
//     consumers K8's 240 (cp.async from 128 producer threads, as K1's bias
//     route streams its bias, would need registers the consumers cannot
//     spare: K8 already spills 56 B at 240).
//   * Shared memory at D 128: K, V 64 KB; 2 x (Q, dO) 64 KB; dS^T 2 x 16 KB;
//     the dQ stage 32 KB; one bias stage 32 KB: 226 KB of the 227. So the
//     bias has one stage of its own (two at D 64, where everything else
//     halves), on its own full / empty barriers: each consumer warp releases
//     it as soon as P^T is formed, and the producer refills it with the next
//     tile's bias while dP^T, dV, dK and dQ of this tile run.
//   * Per consumer and Q tile, K8's order: S^T = K Q^T by wgmma from shared
//     memory; P^T in registers, rounded at once to bf16 (dV's A) and fp16
//     (for dS^T: bf16's 7 mantissa bits put dQ / dK 40% further off in K8);
//     then dP^T = V dO^T and dV += P^T dO (A from registers) together;
//     dL^T = P^T (dP^T - Delta), stored as dbias straight from the
//     accumulator fragments (8 lanes write 32 contiguous bytes of one dbias
//     row: whole sectors, streaming stores) before dS^T = dL^T scale is
//     packed; dK += dS^T Q.
//   * dQ = dS K by wgmma from the double-buffered bf16 dS^T in shared memory
//     (M-major A) against K (N-major B), each consumer for 64 of D's
//     columns, staged as f32 [64][D] and added to dQ by ONE
//     cp.reduce.async.bulk per tile of the tile's q_rows * D * 4 bytes: a
//     full 64 rows on the last, partial Q tile would add into the next
//     head's rows.

#include "sm90.cuh"

namespace {

using namespace fa;

constexpr int BB_BLOCK_N = 128;  // KV rows per CTA: two consumer warpgroups of 64
constexpr int BB_BLOCK_M = 64;   // query rows per streamed tile
constexpr int BB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int BB_BIAS_BOX = 32;  // f32 columns per bias box: the 128-byte swizzle's span
constexpr float NEG_GUARD = 0.5f * MASK_VALUE;

struct BwdBiasParams {
  const float* lse;    // [B, Hq, nq_pad] f32, natural log (ln2 * mask: a dead row)
  const float* delta;  // [B, Hq, nq_pad] f32
  float* dq;           // [B, Hq, Nq, D] f32 contiguous, zeroed
  float* dk;           // [B, Hkv, Nk, D] f32 contiguous, written
  float* dv;
  float* dbias;        // [B, Hq, Nq, Nk] f32 contiguous (the DBIAS instantiations)
  int hq, rep, nq, nq_pad, nk, kv_valid_len, causal;
  int bias_rows;       // rows of a bias box: 64, or 1 for a row-broadcast bias
  int bias_b, bias_h;  // whether the bias has the batch / head dim (else: coordinate 0)
  float scale, scale_log2;
};

// Shared-memory layout (bytes, from a 1024-byte-aligned base): K and V (D /
// 64 boxes of 128 rows), 2 stages of (Q, dO) (D / 64 boxes of 64 rows each),
// 2 dS^T buffers (128 KV rows x 64 query columns, 128-byte swizzle), the f32
// dQ stage [64][D], BSTAGES bias tiles (4 boxes of 64 rows x 32 f32), the LSE
// and Delta rows [2][64] each, then the mbarriers kv_full, full[2], empty[2],
// bias_full[BSTAGES], bias_empty[BSTAGES].
template <int D>
struct BbSmem {
  static constexpr int BSTAGES = D == 64 ? 2 : 1;
  static constexpr int KV = BB_BLOCK_N * D * 2;
  static constexpr int QT = BB_BLOCK_M * D * 2;
  static constexpr int STAGE = 2 * QT;
  static constexpr int DST = BB_BLOCK_N * BB_BLOCK_M * 2;
  static constexpr int BIAS_BOX = BB_BLOCK_M * BB_BIAS_BOX * 4;
  static constexpr int BIAS = BB_BLOCK_M * BB_BLOCK_N * 4;
  static constexpr int OFF_V = KV;
  static constexpr int OFF_STAGE = 2 * KV;
  static constexpr int OFF_DST = OFF_STAGE + 2 * STAGE;
  static constexpr int OFF_DQ = OFF_DST + 2 * DST;
  static constexpr int OFF_BIAS = OFF_DQ + BB_BLOCK_M * D * 4;
  static constexpr int OFF_STATS = OFF_BIAS + BSTAGES * BIAS;
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

template <int D, bool DBIAS>
__global__ void __launch_bounds__(BB_THREADS, 1)
    bwd_bias_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_bias, const BwdBiasParams p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  using S = BbSmem<D>;
  constexpr int BOXES = D / 64;
  constexpr int BST = S::BSTAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + 2;
  uint64_t* bias_full = empty + 2;
  uint64_t* bias_empty = bias_full + BST;
  float* s_stats = reinterpret_cast<float*>(smem + S::OFF_STATS);  // lse[2][64], delta[2][64]

  const int hk = blockIdx.x;
  const int n0 = blockIdx.y * BB_BLOCK_N;  // first KV row of the tile
  const int b = blockIdx.z;
  // The Q tiles that meet the tile (top-left causal: rows from n0 on); none
  // when the tile lies past kv_valid_len -- its dK / dV rows are then zeros.
  const int m_begin = p.causal ? n0 : 0;
  const int n_m =
      n0 < p.kv_valid_len && m_begin < p.nq ? (p.nq - m_begin + BB_BLOCK_M - 1) / BB_BLOCK_M : 0;
  const int total = p.rep * n_m;  // (query head, Q tile) pairs, head-major
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::OFF_STAGE + (j & 1) * S::STAGE; };
  auto bias_tile = [&](int j) { return smem + S::OFF_BIAS + (j % BST) * S::BIAS; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < BST; ++s) {
      mbar_init(&bias_full[s], 1);
      mbar_init(&bias_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 issues the copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && total > 0) {
      mbar_expect_tx(kv_full, 2 * S::KV);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * BB_BLOCK_N * SW128_ROW, &tm_k, kv_full, 64 * x, n0, hk, b);
        tma_load_4d(smem + S::OFF_V + x * BB_BLOCK_N * SW128_ROW, &tm_v, kv_full, 64 * x, n0,
                    hk, b);
      }
      const uint32_t bias_bytes = BB_BLOCK_N / BB_BIAS_BOX * p.bias_rows * SW128_ROW;
      for (int j = 0; j < total; ++j) {
        const int s = j & 1;
        const int hr = j / n_m;
        const int m0 = m_begin + (j - hr * n_m) * BB_BLOCK_M;
        const int h = hk * p.rep + hr;
        unsigned char* st = stage(j);
        mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::QT + 2 * BB_BLOCK_M * 4);
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * BB_BLOCK_M * SW128_ROW, &tm_q, &full[s], 64 * x, m0, h, b);
          tma_load_4d(st + S::QT + x * BB_BLOCK_M * SW128_ROW, &tm_do, &full[s], 64 * x, m0, h,
                      b);
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.nq_pad + m0;
        bulk_load(s_stats + s * BB_BLOCK_M, p.lse + row, BB_BLOCK_M * 4, &full[s]);
        bulk_load(s_stats + (2 + s) * BB_BLOCK_M, p.delta + row, BB_BLOCK_M * 4, &full[s]);
        const int bs = j % BST;
        mbar_wait(&bias_empty[bs], ((j / BST) & 1) ^ 1);
        mbar_expect_tx(&bias_full[bs], bias_bytes);
        unsigned char* bt = bias_tile(j);
#pragma unroll
        for (int x = 0; x < BB_BLOCK_N / BB_BIAS_BOX; ++x) {
          tma_load_4d(bt + x * S::BIAS_BOX, &tm_bias, &bias_full[bs], n0 + BB_BIAS_BOX * x,
                      p.bias_rows == 1 ? 0 : m0, p.bias_h ? h : 0, p.bias_b ? b : 0);
        }
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

    // The bias of S^T's element (KV row g + 8r, query column 8jj + 2t + e) in
    // the swizzled tile: box (its KV column) / 32, row 8jj + 2t + e (row 0
    // of a row-broadcast bias), chunk c ^ (row % 8) with row % 8 = 2t + e.
    const bool bias_rows = p.bias_rows != 1;
    const uint32_t jj_step = bias_rows ? 8 * SW128_ROW : 0;
    uint32_t b_off[2][2];
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

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (total > 0) mbar_wait(kv_full, 0);
    for (int j = 0; j < total; ++j) {
      const int s = j & 1;
      const int hr = j / n_m;
      const int m0 = m_begin + (j - hr * n_m) * BB_BLOCK_M;
      const int h = hk * p.rep + hr;
      const unsigned char* q_st = stage(j);
      const unsigned char* do_st = q_st + S::QT;
      mbar_wait(&full[s], (j >> 1) & 1);

      // S^T = K Q^T: rows are this warpgroup's KV rows, columns the tile's
      // 64 query rows.
      float sc[32], dp[32];
      issue_qk<D, BB_BLOCK_N, BB_BLOCK_M>(sc, k_s, q_st);
      const int bs = j % BST;
      mbar_wait(&bias_full[bs], (j / BST) & 1);
      wgmma_wait<0>();
      fence_regs(sc);

      // P^T: sc[4jj + 2r + e] is KV row kv0 + 8r, query row m0 + 8jj + 2t + e;
      // a dead row's LSE becomes +inf (P = 0 exactly).
      const bool edge = m0 + BB_BLOCK_M > p.nq || cw + 64 > p.kv_valid_len ||
                        (p.causal && m0 < cw + 63);
      const uint32_t lse_addr = smem_u32(s_stats + s * BB_BLOCK_M + 2 * t);
      const uint32_t dlt_addr = smem_u32(s_stats + (2 + s) * BB_BLOCK_M + 2 * t);
      const uint32_t bias_addr = smem_u32(bias_tile(j));
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
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * r + e;
            const float bv = lds_f1(bias_addr + b_off[r][e] + jj * jj_step);
            const float x = fmaxf(sc[i] * p.scale_log2 + bv * LOG2E, MASK_VALUE);
            float pe = ex2(x - l2[e]);
            if (edge) {
              const int col = kv0 + 8 * r;
              const int row = m0 + 8 * jj + 2 * t + e;
              if (row >= p.nq || col >= p.kv_valid_len || (p.causal && col > row)) pe = 0.f;
            }
            sc[i] = pe;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&bias_empty[bs]);  // this warp is done with the bias tile

      // P^T in bf16 (the A fragments of dV's product) and in fp16 (for dS^T)
      // before dP^T = V dO^T is issued, as K8 orders them.
      uint32_t pa[4][4], ph[16], da[4][4];
      pack_p(pa, sc);
#pragma unroll
      for (int i = 0; i < 16; ++i) ph[i] = pack_half(sc[2 * i], sc[2 * i + 1]);
      issue_qk<D, BB_BLOCK_N, BB_BLOCK_M>(dp, v_s, do_st);
      issue_pv<D, BB_BLOCK_M>(dv, pa, do_st);
      wgmma_wait<1>();  // dP^T has retired
      fence_regs(dp);
      // dL^T = P^T (dP^T - Delta) is dbias; dS^T = dL^T scale in place of
      // dP^T. ph[2jj + r] holds row g + 8r, columns 8jj + 2t and + 1.
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
            const int row = m0 + 8 * jj + 2 * t;
            if (kv0 + 8 * r < p.nk) {
              float* dst = db_row + (8 * jj + 2 * t) * p.nk + 8 * r;
              if (row < p.nq) __stcs(dst, d0);
              if (row + 1 < p.nq) __stcs(dst + p.nk, d1);
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
        // 8jj + 2t + e, into the stage's row-major [64][D] (dQ's own layout).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* srow = dq_stage + (warp * 16 + g + 8 * r) * D + half * 64;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            *reinterpret_cast<float2*>(srow + 8 * jj + 2 * t) =
                make_float2(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
          }
        }
        fence_proxy_async();
      }
      if (issuer_warp) {
        named_sync(2, 256);  // the whole dQ tile is staged
        if (lane == 0) {
          // Only the tile's rows below Nq: dQ is [B, Hq, Nq, D] contiguous, so
          // a full 64 rows on the last tile would add into the next head's.
          const int q_rows = min(BB_BLOCK_M, p.nq - m0);
          bulk_reduce_add_f32(p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m0) * D,
                              dq_stage, q_rows * D * 4);  // bias bwd dQ reduce
          bulk_commit();
        }
      } else {
        named_arrive(2, 256);
      }
    }
    if (issuer) bulk_wait();

    // The tile's dK / dV rows below Nk (zeros past kv_valid_len: P is 0 there).
    const int64_t row0 = (static_cast<int64_t>(b) * (p.hq / p.rep) + hk) * p.nk + kv0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kv0 + 8 * r >= p.nk) continue;
      float* dk_row = p.dk + (row0 + 8 * r) * D;
      float* dv_row = p.dv + (row0 + 8 * r) * D;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        *reinterpret_cast<float2*>(dk_row + 8 * jj + 2 * t) =
            make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
        *reinterpret_cast<float2*>(dv_row + 8 * jj + 2 * t) =
            make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool DBIAS>
cudaError_t bwd_bias_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                            const CUtensorMap& tm_bias, const BwdBiasParams& p, int hkv,
                            int batch, cudaStream_t stream) {
  auto kernel = bwd_bias_sm90_kernel<D, DBIAS>;
  const cudaError_t e = allow_smem(kernel, BbSmem<D>::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv, (p.nk + BB_BLOCK_N - 1) / BB_BLOCK_N, batch);
  kernel<<<grid, BB_THREADS, BbSmem<D>::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_bias, p);
  return cudaGetLastError();
}

// The bias's TMA map: an f32 [B|1, H|1, Nq|1, Nk] tensor read through its
// (batch, head, row) strides in elements, a stride of 0 marking a broadcast
// dim, which becomes a dim of extent 1 (its coordinate always 0); the column
// extent is kv_valid_len, so columns past it and rows past Nq read zeros.
// Boxes of 32 columns x `rows` rows with the 128-byte swizzle.
bool make_bias_map(CUtensorMap* map, const void* bias, int batch, int heads, int nq, int ncols,
                   int64_t sb, int64_t sh, int64_t sn, int rows) {
  auto extent = [](int64_t s, int n) { return static_cast<cuuint64_t>(s ? n : 1); };
  auto bytes = [](int64_t s) { return static_cast<cuuint64_t>(s ? s * 4 : 16); };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ncols), extent(sn, nq), extent(sh, heads),
                              extent(sb, batch)};
  const cuuint64_t strides[3] = {bytes(sn), bytes(sh), bytes(sb)};
  const cuuint32_t box[4] = {BB_BIAS_BOX, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(bias), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// K5 + K6 with a bias: dQ, dK, dV (and dbias) of attention with an additive
// f32 bias. q / dout [B, Hq, Nq, D] and k / v [B, Hkv, Nk, D] bf16, unit
// stride on D, the given (batch, head, seq) strides in elements (multiples
// of 8, nonzero on dims of extent > 1; 16-byte-aligned bases: TMA's); lse
// (natural log, from the forward) and delta [B, Hq, nq_pad] f32 contiguous,
// nq_pad a multiple of 64 >= Nq (the rows past Nq are read and not used),
// 16-byte aligned; bias [B|1, Hq|1, Nq|1, Nk] f32, unit column stride,
// (batch, head, row) strides in elements, 0 on broadcast dims, multiples of
// 4, 16-byte-aligned base; dq [B, Hq, Nq, D] f32 contiguous, zeroed (added
// to), 16-byte aligned; dk / dv [B, Hkv, Nk, D] f32 contiguous, written
// (summed over each KV head's query heads), 8-byte aligned; dbias null, or
// [B, Hq, Nq, Nk] f32 contiguous, written on every (64-row Q tile, 128-row KV
// tile) pair that causal and kv_valid_len leave (zero it first otherwise).
// Requires D 64 or 128, Hq % Hkv == 0, Nq, Nk >= 1, 0 <= kv_valid_len <= Nk,
// B <= 65535. causal != 0 masks kv_pos > q_pos (top-left, zero offsets).
// Returns a cudaError_t (0: success; cudaErrorInvalidValue for arguments it
// does not take, cudaErrorNotSupported when cuTensorMapEncodeTiled is
// missing or refuses a tensor map).
int fa_bwd_bias_sm90(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* bias, void* dq, void* dk,
                     void* dv, void* dbias, int batch, int hq, int hkv, int nq, int nk, int d,
                     int kv_valid_len, int causal, int nq_pad, float scale, int64_t q_sb,
                     int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                     int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh,
                     int64_t do_sn, int64_t bias_sb, int64_t bias_sh, int64_t bias_sn,
                     void* stream) {
  // The K/V and bias maps' key extent (at least 1: a map has no empty dim;
  // with kv_valid_len 0 no tile is loaded).
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  if ((d != 64 && d != 128) || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || nk < 1 || (nk + BB_BLOCK_N - 1) / BB_BLOCK_N > 65535 ||
      kv_valid_len < 0 || kv_valid_len > nk || nq_pad < nq || nq_pad % BB_BLOCK_M ||
      bias == nullptr || !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) ||
      !aligned(dout, 16) || !aligned(lse, 16) || !aligned(delta, 16) || !aligned(bias, 16) ||
      !aligned(dq, 16) || !aligned(dk, 8) || !aligned(dv, 8) || !aligned(dbias, 4) ||
      !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(k_sb, batch, k_sh, hkv, k_sn, nkv) ||
      !tma_strides(v_sb, batch, v_sh, hkv, v_sn, nkv) ||
      !tma_strides(do_sb, batch, do_sh, hq, do_sn, nq) || bias_sb % 4 || bias_sh % 4 ||
      bias_sn % 4 || bias_sb < 0 || bias_sh < 0 || bias_sn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int bias_rows = bias_sn ? BB_BLOCK_M : 1;
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  alignas(64) CUtensorMap tm_bias;
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, BB_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nkv, d, k_sb, k_sh, k_sn, BB_BLOCK_N) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nkv, d, v_sb, v_sh, v_sn, BB_BLOCK_N) ||
      !make_bhnd_map(&tm_do, dout, batch, hq, nq, d, do_sb, do_sh, do_sn, BB_BLOCK_M) ||
      !make_bias_map(&tm_bias, bias, batch, hq, nq, nkv, bias_sb, bias_sh, bias_sn, bias_rows)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  BwdBiasParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dbias = static_cast<float*>(dbias);
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq_pad;
  p.nk = nk;
  p.kv_valid_len = kv_valid_len;
  p.causal = causal != 0;
  p.bias_rows = bias_rows;
  p.bias_b = bias_sb != 0;
  p.bias_h = bias_sh != 0;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (d == 64) {
    e = dbias ? bwd_bias_launch<64, true>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s)
              : bwd_bias_launch<64, false>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s);
  } else {
    e = dbias ? bwd_bias_launch<128, true>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s)
              : bwd_bias_launch<128, false>(tm_q, tm_k, tm_v, tm_do, tm_bias, p, hkv, batch, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
