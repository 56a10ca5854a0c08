// K8, one backward step of ring attention, for Hopper (sm_90a): a warp-
// specialised TMA + wgmma backward of the chunk pair, KV-major, with the dQ
// tile reduced into global memory by one bulk reduction, and the C entry
// fa_ring_bwd_bf16 (bf16, D <= 256; K8 on f32 is flash_bwd_f32.cu's
// fa_ring_bwd_f32).
//
// Replaces the TPU kernel flashattn_tpu/parallel/ring_kernel.py::
// _ring_bwd_kernel (K8, :389). At step s rank r holds the K/V chunk of rank
// (r - s) mod P and that chunk's rotating f32 (dK, dV) accumulators; one
// launch per live (rank, step) (the host runs the ring, ring_fwd.cu's header
// says how). With the GLOBAL LSE (natural log, -inf on a dead row) and Delta
// = rowsum(dO * O) it adds the chunk pair's
//   dV += P^T dO      dK += dS^T Q2      dQ += dS K
// with P = exp2(S2 - LSE log2 e), S2 = Q2 K^T (Q2 = q * scale * log2 e, so
// dQ comes out x 1/scale and dK x 1/ln2: ring_kernel.py:726, :934), dS = P
// (dP - Delta), dP = dO V^T, P exactly 0 outside the causal / window band in
// global positions (row q_base + i sees column kv_off + j iff row - lo <= col
// <= row + hi) and on a dead row (its LSE is replaced by +inf, so exp2(S2 -
// LSE) is exactly 0). dK / dV are summed over the rep = Hq / Hkv query heads
// of their KV head inside the CTA (GQA reduced in the kernel, as
// ring_kernel.py:118 folds it), so the rotating tile has one owner and no
// race; dQ goes into the rank's f32 dQ, zeroed once before the ring.
//
// What bounds it: at the LM's attention width a full off-diagonal 4096 x 4096
// chunk pair is 5 products, 344 GFLOP: operations, 0.35 ms at 989 TFLOP/s.
// The mma.sync design this replaces (64 KV rows per CTA, 32-row Q steps with
// three block barriers each, synchronous loads, dQ by one scalar f32 atomic
// per element: 537 M atomics per off-diagonal step) ran it at ~105 TFLOP/s.
// This design is FlashAttention-3's backward:
//
//   * One CTA owns 128 KV rows of one (batch, KV head): warpgroup 0 is the
//     producer (one thread issues every copy; setmaxnreg gives its registers
//     away), warpgroups 1 and 2 the consumers, 64 KV rows each, their f32 dK
//     and dV tiles in registers (128 a thread at D 128) from the rotating
//     accumulators' first read to their write back.
//   * K and V come once by TMA; the (Q2, dO) tiles of 64 query rows, with
//     their 64 LSE and Delta values (bulk copies completing on the same
//     barrier), stream through a 2-stage full / empty mbarrier ring, for each
//     query head of the KV head and each Q tile the band meets. The maps'
//     sequence extents are the chunks' nq / nk; boxes read zeros past D.
//   * Per consumer and Q tile: S^T = K Q2^T by wgmma m64n64k16 from shared
//     memory (K the K-major A, Q2 the K-major B) and P^T in registers,
//     rounded at once to bf16 (dV's A) and fp16 (for dS^T); then dP^T = V
//     dO^T (the same way) and dV += P^T dO (A from registers: the
//     accumulator layout is the A fragments'; dO the N-major B) together,
//     dS^T = P^T (dP^T - Delta), and dK += dS^T Q2 as dV. Issuing S^T and
//     dP^T together with the f32 P^T kept for dS^T spilled 204 bytes a
//     thread and ran the off-diagonal step in 1.29 ms; this order runs it in
//     0.97 (PERF.md §6, chip_variants.py).
//   * dQ = dS K by wgmma from shared memory: each consumer writes its bf16
//     dS^T rows once (128-byte swizzle, double-buffered) and, after a named
//     barrier, reads all 128 as the M-major A (transpose bit) against K as the
//     N-major B, each consumer for 64 of D's columns (at D <= 64 the first
//     alone). The f32 dQ tile is staged in shared memory and added to dQ's
//     64 rows by ONE cp.reduce.async.bulk .add.f32 per tile: the L2 does the
//     adds, 268 M per off-diagonal step at 128 KV rows a CTA (half what
//     64-row CTAs would make) in 32 KB requests instead of scalar atomics.
//   * Shared memory at D 128: K, V 64 KB; 2 x (Q2, dO) 64 KB; dS^T 2 x 16 KB;
//     the dQ stage 32 KB; 194 KB in all.
//
// At D 136-256 the f32 dK and dV of 64 KV rows per consumer would take 256
// registers a thread, past the 240 setmaxnreg gives, and the shared memory
// ~350 KB. A full off-diagonal chunk pair at B1 Hq8 Hkv4 D256 is 344 GFLOP,
// 0.35 ms at 989 TFLOP/s: operations. The D 256 form, ring_bwd_wide_kernel,
// is K3's D 256 body (bwd_sm90_wide.cuh) with RING: 64 keys a CTA, the two
// consumer warpgroups splitting D for dK / dV / dQ (128 f32 accumulators a
// thread for dK and dV) and the query columns for S^T / dP^T; the CTA is one
// per (KV head, 64 keys) and walks the Q tiles of each query head of its
// group in turn, so its dK / dV sum the group (GQA reduced in the CTA, one
// owner per accumulator tile) and are added into the rotating accumulators;
// q pre-scaled (scale = scale_log2 = 1), the band shifted by q_base - kv_off.

#include "bwd_sm90_wide.cuh"

namespace {

using namespace fa;

constexpr int RB_BLOCK_N = 128;  // KV rows per CTA: two consumer warpgroups of 64
constexpr int RB_BLOCK_M = 64;   // query rows per streamed tile
constexpr int RB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups

struct RingBwdParams {
  const float* lse;    // [B, Hq, nq] contiguous, natural log (-inf: dead row)
  const float* delta;  // [B, Hq, nq] contiguous
  float* dq;           // [B, Hq, nq, D] f32 contiguous, zeroed before the ring
  float* dk;           // [B, Hkv, nk, D] f32 contiguous: the rotating accumulators
  float* dv;
  int hq, rep, nq, nk, d;
  int q_base, kv_off;
  int lo, hi;
};

// Shared-memory layout (bytes, from a 1024-byte-aligned base): K and V (D /
// 64 boxes of 128 rows), 2 stages of (Q2, dO) (D / 64 boxes of 64 rows
// each), 2 dS^T buffers (128 KV rows x 64 query columns, 128-byte swizzle),
// the f32 dQ stage [64][d], the LSE and Delta rows [2][64] each, then the
// mbarriers kv_full, full[2], empty[2].
template <int D>
struct RbSmem {
  static constexpr int KV = RB_BLOCK_N * D * 2;
  static constexpr int QT = RB_BLOCK_M * D * 2;
  static constexpr int STAGE = 2 * QT;
  static constexpr int DST = RB_BLOCK_N * RB_BLOCK_M * 2;
  static constexpr int OFF_V = KV;
  static constexpr int OFF_STAGE = 2 * KV;
  static constexpr int OFF_DST = OFF_STAGE + 2 * STAGE;
  static constexpr int OFF_DQ = OFF_DST + 2 * DST;
  static constexpr int OFF_STATS = OFF_DQ + RB_BLOCK_M * D * 4;
  static constexpr int BARS = OFF_STATS + 2 * 2 * RB_BLOCK_M * 4;
  static constexpr int BYTES = 1024 + BARS + 5 * 8;
  static_assert(KV % 1024 == 0 && QT % 1024 == 0 && DST % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

template <int D>
__global__ void __launch_bounds__(RB_THREADS, 1)
    ring_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const RingBwdParams p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  using S = RbSmem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + 2;
  float* s_stats = reinterpret_cast<float*>(smem + S::OFF_STATS);  // lse[2][64], delta[2][64]

  const int hk = blockIdx.x;
  // A left bound alone: the late KV tiles meet the most Q tiles; run them first.
  const int n_tile = p.lo < NO_BOUND && p.hi >= NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int n0 = n_tile * RB_BLOCK_N;  // local KV row of the tile
  const int b = blockIdx.z;
  // The local Q tiles that meet the tile's band, global rows [c0 - hi,
  // c0 + 127 + lo]; none: the accumulator tile stays as it is.
  const int c0 = p.kv_off + n0;
  int m_begin = 0;
  int m_end = p.nq;
  if (p.hi < NO_BOUND) m_begin = max(0, c0 - p.hi - p.q_base) / RB_BLOCK_M * RB_BLOCK_M;
  if (p.lo < NO_BOUND) m_end = min(p.nq, c0 + RB_BLOCK_N + p.lo - p.q_base);
  if (m_end <= m_begin) return;
  const int n_m = (m_end - m_begin + RB_BLOCK_M - 1) / RB_BLOCK_M;
  const int total = p.rep * n_m;  // (query head, Q tile) pairs, head-major
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::OFF_STAGE + (j & 1) * S::STAGE; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 issues the copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * S::KV);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * RB_BLOCK_N * SW128_ROW, &tm_k, kv_full, 64 * x, n0, hk, b);
        tma_load_4d(smem + S::OFF_V + x * RB_BLOCK_N * SW128_ROW, &tm_v, kv_full, 64 * x, n0,
                    hk, b);
      }
      for (int j = 0; j < total; ++j) {
        const int s = j & 1;
        const int hr = j / n_m;
        const int m0 = m_begin + (j - hr * n_m) * RB_BLOCK_M;
        const int h = hk * p.rep + hr;
        unsigned char* st = stage(j);
        mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::QT + 2 * RB_BLOCK_M * 4);
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * RB_BLOCK_M * SW128_ROW, &tm_q, &full[s], 64 * x, m0, h, b);
          tma_load_4d(st + S::QT + x * RB_BLOCK_M * SW128_ROW, &tm_do, &full[s], 64 * x, m0, h,
                      b);
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.nq + m0;
        bulk_load(s_stats + s * RB_BLOCK_M, p.lse + row, RB_BLOCK_M * 4, &full[s]);
        bulk_load(s_stats + (2 + s) * RB_BLOCK_M, p.delta + row, RB_BLOCK_M * 4, &full[s]);
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
    const int cw = c0 + half * 64;         // global first KV row of this warpgroup
    const int kv0 = cw + warp * 16 + g;    // global KV row of this thread's row g
    const unsigned char* k_s = smem + half * 64 * SW128_ROW;
    const unsigned char* v_s = smem + S::OFF_V + half * 64 * SW128_ROW;
    float* dq_stage = reinterpret_cast<float*>(smem + S::OFF_DQ);
    // The thread that issues the dQ reductions (warp 0 of warpgroup 1).
    const bool issuer_warp = half == 0 && warp == 0;
    const bool issuer = issuer_warp && lane == 0;
    const bool does_dq = half < BOXES;  // this warpgroup's 64 columns of dQ

    // This thread's rows of the rotating accumulators: rows g and g + 8 of
    // its warp's 16, columns 8jj + 2t, +1 (the accumulator layout).
    const int64_t acc_row0 =
        (static_cast<int64_t>(b) * (p.hq / p.rep) + hk) * p.nk + n0 + half * 64 + warp * 16 + g;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* dk_row = p.dk + (acc_row0 + 8 * r) * p.d;
      const float* dv_row = p.dv + (acc_row0 + 8 * r) * p.d;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        float2 a = make_float2(0.f, 0.f);
        float2 c = make_float2(0.f, 0.f);
        if (col < p.d) {
          a = *reinterpret_cast<const float2*>(dk_row + col);
          c = *reinterpret_cast<const float2*>(dv_row + col);
        }
        dk[4 * jj + 2 * r] = a.x;
        dk[4 * jj + 2 * r + 1] = a.y;
        dv[4 * jj + 2 * r] = c.x;
        dv[4 * jj + 2 * r + 1] = c.y;
      }
    }

    mbar_wait(kv_full, 0);
    for (int j = 0; j < total; ++j) {
      const int s = j & 1;
      const int hr = j / n_m;
      const int m0 = m_begin + (j - hr * n_m) * RB_BLOCK_M;
      const int h = hk * p.rep + hr;
      const unsigned char* q_st = stage(j);
      const unsigned char* do_st = q_st + S::QT;
      mbar_wait(&full[s], (j >> 1) & 1);

      // S^T = K Q2^T (log2 domain): rows are this warpgroup's KV rows,
      // columns the tile's 64 query rows.
      float sc[32], dp[32];
      issue_qk<D, RB_BLOCK_N, RB_BLOCK_M>(sc, k_s, q_st);
      wgmma_wait<0>();
      fence_regs(sc);

      // P^T = exp2(S2^T - LSE log2 e): sc[4jj + 2r + e] is KV row kv0 + 8r,
      // query column 8jj + 2t + e; a dead row's LSE becomes +inf (P = 0).
      const int r0 = p.q_base + m0;
      const bool edge = cw + 63 - r0 > p.hi || r0 + 63 - cw > p.lo;
      const uint32_t lse_addr = smem_u32(s_stats + s * RB_BLOCK_M + 2 * t);
      const uint32_t dlt_addr = smem_u32(s_stats + (2 + s) * RB_BLOCK_M + 2 * t);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 lv = lds_f2(lse_addr + 32 * jj);
        float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
#pragma unroll
        for (int e = 0; e < 2; ++e) l2[e] = l2[e] <= NEG_GUARD ? INFINITY : l2[e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * r + e;
            float pe = ex2(sc[i] - l2[e]);
            if (edge) {
              const int col = kv0 + 8 * r;
              const int row = r0 + 8 * jj + 2 * t + e;
              if (col - row > p.hi || row - col > p.lo) pe = 0.f;
            }
            sc[i] = pe;
          }
        }
      }
      // P^T in bf16 (the A fragments of dV's product) and in fp16 (for dS^T)
      // before dP^T = V dO^T is issued: the f32 S^T / P^T and dP^T tiles are
      // never live together, which keeps the consumers near their 240
      // registers (PERF.md §6), and fp16's 10-bit mantissa keeps dS^T as
      // close to the f32 P^T's as makes no difference, where bf16's 7 bits
      // cost dQ / dK 40% of relative error. dV += P^T dO runs beside dP^T.
      uint32_t pa[4][4], ph[16], da[4][4];
      pack_p(pa, sc);
#pragma unroll
      for (int i = 0; i < 16; ++i) ph[i] = pack_half(sc[2 * i], sc[2 * i + 1]);
      issue_qk<D, RB_BLOCK_N, RB_BLOCK_M>(dp, v_s, do_st);
      issue_pv<D, RB_BLOCK_M>(dv, pa, do_st);
      wgmma_wait<1>();  // dP^T has retired
      fence_regs(dp);
      // dS^T = P^T (dP^T - Delta), in place of dP^T (no scale: Q2 carries it);
      // ph[2jj + r] holds row g + 8r, columns 8jj + 2t and + 1.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 pv = unpack_half(ph[2 * jj + r]);
          dp[4 * jj + 2 * r] = pv.x * (dp[4 * jj + 2 * r] - dl.x);
          dp[4 * jj + 2 * r + 1] = pv.y * (dp[4 * jj + 2 * r + 1] - dl.y);
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
      issue_pv<D, RB_BLOCK_M>(dk, da, q_st);

      // dQ (64 query rows x this warpgroup's 64 columns) = dS K over the
      // tile's 128 KV rows: dS^T as the M-major A, K as the N-major B.
      float dq[32];
      if (does_dq) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < RB_BLOCK_N / 16; ++kk) {
          wgmma_ss_tt_m64n64k16(
              dq, smem_desc(dst + kk * 16 * SW128_ROW, RB_BLOCK_N * SW128_ROW, 1024),
              smem_desc(smem + half * RB_BLOCK_N * SW128_ROW + kk * 16 * SW128_ROW,
                        RB_BLOCK_N * SW128_ROW, 1024),
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
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with (Q2, dO, LSE, Delta)

      if (does_dq) {
        wgmma_wait<0>();
        fence_regs(dq);
        // dq[4jj + 2r + e]: query row warp * 16 + g + 8r, column half * 64 +
        // 8jj + 2t + e, into the stage's row-major [64][d] (dQ's own layout).
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* srow = dq_stage + (warp * 16 + g + 8 * r) * p.d + half * 64;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 8 * jj + 2 * t;
            if (half * 64 + col < p.d) {
              *reinterpret_cast<float2*>(srow + col) =
                  make_float2(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
            }
          }
        }
        fence_proxy_async();
      }
      if (issuer_warp) {
        named_sync(2, 256);  // the whole dQ tile is staged
        if (lane == 0) {
          bulk_reduce_add_f32(p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m0) * p.d,
                              dq_stage, RB_BLOCK_M * p.d * 4);  // K8 dQ reduce
          bulk_commit();
        }
      } else {
        named_arrive(2, 256);
      }
    }
    if (issuer) bulk_wait();

    // The accumulator tile back into the rotating buffers.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dk_row = p.dk + (acc_row0 + 8 * r) * p.d;
      float* dv_row = p.dv + (acc_row0 + 8 * r) * p.d;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<float2*>(dk_row + col) =
              make_float2(dk[4 * jj + 2 * r], dk[4 * jj + 2 * r + 1]);
          *reinterpret_cast<float2*>(dv_row + col) =
              make_float2(dv[4 * jj + 2 * r], dv[4 * jj + 2 * r + 1]);
        }
      }
    }
  }
}

// K8 at D 136-256: the D 256 form of K3 (bwd_sm90_wide.cuh) with RING -- a
// CTA per (KV head, 64 keys) walking its group's query heads, dK / dV added
// into the ring's accumulators -- on the chunk pair, the band shifted by
// q_base - kv_off and q pre-scaled (scale = scale_log2 = 1).
__global__ void __launch_bounds__(BB_THREADS, 1)
    ring_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const BwdDenseParams p) {
  bwd_wide_body<false, false, false, true>(tm_q, tm_k, tm_v, tm_do, p);
}

template <int D>
cudaError_t ring_bwd_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                            const RingBwdParams& p, int hkv, int batch, cudaStream_t stream) {
  auto kernel = ring_bwd_sm90_kernel<D>;
  const cudaError_t e = allow_smem(kernel, RbSmem<D>::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(hkv, p.nk / RB_BLOCK_N, batch);
  kernel<<<grid, RB_THREADS, RbSmem<D>::BYTES, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: one ring backward step of one rank. q (q * scale * log2 e) / dout
// [B, Hq, nq, D] and k/v [B, Hkv, nk, D] bf16 with unit stride on D and the
// given (batch, head, seq) strides in elements (k and v share theirs;
// multiples of 8, nonzero on dims of extent > 1; 16-byte-aligned bases:
// TMA's); lse (natural log, -inf on a dead row) and delta [B, Hq, nq] f32
// contiguous; dq [B, Hq, nq, D] f32 contiguous, added to by bulk reductions
// (zero it before the ring); dk/dv [B, Hkv, nk, D] f32 contiguous, read,
// accumulated over the query heads of each KV head and written back; lse,
// delta and dq 16-byte aligned. dq comes out x 1/scale and dk x 1/ln2 of the
// gradients (q carries scale * log2 e). Positions, band and requirements as
// fa_ring_fwd_bf16, D <= 256: above 128 the D 256 form (ring_bwd_wide_kernel,
// 64 keys a CTA). Returns a cudaError_t (0: success; cudaErrorInvalidValue
// for arguments it does not take, cudaErrorNotSupported when
// cuTensorMapEncodeTiled is missing or refuses a tensor map).
int fa_ring_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* dk, void* dv, int batch,
                     int hq, int hkv, int nq, int nk, int d, int q_base, int kv_off, int causal,
                     int wl, int wr, int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb,
                     int64_t kv_sh, int64_t kv_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                     void* stream) {
  if (batch < 1 || batch > 65535 || d < 8 || d > 256 || d % 8 || hkv < 1 || hq < 1 ||
      hq % hkv || nq < RB_BLOCK_N || nk < RB_BLOCK_N || nq % RB_BLOCK_N || nk % RB_BLOCK_N ||
      nk / BW_BLOCK_N > 65535 || !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) ||
      !aligned(dout, 16) || !aligned(lse, 16) || !aligned(delta, 16) || !aligned(dq, 16) ||
      !aligned(dk, 8) || !aligned(dv, 8) || !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(kv_sb, batch, kv_sh, hkv, kv_sn, nk) ||
      !tma_strides(do_sb, batch, do_sh, hq, do_sn, nq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int kv_rows = d > 128 ? BW_BLOCK_N : RB_BLOCK_N;  // keys a CTA, the K / V boxes' rows
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, RB_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn, kv_rows) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn, kv_rows) ||
      !make_bhnd_map(&tm_do, dout, batch, hq, nq, d, do_sb, do_sh, do_sn, RB_BLOCK_M)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128) {
    // K3's parameters: the band in the chunks' local positions, no tail, q
    // pre-scaled, the LSE and Delta rows unpadded (nq a multiple of 64).
    BwdDenseParams p = {};
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dq = static_cast<float*>(dq);
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    p.hq = hq;
    p.rep = hq / hkv;
    p.nq = nq;
    p.nq_pad = nq;
    p.nk = nk;
    p.kv_valid_len = nk;
    p.d = d;
    band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_base) - kv_off);
    p.scale = 1.f;
    p.scale_log2 = 1.f;
    const cudaError_t e = allow_smem(ring_bwd_wide_kernel, BwSmem::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(hkv, nk / BW_BLOCK_N, batch);
    ring_bwd_wide_kernel<<<grid, BB_THREADS, BwSmem::BYTES, s>>>(tm_q, tm_k, tm_v, tm_do, p);
    return static_cast<int>(cudaGetLastError());
  }
  RingBwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.q_base = q_base;
  p.kv_off = kv_off;
  band_bounds(causal, wl, wr, &p.lo, &p.hi);
  const cudaError_t e =
      d <= 64 ? ring_bwd_launch<64>(tm_q, tm_k, tm_v, tm_do, p, hkv, batch, s)
              : ring_bwd_launch<128>(tm_q, tm_k, tm_v, tm_do, p, hkv, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
