// The f32 attention backward for Hopper (sm_90a): one body for K3 and for
// K5 + K6 without a bias on f32 inputs (flash_bwd_f32.cu), KV-major, one
// launch writing dQ, dK and dV to f32 accuracy, as the TPU kernels compute
// their f32 calls at Precision.HIGHEST.
//
// Replaces, on f32 inputs, flashattn_tpu/ops/flash_bwd_fused.py::
// _bwd_fused_kernel (K3, :110) and _bwd_causal_resident_kernel (K4, :336),
// and flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5, :139) with _dq_kernel
// (K6, :234) without a bias. With the forward's LSE (natural log; ln2 * mask
// on a dead row) and Delta = rowsum(dO * O) it computes what bwd_sm90_tile.cuh
// computes for K3 and the split route, for each (query row i, key j):
//   x = S scale log2 e, S = Q K^T (with the softcap, CAP: x = cap log2 e t,
//       t = tanh(S scale / cap), the accurate tanhf);
//   P = exp2(x - LSE log2 e), exactly 0 on keys at or past kv_valid_len, on
//       rows past Nq, outside the band (row i sees key j iff i - lo <= j <= i
//       + hi, shifted by q / kv offsets: common.cuh band_bounds), on a pair
//       whose segment ids differ (SEG) and on a dead row (LSE log2 e <=
//       mask / 2);
//   dS = P (dP - Delta) scale, dP = dO V^T (CAP: times 1 - t^2);
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,
// with dK / dV per query head (the caller sums each KV head's group) and dQ
// added into a zeroed f32 dQ.
//
// What bounds it: five f32-accurate products, 3xTF32 each (common.cuh
// mma_3xtf32): at the f32 LM's attention (B1 Hq16 Hkv8 N2049 D128 causal)
// 43 GFLOP, 0.26 ms at 165 TFLOP/s (the TF32 peak 495 / 3), against 60 MB of
// inputs and outputs (0.018 ms at 3.35 TB/s) -- operations. wgmma's TF32
// operands must be K-major in shared memory (no transpose bits for 32-bit
// types), and three of the five products (dV = P^T dO, dK = dS^T Q, dQ = dS
// K) read an operand transposed; this first design stays on mma.sync:
//
//   * One CTA owns 128 keys of one (batch, query head), 8 warps of 16 keys,
//     their f32 dK and dV in registers across every Q tile of 32 rows that
//     the band leaves (SEG: whose id range meets the KV tile's, from the
//     wrapper's tile ranges, flash_fwd.sm90_segments).
//   * K and V come once by cp.async (rows past kv_valid_len zero-filled, so
//     a key the forward never read cannot put a NaN into dQ); the (Q, dO)
//     tiles with their LSE, Delta and (SEG) ids are double-buffered, the next
//     visited tile's copies in flight while the warps work on the current
//     one. D 40 / 80 / 96 run in the D 64 / 128 boxes, their padded columns
//     skipped at run time.
//   * Per warp and Q tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//     registers; dV += P^T dO and dK += dS^T Q with P^T / dS^T's C fragments
//     as A fragments (the (0, 2, 4, 6, 1, 3, 5, 7) order of common.cuh); dS^T
//     to shared memory, then dQ = dS K by all 8 warps over the CTA's 128
//     keys, 16 rows x 8 columns a unit, added to dQ by red.global.add.f32 for
//     rows below Nq only (dQ is [B, Hq, Nq, d]: nothing is added past the
//     last row or column). dQ's sums therefore vary in their last bits from
//     run to run.

#pragma once

#include "common.cuh"

namespace fa {

struct BwdF32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;      // [B, Hq, nq_pad] f32, natural log
  const float* delta;    // [B, Hq, nq_pad] f32
  float* dq;             // [B, Hq, Nq, d] f32, zeroed, added to
  float* dk;             // [B, Hq, Nk, d] f32
  float* dv;             // [B, Hq, Nk, d] f32
  const int* seg_q;      // [B, q_tiles * 32] ids, contiguous, rows padded to whole tiles
  const int* seg_kv;     // [B, kv_tiles * 128] ids, contiguous, rows padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 32-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) id of each 128-key tile's keys
  int64_t q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, do_sb, do_sh, do_sn;
  int hq, rep, nq, nq_pad, nk, kv_valid_len, d;
  int lo, hi;              // band: row - lo <= key <= row + hi (NO_BOUND: none)
  int q_tiles, kv_tiles;   // ceil(Nq / 32), ceil(kv_valid_len / 128)
  float scale, scale_log2;
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
};

}  // namespace fa

namespace {

using namespace fa;

constexpr int F32B_BLOCK_N = 128;  // keys per CTA: 8 warps of 16
constexpr int F32B_BLOCK_M = 32;   // query rows per Q tile
constexpr int F32B_THREADS = 256;
constexpr int F32B_DSS = F32B_BLOCK_M + 4;  // dS^T's row stride (floats)

// Shared memory (floats): K, V [128][DB + 4]; two stages of (Q, dO [32][DB +
// 4], LSE [32], Delta [32], query ids [32]); dS^T [128][36].
template <int DB>
struct F32BwdSmem {
  static constexpr int DS = DB + 4;
  static constexpr int KV = F32B_BLOCK_N * DS;
  static constexpr int QT = F32B_BLOCK_M * DS;
  static constexpr int STAGE = 2 * QT + 3 * F32B_BLOCK_M;
  static constexpr int OFF_STAGE = 2 * KV;
  static constexpr int OFF_DS = OFF_STAGE + 2 * STAGE;
  static constexpr int BYTES = (OFF_DS + F32B_BLOCK_N * F32B_DSS) * 4;
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

template <int DB, bool SEG, bool CAP>
__global__ void __launch_bounds__(F32B_THREADS, 1) bwd_f32_kernel(const BwdF32Params p) {
  static_assert(DB == 64 || DB == 128, "instantiated for D boxes 64 and 128");
  using S = F32BwdSmem<DB>;
  constexpr int DS = S::DS;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = smem + S::KV;
  float* ds_s = smem + S::OFF_DS;

  const int h = blockIdx.x;
  const int hk = h / p.rep;
  // A left bound alone: the late KV tiles meet the most Q tiles; run them first.
  const int n_tile =
      p.lo < NO_BOUND && p.hi >= NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int n0 = n_tile * F32B_BLOCK_N;
  const int b = blockIdx.z;
  // Rows [n0 - hi, n0 + 127 + lo] meet the tile's keys; none when the tile
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
  // tile's); every thread walks the same tiles.
  auto next_visit = [&](int i) {
    if constexpr (SEG) {
      while (i < n_m && !ranges_meet(p.q_range[b * p.q_tiles + t0 + i], k_rng)) ++i;
    }
    return i;
  };
  const float* q_base = p.q + b * p.q_sb + h * p.q_sh;
  const float* do_base = p.dout + b * p.do_sb + h * p.do_sh;
  const int64_t stat_row = (static_cast<int64_t>(b) * p.hq + h) * p.nq_pad;
  auto load_q = [&](int i, int s) {
    const int m = m_begin + i * F32B_BLOCK_M;
    float* st = smem + S::OFF_STAGE + s * S::STAGE;
    load_f32_tile<DB, F32B_BLOCK_M, F32B_THREADS>(st, q_base, m, p.q_sn, p.nq - m, p.d);
    load_f32_tile<DB, F32B_BLOCK_M, F32B_THREADS>(st + S::QT, do_base, m, p.do_sn, p.nq - m,
                                                  p.d);
    const int c = threadIdx.x % 8;
    float* stats = st + 2 * S::QT;
    if (threadIdx.x < 8) {
      cp_async_16(stats + 4 * c, p.lse + stat_row + m + 4 * c, 16);
    } else if (threadIdx.x < 16) {
      cp_async_16(stats + F32B_BLOCK_M + 4 * c, p.delta + stat_row + m + 4 * c, 16);
    } else if (SEG && threadIdx.x < 24) {
      cp_async_16(stats + 2 * F32B_BLOCK_M + 4 * c,
                  p.seg_q + static_cast<int64_t>(b) * p.q_tiles * F32B_BLOCK_M + m + 4 * c, 16);
    }
  };

  if (n_m > 0) {
    load_f32_tile<DB, F32B_BLOCK_N, F32B_THREADS>(k_s, p.k + b * p.k_sb + hk * p.k_sh, n0,
                                                  p.k_sn, p.kv_valid_len - n0, p.d);
    load_f32_tile<DB, F32B_BLOCK_N, F32B_THREADS>(v_s, p.v + b * p.v_sb + hk * p.v_sh, n0,
                                                  p.v_sn, p.kv_valid_len - n0, p.d);
  }
  int i = next_visit(0);
  if (i < n_m) load_q(i, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kw0 = n0 + 16 * warp;  // this warp's first key
  const int key0 = kw0 + g;        // this thread's keys key0 and key0 + 8
  const int dsteps = (p.d + 7) / 8;
  const float* k_w = k_s + (16 * warp + g) * DS + t;
  const float* v_w = v_s + (16 * warp + g) * DS + t;
  float* ds_w = ds_s + (16 * warp + g) * F32B_DSS + 2 * t;  // this thread's dS^T slots
  float dk[DB / 8][4], dv[DB / 8][4];
#pragma unroll
  for (int nt = 0; nt < DB / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;
  }
  int kv_seg[2] = {0, 0};
  if constexpr (SEG) {
    const int* ids = p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * F32B_BLOCK_N;
    kv_seg[0] = key0 < p.kv_valid_len ? ids[key0] : 0;
    kv_seg[1] = key0 + 8 < p.kv_valid_len ? ids[key0 + 8] : 0;
  }

  for (int it = 0; i < n_m; ++it) {
    const int nxt = next_visit(i + 1);
    if (nxt < n_m) load_q(nxt, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* q_t = smem + S::OFF_STAGE + (it & 1) * S::STAGE;
    const float* do_t = q_t + S::QT;
    const float* lse_t = q_t + 2 * S::QT;
    const float* delta_t = lse_t + F32B_BLOCK_M;
    const int* qid_t = reinterpret_cast<const int*>(lse_t + 2 * F32B_BLOCK_M);
    const int m = m_begin + i * F32B_BLOCK_M;  // the tile's first row
    // Whether this warp's 16 keys meet the tile's 32 rows in the band.
    if (kw0 < p.kv_valid_len && kw0 <= m + F32B_BLOCK_M - 1 + p.hi && kw0 + 15 >= m - p.lo) {
      float sp[4][4], dp[4][4];  // S^T then P^T; dP^T then dS^T: [key][query]
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[nt][e] = dp[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < DB / 8; ++ks) {
        if (ks < dsteps) {
          const float kf[4] = {k_w[8 * ks], k_w[8 * DS + 8 * ks], k_w[8 * ks + 4],
                               k_w[8 * DS + 8 * ks + 4]};
          const float vf[4] = {v_w[8 * ks], v_w[8 * DS + 8 * ks], v_w[8 * ks + 4],
                               v_w[8 * DS + 8 * ks + 4]};
          uint32_t k_hi[4], k_lo[4], v_hi[4], v_lo[4];
          split_tf32(kf, k_hi, k_lo);
          split_tf32(vf, v_hi, v_lo);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int off = (8 * nt + g) * DS + 8 * ks + t;
            const float qf[2] = {q_t[off], q_t[off + 4]};
            const float of[2] = {do_t[off], do_t[off + 4]};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(qf, b_hi, b_lo);
            mma_3xtf32(sp[nt], k_hi, k_lo, b_hi, b_lo);
            split_tf32(of, b_hi, b_lo);
            mma_3xtf32(dp[nt], v_hi, v_lo, b_hi, b_lo);
          }
        }
      }
      bool edge = kw0 + 15 >= p.kv_valid_len || m + F32B_BLOCK_M > p.nq ||
                  kw0 + 15 - m > p.hi || m + F32B_BLOCK_M - 1 - kw0 > p.lo;
      if constexpr (SEG) {
        const int2 q_rng = p.q_range[b * p.q_tiles + m / F32B_BLOCK_M];
        edge = edge || !(q_rng.x == q_rng.y && k_rng.x == k_rng.y && q_rng.x == k_rng.x);
      }
      float jac[4][4];  // CAP: 1 - t^2
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;              // key key0 + 8r
          const int qc = 8 * nt + 2 * t + (e & 1);  // query row m + qc
          float x;
          if constexpr (CAP) {
            const float tc = tanhf(sp[nt][e] * p.cap_scale);
            jac[nt][e] = 1.f - tc * tc;  // bwd f32 softcap jacobian
            x = p.cap_log2 * tc;
          } else {
            x = sp[nt][e] * p.scale_log2;
          }
          const float l2 = lse_t[qc] * LOG2E;
          float pe = exp2f(x - (l2 <= MASK_VALUE * 0.5f ? INFINITY : l2));
          if (edge) {
            const int key = key0 + 8 * r;
            const int row = m + qc;
            if (key - row > p.hi || row - key > p.lo || key >= p.kv_valid_len || row >= p.nq) {
              pe = 0.f;  // bwd f32 band mask
            }
            if (SEG && qid_t[qc] != kv_seg[r]) pe = 0.f;
          }
          sp[nt][e] = pe;
        }
      }
      // dV += P^T dO: P^T's C fragments of queries 8kt.. as the A fragment
      // (c0, c2, c1, c3), dO's rows 2t and 2t + 1 of them as B.
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const float pf[4] = {sp[kt][0], sp[kt][2], sp[kt][1], sp[kt][3]};
        uint32_t a_hi[4], a_lo[4];
        split_tf32(pf, a_hi, a_lo);
        const float* dor = do_t + (8 * kt + 2 * t) * DS + g;
#pragma unroll
        for (int nt = 0; nt < DB / 8; ++nt) {
          if (nt < dsteps) {
            const float bf[2] = {dor[8 * nt], dor[DS + 8 * nt]};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(bf, b_hi, b_lo);
            mma_3xtf32(dv[nt], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
      // dS^T = P^T (dP^T - Delta) scale (CAP: times 1 - t^2).
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds = sp[nt][e] * (dp[nt][e] - delta_t[8 * nt + 2 * t + (e & 1)]) * p.scale;
          if constexpr (CAP) ds *= jac[nt][e];
          dp[nt][e] = ds;
        }
      }
      // dK += dS^T Q, as dV.
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const float af[4] = {dp[kt][0], dp[kt][2], dp[kt][1], dp[kt][3]};
        uint32_t a_hi[4], a_lo[4];
        split_tf32(af, a_hi, a_lo);
        const float* qr = q_t + (8 * kt + 2 * t) * DS + g;
#pragma unroll
        for (int nt = 0; nt < DB / 8; ++nt) {
          if (nt < dsteps) {
            const float bf[2] = {qr[8 * nt], qr[DS + 8 * nt]};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(bf, b_hi, b_lo);
            mma_3xtf32(dk[nt], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<float2*>(ds_w + 8 * r * F32B_DSS + 8 * nt) =
              make_float2(dp[nt][2 * r], dp[nt][2 * r + 1]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<float2*>(ds_w + 8 * r * F32B_DSS + 8 * nt) = make_float2(0.f, 0.f);
        }
      }
    }
    __syncthreads();  // dS^T complete
    // dQ = dS K over the CTA's 128 keys: unit u is rows 16 (u & 1).. of the
    // tile and columns 8 (u >> 1)..; dS's A fragment reads dS^T's rows (keys)
    // 2t and 2t + 1 of each 8, K's B fragment the same keys.
    for (int u = warp; u < 2 * dsteps; u += F32B_THREADS / 32) {
      const int rb = u & 1;
      const int nt = u >> 1;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < F32B_BLOCK_N / 8; ++kk) {
        const float* da = ds_s + (8 * kk + 2 * t) * F32B_DSS + 16 * rb + g;
        const float af[4] = {da[0], da[8], da[F32B_DSS], da[F32B_DSS + 8]};
        const float* kb = k_s + (8 * kk + 2 * t) * DS + 8 * nt + g;
        const float bf[2] = {kb[0], kb[DS]};
        uint32_t a_hi[4], a_lo[4], b_hi[2], b_lo[2];
        split_tf32(af, a_hi, a_lo);
        split_tf32(bf, b_hi, b_lo);
        mma_3xtf32(c, a_hi, a_lo, b_hi, b_lo);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m + 16 * rb + g + 8 * r;
        if (row < p.nq) {  // never past row Nq: the next head's rows follow
          float* dst = p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + row) * p.d +
                       8 * nt + 2 * t;
          atomicAdd(dst, c[2 * r]);
          atomicAdd(dst + 1, c[2 * r + 1]);
        }
      }
    }
    __syncthreads();  // dS^T and the stage are free
    i = nxt;
  }
  cp_async_wait<0>();

  // dK and dV of this thread's keys, per query head; every key below Nk is
  // written (zeros for keys no row reached).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.nk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * p.hq + h) * p.nk + key) * p.d + 2 * t;
#pragma unroll
    for (int nt = 0; nt < DB / 8; ++nt) {
      if (8 * nt + 2 * t >= p.d) continue;
      *reinterpret_cast<float2*>(p.dk + off + 8 * nt) = make_float2(dk[nt][2 * r], dk[nt][2 * r + 1]);
      *reinterpret_cast<float2*>(p.dv + off + 8 * nt) = make_float2(dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

}  // namespace
