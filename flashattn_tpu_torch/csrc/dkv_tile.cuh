// The KV-tile backward body of K5 (csrc/flash_bwd_split*.cu: dK and dV, with
// optional segment ids, logit soft-capping, a window or an additive bias).
// Each option family is its own instantiation and launch; the header of each
// .cu says what it replaces and what bounds it. (K3, the single-pass
// backward that also gives dQ, is bwd_sm90_tile.cuh's TMA + wgmma body in
// csrc/flash_bwd_sm90.cu.)
//
// One CTA per (64-row KV tile, q-head, batch) keeps dK and dV in registers
// and loops over the Q tiles that can see its KV tile: with causal or a
// window, only those that meet rows [n0 - hi, n0 + 63 + lo] (the band of
// fwd_tile.cuh: row i sees column j iff i - lo <= j <= i + hi), and, with
// segments, only the Q tiles whose id range meets the KV tile's
// (flash.py::_seg_block_flags). Per Q tile, with the forward's row LSE
// (natural log) and Delta = rowsum(dO * O):
//
//   S = Q K^T (recomputed)      P = exp2(S * scale * log2e - LSE * log2e)
//   dV += P^T dO                dP = dO V^T         dS = P * (dP - Delta) * scale
//   dK += dS^T Q
//
// so dK carries `scale` exactly once. With softcap (
// flashattn_tpu/ops/flash_bwd.py:92-96, 220), t = tanh(S * scale / cap),
// P = exp2(cap * log2e * t - LSE * log2e), and dS gains the cap's Jacobian:
// dS = P * (dP - Delta) * (1 - t^2) * scale. t is recomputed per element in
// the loop that forms P and dS, so it costs no register array.
//
//   * Each of the 4 warps owns 16 KV rows and computes the transposed scores
//     S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are already the
//     A operands of dV += P^T dO and dK += dS^T Q, straight from registers.
//   * The Q tile is 64 rows for head dims up to 64 and 32 rows above, so that
//     at D=128 the 128 f32 dK+dV accumulators and the two 16x32 score tiles
//     fit a thread's registers without spilling (`-Xptxas -v`).
//   * GQA: K/V are read at head h / rep without materialising the repeat;
//     dK/dV are written per query head (f32) and ops/flash.py reduces them.
//   * Bias (flash_bwd.py:97-98): the f32 [B|1, H|1, Nq|1, Nk] bias
//     of the forward, read through (batch, head, row) strides that are 0 on
//     broadcast dims, is added in the forward's log2 domain and floored at
//     the mask value there (fwd_tile.cuh), x = s * scale * log2e +
//     bias * log2e (with softcap: cap * log2e * t + bias * log2e), so P
//     recomputed here is the P whose LSE the forward stored. A row that the
//     bias masks wholly (a padding mask turned additive) is dead in the
//     forward, LSE = ln2 * mask; its pairs are mask-valued, not masked, so
//     they get P = 0 explicitly here too.
//   * Masks: masked pairs get P = 0 exactly (pairs outside the band on edge
//     tiles, KV rows past kv_valid_len, Q rows past Nq, pairs of two
//     segments). A KV row that no Q row sees gets dK = dV = 0. There is no -inf anywhere, and no reliance on the mask value
//     underflowing: a dead row's LSE is ln2 * mask, which would give
//     exp2(mask - mask) = 1 on a merely mask-valued score. KV rows past
//     kv_valid_len are never loaded; their dK/dV rows are stored as zeros.
//     Q/dO rows past Nq are zero-filled in shared memory.
//   * Q/K/V/dO are addressed through (batch, head, seq) strides with a unit
//     head-dim stride, so the LM's [B, N, H, D] projections and autograd's dO
//     arrive as strided views without a copy.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace fa {

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, Hq, Nq] contiguous, natural log
  const float* delta;  // [B, Hq, Nq] contiguous
  float* dq;           // [B, Hq, Nq, D] contiguous (K6)
  float* dk;           // [B, Hq, Nk, D] contiguous, per query head
  float* dv;           // [B, Hq, Nk, D] contiguous, per query head
  const int* seg_q;    // [B, Nq] segment ids (row stride seg_q_sb), or null
  const int* seg_kv;   // [B, Nk] segment ids (row stride seg_kv_sb), or null
  const float* bias;   // f32, unit column stride (K5, K6), or null
  float* dbias;        // [B, Hq, Nq, Nk] f32 contiguous (K6), or null: not wanted
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t do_sb, do_sh, do_sn;
  int64_t seg_q_sb, seg_kv_sb;
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  int hq, rep, nq, nk, d, kv_valid_len, causal;
  // Band: row i sees column j iff i - lo <= j <= i + hi (NO_BOUND: no bound).
  int lo, hi;
  float scale;       // softmax scale
  float scale_log2;  // softmax scale * log2(e)
  float cap_scale;   // softcap: softmax scale / cap
  float cap_log2;    // softcap: cap * log2(e)
};

// K5 and K6 with a window, for each head dim; defined in
// flash_bwd_split_window.cu, so that nvcc builds them beside the rest.
cudaError_t dkv_window_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap);
cudaError_t dq_window_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap);
// K5 and K6 with a bias (K6 also writes dbias when p.dbias is not null); defined
// in flash_bwd_split_bias.cu.
cudaError_t dkv_bias_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap);
cudaError_t dq_bias_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap);

}  // namespace fa

namespace {

using namespace fa;

constexpr int BLOCK_N = 64;  // KV rows per CTA: 4 warps x 16 rows
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

template <int DP>
__host__ __device__ constexpr int block_m() {
  return DP <= 64 ? 64 : 32;  // Q rows per inner step
}

template <int DP>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  // K, V [64][DP+8]; Q, dO [BM][DP+8]; LSE, Delta [BM] (f32); Q segment ids
  // [BM] (int)
  return static_cast<size_t>(2 * BLOCK_N + 2 * block_m<DP>()) * (DP + 8) * 2 +
         3 * block_m<DP>() * 4;
}

// Segments when p.seg_q is not null. CAP: logit soft-capping. WIN: the
// sliding window (p.lo, p.hi; without it the band is causal's). BIAS: the
// additive bias p.bias (without a window or segments, as K1 takes it).
template <int DP, bool CAP, bool WIN, bool BIAS = false>
__device__ __forceinline__ void dkv_tile(const BwdParams& p) {
  static_assert(!(BIAS && WIN), "a bias runs K5 without a window");
  constexpr int BLOCK_M = block_m<DP>();
  constexpr int STRIDE = DP + 8;          // shared row stride of the [rows][DP] tiles
  constexpr int KS_D = DP / 16;           // k-steps over the head dim (S^T, dP^T)
  constexpr int NT_Q = BLOCK_M / 8;       // n-tiles over q of S^T / dP^T
  constexpr int KS_Q = BLOCK_M / 16;      // k-steps over q (dV, dK)
  constexpr int NT_D = DP / 8;            // n-tiles over the head dim (dK, dV)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;
  __nv_bfloat16* s_q = s_v + BLOCK_N * STRIDE;
  __nv_bfloat16* s_do = s_q + BLOCK_M * STRIDE;
  float* s_lse = reinterpret_cast<float*>(s_do + BLOCK_M * STRIDE);  // LSE * log2 e
  float* s_dlt = s_lse + BLOCK_M;
  int* s_segq = reinterpret_cast<int*>(s_dlt + BLOCK_M);

  const int n0 = blockIdx.x * BLOCK_N;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;  // GQA
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nkv = p.kv_valid_len;
  const int kv_rows = max(0, min(BLOCK_N, nkv - n0));

  float dk_acc[NT_D][4];
  float dv_acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  }

  // Causal: only the Q tiles from the diagonal on; with a window, only those
  // that meet rows [n0 - hi, n0 + 63 + lo]. A KV tile wholly past
  // kv_valid_len, or one that no row sees, does no work and stores zeros.
  int m_begin = p.causal ? (n0 / BLOCK_M) * BLOCK_M : 0;
  int m_end = kv_rows > 0 ? p.nq : 0;
  if constexpr (WIN) {
    m_begin = p.hi < NO_BOUND ? max(0, n0 - p.hi) / BLOCK_M * BLOCK_M : 0;
    if (p.lo < NO_BOUND) m_end = min(m_end, n0 + BLOCK_N + p.lo);
  }
  if (kv_rows > 0) {
    load_tile<DP, BLOCK_N, NUM_THREADS>(
        s_k, p.k + b * p.k_sb + hk * p.k_sh + static_cast<int64_t>(n0) * p.k_sn, p.k_sn,
        kv_rows, p.d);
    load_tile<DP, BLOCK_N, NUM_THREADS>(
        s_v, p.v + b * p.v_sb + hk * p.v_sh + static_cast<int64_t>(n0) * p.v_sn, p.v_sn,
        kv_rows, p.d);
  }

  const __nv_bfloat16* s_kw = s_k + warp * 16 * STRIDE;  // this warp's 16 KV rows
  const __nv_bfloat16* s_vw = s_v + warp * 16 * STRIDE;
  const int kv_row0 = n0 + warp * 16 + g;  // KV index of fragment row g (and g + 8)
  // ldmatrix.trans lane -> (row, col): B fragments of two n-tiles from a
  // row-major [k][n] tile.
  const int tb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int tb_col = (lane >> 4) * 8;

  const __nv_bfloat16* q_g = p.q + b * p.q_sb + h * p.q_sh;
  const float* bias_bh = BIAS ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const __nv_bfloat16* do_g = p.dout + b * p.do_sb + h * p.do_sh;
  const int64_t row_base = (static_cast<int64_t>(b) * p.hq + h) * p.nq;

  // Segments: the ids of KV rows g and g + 8 and the KV tile's range.
  const bool seg = p.seg_q != nullptr;
  const int* q_ids = seg ? p.seg_q + b * p.seg_q_sb : nullptr;
  int kv_seg[2] = {0, 0};
  int2 kv_range = make_int2(0, 0);
  if (seg) {
    const int* kv_ids = p.seg_kv + b * p.seg_kv_sb;
    kv_range = warp_id_range(kv_ids + n0, kv_rows);
    kv_seg[0] = kv_row0 < nkv ? kv_ids[kv_row0] : 0;
    kv_seg[1] = kv_row0 + 8 < nkv ? kv_ids[kv_row0 + 8] : 0;
  }

  for (int m0 = m_begin; m0 < m_end; m0 += BLOCK_M) {
    const int q_rows = min(BLOCK_M, p.nq - m0);
    // A Q tile of other documents only: skip it (uniform across the CTA).
    if (seg && !ranges_meet(kv_range, warp_id_range(q_ids + m0, q_rows))) continue;
    __syncthreads();  // the previous step's Q / dO / dS^T are consumed
    load_tile<DP, BLOCK_M, NUM_THREADS>(s_q, q_g + static_cast<int64_t>(m0) * p.q_sn, p.q_sn,
                                        q_rows, p.d);
    load_tile<DP, BLOCK_M, NUM_THREADS>(s_do, do_g + static_cast<int64_t>(m0) * p.do_sn,
                                        p.do_sn, q_rows, p.d);
    for (int i = threadIdx.x; i < BLOCK_M; i += NUM_THREADS) {
      const bool ok = i < q_rows;
      s_lse[i] = ok ? p.lse[row_base + m0 + i] * LOG2E : 0.f;
      s_dlt[i] = ok ? p.delta[row_base + m0 + i] : 0.f;
      if (seg) s_segq[i] = ok ? q_ids[m0 + i] : 0;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 KV rows x BLOCK_M q.
    float s[NT_Q][4];
    float dp[NT_Q][4];
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      const int c = ks * 16 + 2 * t;
      const uint32_t ak[4] = {ld_b32(s_kw + g * STRIDE + c), ld_b32(s_kw + (g + 8) * STRIDE + c),
                              ld_b32(s_kw + g * STRIDE + c + 8),
                              ld_b32(s_kw + (g + 8) * STRIDE + c + 8)};
      const uint32_t av[4] = {ld_b32(s_vw + g * STRIDE + c), ld_b32(s_vw + (g + 8) * STRIDE + c),
                              ld_b32(s_vw + g * STRIDE + c + 8),
                              ld_b32(s_vw + (g + 8) * STRIDE + c + 8)};
#pragma unroll
      for (int nt = 0; nt < NT_Q; ++nt) {
        const __nv_bfloat16* qr = s_q + (nt * 8 + g) * STRIDE + c;
        const __nv_bfloat16* dr = s_do + (nt * 8 + g) * STRIDE + c;
        mma_bf16_16816(s[nt], ak, ld_b32(qr), ld_b32(qr + 8));
        mma_bf16_16816(dp[nt], av, ld_b32(dr), ld_b32(dr + 8));
      }
    }

    // P^T = exp2(S^T scale log2e - LSE log2e), exactly 0 where masked;
    // dS^T = P^T (dP^T - Delta) scale, in place of dP^T (with softcap, P from
    // the capped score and dS through the cap's Jacobian 1 - t^2).
    const bool edge = WIN ? n0 + BLOCK_N - 1 - m0 > p.hi || m0 + BLOCK_M - 1 - n0 > p.lo
                          : p.causal && m0 < n0 + BLOCK_N - 1;
    const bool need_mask = seg || edge || m0 + BLOCK_M > p.nq || n0 + BLOCK_N > nkv;
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const int q = m0 + ql;
        const int kv = kv_row0 + 8 * (e >> 1);
        const bool masked =
            need_mask && (kv >= nkv || q >= p.nq ||
                          (WIN ? kv - q > p.hi || q - kv > p.lo : p.causal && kv > q) ||
                          (seg && s_segq[ql] != kv_seg[e >> 1]));
        if constexpr (BIAS) {
          // Kept apart from the branches below, as in dq_tile.cuh. A row the
          // forward found dead (LSE = ln2 * mask) is masked too: its
          // mask-valued scores would give exp2(mask - mask) = 1.
          const bool off = masked || s_lse[ql] <= 0.5f * MASK_VALUE;
          const float tc = CAP && !off ? tanhf(s[nt][e] * p.cap_scale) : 0.f;
          float x = CAP ? tc * p.cap_log2 : s[nt][e] * p.scale_log2;
          if (!off) {
            x = fmaxf(x + __ldg(bias_bh + static_cast<int64_t>(q) * p.bias_sn + kv) * LOG2E,
                      MASK_VALUE);
          }
          const float pe = off ? 0.f : exp2f(x - s_lse[ql]);
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - s_dlt[ql]) * (CAP ? (1.f - tc * tc) * p.scale : p.scale);
        } else if constexpr (CAP) {
          const float tc = masked ? 0.f : tanhf(s[nt][e] * p.cap_scale);
          const float pe = masked ? 0.f : exp2f(tc * p.cap_log2 - s_lse[ql]);
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - s_dlt[ql]) * ((1.f - tc * tc) * p.scale);
        } else {
          const float pe = masked ? 0.f : exp2f(s[nt][e] * p.scale_log2 - s_lse[ql]);
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - s_dlt[ql]) * p.scale;
        }
      }
    }

    // dV += P^T dO and dK += dS^T Q: A from registers, B transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < KS_Q; ++kk) {
      const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t ad[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 16; ++dt) {
        uint32_t bo[4];
        ldmatrix_x4_trans(bo, s_do + (kk * 16 + tb_row) * STRIDE + dt * 16 + tb_col);
        mma_bf16_16816(dv_acc[2 * dt], ap, bo[0], bo[1]);
        mma_bf16_16816(dv_acc[2 * dt + 1], ap, bo[2], bo[3]);
        uint32_t bq[4];
        ldmatrix_x4_trans(bq, s_q + (kk * 16 + tb_row) * STRIDE + dt * 16 + tb_col);
        mma_bf16_16816(dk_acc[2 * dt], ad, bq[0], bq[1]);
        mma_bf16_16816(dk_acc[2 * dt + 1], ad, bq[2], bq[3]);
      }
    }
  }

  // dK, dV of this warp's 16 KV rows, per query head, f32.
  const int64_t kv_base = (static_cast<int64_t>(b) * p.hq + h) * p.nk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kv_row0 + 8 * r;
    if (row < p.nk) {
      float* dk_row = p.dk + (kv_base + row) * p.d;
      float* dv_row = p.dv + (kv_base + row) * p.d;
#pragma unroll
      for (int nt = 0; nt < NT_D; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<float2*>(dk_row + col) = make_float2(dk_acc[nt][2 * r], dk_acc[nt][2 * r + 1]);
          *reinterpret_cast<float2*>(dv_row + col) = make_float2(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) dkv_kernel(const BwdParams p) {
  dkv_tile<DP, false, false>(p);
}

// K5 with logit soft-capping.
template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) dkv_softcap_kernel(const BwdParams p) {
  dkv_tile<DP, true, false>(p);
}

// K5 with the window, with or without softcap.
template <int DP, bool CAP>
__global__ void __launch_bounds__(NUM_THREADS) dkv_window_kernel(const BwdParams p) {
  dkv_tile<DP, CAP, true>(p);
}

// K5 with a bias, with or without softcap.
template <int DP, bool CAP>
__global__ void __launch_bounds__(NUM_THREADS) dkv_bias_kernel(const BwdParams p) {
  dkv_tile<DP, CAP, false, true>(p);
}

// One launch of the KV-tile kernel of these options: one CTA per (64-row KV
// tile, q-head, batch).
template <int DP, bool CAP, bool WIN, bool BIAS = false>
cudaError_t launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  void (*kernel)(const BwdParams);
  if constexpr (BIAS) {
    kernel = dkv_bias_kernel<DP, CAP>;
  } else if constexpr (WIN) {
    kernel = dkv_window_kernel<DP, CAP>;
  } else if constexpr (CAP) {
    kernel = dkv_softcap_kernel<DP>;
  } else {
    kernel = dkv_kernel<DP>;
  }
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nk + BLOCK_N - 1) / BLOCK_N, p.hq, batch);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Fill BwdParams from the C entries' common arguments (shared by K5 and K6);
// strides: q, k, v, dO (batch, head, seq), then seg_q, seg_kv (batch).
// (wl, wr) is the window (a negative bound: none); softcap 0 is no cap. No
// bias: K5 and K6 set p.bias and its strides themselves.
inline BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* seg_q,
                            const void* seg_kv, int hq, int hkv, int nq, int nk, int d,
                            int kv_valid_len, int causal, int wl, int wr, float scale,
                            float softcap, const int64_t (&strides)[14]) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sn = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sn = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sn = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_sn = strides[11];
  p.seg_q_sb = strides[12]; p.seg_kv_sb = strides[13];
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  p.causal = causal != 0;
  band_bounds(causal, wl, wr, &p.lo, &p.hi);
  p.scale = scale;
  p.scale_log2 = scale * fa::LOG2E;
  p.cap_scale = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap * fa::LOG2E;
  return p;
}

// The checks every backward entry makes before it launches.
inline bool bwd_args_ok(int d, int hq, int hkv, int nq, int nk, int kv_valid_len) {
  return d >= 8 && d <= 128 && d % 8 == 0 && hkv > 0 && hq % hkv == 0 && nq > 0 && nk > 0 &&
         kv_valid_len >= 0 && kv_valid_len <= nk;
}

// Call launch(std::integral_constant<int, DP>) with D padded to the MMA depth
// (a multiple of 16, D=40 runs as 48), for the backward's head dims <= 128.
template <typename Launch>
cudaError_t dispatch_head_dim(int d, Launch&& launch) {
  switch ((d + 15) / 16 * 16) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 48: return launch(std::integral_constant<int, 48>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 80: return launch(std::integral_constant<int, 80>{});
    case 96: return launch(std::integral_constant<int, 96>{});
    case 112: return launch(std::integral_constant<int, 112>{});
    default: return launch(std::integral_constant<int, 128>{});
  }
}

}  // namespace
