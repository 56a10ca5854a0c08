// The KV-tile backward body of K5 with an additive bias (csrc/flash_bwd_split*.cu:
// dK and dV, with or without logit soft-capping), for the bias calls that the
// Hopper bias route (bwd_sm90_tile.cuh in bwd_bias_sm90.cu) refuses: a bias
// with the softcap, the GQA decode fold, D 96. Without a bias K5 + K6 are one
// launch of bwd_sm90_tile.cuh (flash_bwd_split_sm90.cu). The header of
// flash_bwd_split.cu says what K5 replaces and what bounds it.
//
// One CTA per (64-row KV tile, q-head, batch) keeps dK and dV in registers
// and loops over the Q tiles that can see its KV tile: with causal, only
// those from the diagonal on. Per Q tile, with the forward's row LSE
// (natural log) and Delta = rowsum(dO * O):
//
//   S = Q K^T (recomputed)      P = exp2(x - LSE * log2e)
//   dV += P^T dO                dP = dO V^T         dS = P * (dP - Delta) * scale
//   dK += dS^T Q
//
// with x = S * scale * log2e + bias * log2e, floored at the mask value, as
// the forward forms it (fwd_tile.cuh), so dK carries `scale` exactly once.
// With softcap (flashattn_tpu/ops/flash_bwd.py:92-96, 220), t = tanh(S *
// scale / cap), x = cap * log2e * t + bias * log2e, and dS gains the cap's
// Jacobian: dS = P * (dP - Delta) * (1 - t^2) * scale. t is recomputed per
// element in the loop that forms P and dS, so it costs no register array.
//
//   * Each of the 4 warps owns 16 KV rows and computes the transposed scores
//     S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are already the
//     A operands of dV += P^T dO and dK += dS^T Q, straight from registers.
//   * The Q tile is 64 rows for head dims up to 64 and 32 rows above, so that
//     at D=128 the 128 f32 dK+dV accumulators and the two 16x32 score tiles
//     fit a thread's registers without spilling (`-Xptxas -v`).
//   * GQA: K/V are read at head h / rep without materialising the repeat;
//     dK/dV are written per query head (f32) and ops/flash.py reduces them.
//   * The bias (flash_bwd.py:97-98): the f32 [B|1, H|1, Nq|1, Nk] bias of
//     the forward, read through (batch, head, row) strides that are 0 on
//     broadcast dims. A row that the bias masks wholly (a padding mask
//     turned additive) is dead in the forward, LSE = ln2 * mask; its pairs
//     are mask-valued, not masked, so they get P = 0 explicitly.
//   * Masks: masked pairs get P = 0 exactly (pairs above the causal diagonal
//     on edge tiles, KV rows past kv_valid_len, Q rows past Nq). A KV row
//     that no Q row sees gets dK = dV = 0. KV rows past kv_valid_len are
//     never loaded; their dK/dV rows are stored as zeros. Q/dO rows past Nq
//     are zero-filled in shared memory.
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
  const float* bias;   // f32, unit column stride
  float* dbias;        // [B, Hq, Nq, Nk] f32 contiguous (K6), or null: not wanted
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t do_sb, do_sh, do_sn;
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  int hq, rep, nq, nk, d, kv_valid_len, causal;
  float scale;       // softmax scale
  float scale_log2;  // softmax scale * log2(e)
  float cap_scale;   // softcap: softmax scale / cap
  float cap_log2;    // softcap: cap * log2(e)
};

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
  // K, V [64][DP+8]; Q, dO [BM][DP+8]; LSE, Delta [BM] (f32)
  return static_cast<size_t>(2 * BLOCK_N + 2 * block_m<DP>()) * (DP + 8) * 2 +
         2 * block_m<DP>() * 4;
}

// CAP: logit soft-capping.
template <int DP, bool CAP>
__device__ __forceinline__ void dkv_tile(const BwdParams& p) {
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

  // Causal: only the Q tiles from the diagonal on. A KV tile wholly past
  // kv_valid_len does no work and stores zeros.
  const int m_begin = p.causal ? (n0 / BLOCK_M) * BLOCK_M : 0;
  const int m_end = kv_rows > 0 ? p.nq : 0;
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
  const float* bias_bh = p.bias + b * p.bias_sb + h * p.bias_sh;
  const __nv_bfloat16* do_g = p.dout + b * p.do_sb + h * p.do_sh;
  const int64_t row_base = (static_cast<int64_t>(b) * p.hq + h) * p.nq;

  for (int m0 = m_begin; m0 < m_end; m0 += BLOCK_M) {
    const int q_rows = min(BLOCK_M, p.nq - m0);
    __syncthreads();  // the previous step's Q / dO / dS^T are consumed
    load_tile<DP, BLOCK_M, NUM_THREADS>(s_q, q_g + static_cast<int64_t>(m0) * p.q_sn, p.q_sn,
                                        q_rows, p.d);
    load_tile<DP, BLOCK_M, NUM_THREADS>(s_do, do_g + static_cast<int64_t>(m0) * p.do_sn,
                                        p.do_sn, q_rows, p.d);
    for (int i = threadIdx.x; i < BLOCK_M; i += NUM_THREADS) {
      const bool ok = i < q_rows;
      s_lse[i] = ok ? p.lse[row_base + m0 + i] * LOG2E : 0.f;
      s_dlt[i] = ok ? p.delta[row_base + m0 + i] : 0.f;
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

    // P^T = exp2(x - LSE log2e), exactly 0 where masked; dS^T = P^T (dP^T -
    // Delta) scale, in place of dP^T (with softcap, P from the capped score
    // and dS through the cap's Jacobian 1 - t^2).
    const bool edge = p.causal && m0 < n0 + BLOCK_N - 1;
    const bool need_mask = edge || m0 + BLOCK_M > p.nq || n0 + BLOCK_N > nkv;
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const int q = m0 + ql;
        const int kv = kv_row0 + 8 * (e >> 1);
        const bool masked = need_mask && (kv >= nkv || q >= p.nq || (p.causal && kv > q));
        // A row the forward found dead (LSE = ln2 * mask) is masked too: its
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

// K5 with a bias, with or without softcap.
template <int DP, bool CAP>
__global__ void __launch_bounds__(NUM_THREADS) dkv_bias_kernel(const BwdParams p) {
  dkv_tile<DP, CAP>(p);
}

// One launch of K5: one CTA per (64-row KV tile, q-head, batch).
template <int DP, bool CAP>
cudaError_t launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  auto kernel = dkv_bias_kernel<DP, CAP>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nk + BLOCK_N - 1) / BLOCK_N, p.hq, batch);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Fill BwdParams from the C entries' common arguments (shared by K5 and K6);
// strides: q, k, v, dO (batch, head, seq), then the bias's (batch, head,
// row). softcap 0 is no cap.
inline BwdParams bwd_params(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* bias, int hq,
                            int hkv, int nq, int nk, int d, int kv_valid_len, int causal,
                            float scale, float softcap, const int64_t (&strides)[15]) {
  BwdParams p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bias = static_cast<const float*>(bias);
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sn = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sn = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sn = strides[8];
  p.do_sb = strides[9]; p.do_sh = strides[10]; p.do_sn = strides[11];
  p.bias_sb = strides[12]; p.bias_sh = strides[13]; p.bias_sn = strides[14];
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  p.causal = causal != 0;
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
