// K6's body (dQ of the two-kernel backward, and dbias) and its launcher,
// shared by flash_bwd_split.cu (without a window), flash_bwd_split_window.cu
// (with one) and flash_bwd_split_bias.cu (with a bias); the header of
// flash_bwd_split.cu says what K6 replaces, how it is laid out and what
// bounds it. K5's body is dkv_tile.cuh's.
//
// dbias (flash_bwd.py:135, 300-302) is the gradient of the capped logits,
// dbias = P * (dP - Delta): the bias is added after the cap, so it carries
// neither `scale` nor the cap's Jacobian, which dS = dbias * (1 - t^2) *
// scale then takes on. K6 writes it in f32 for every pair of the tiles it
// visits (0 for masked pairs, whose P is 0); the pairs of tiles it skips are
// zero-filled by the caller (ops/flash_bwd.py), as the TPU kernel zeroes
// them (flash_bwd.py:315-322).

#pragma once

#include "dkv_tile.cuh"

namespace {

constexpr int DQ_BLOCK_M = 64;  // Q rows per K6 CTA: 4 warps x 16 rows

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Q, dO [64][DP+8] and K, V [64][DP+8] (bf16); the KV tile's segment ids
  return static_cast<size_t>(2 * DQ_BLOCK_M + 2 * BLOCK_N) * (DP + 8) * 2 + BLOCK_N * 4;
}

// CAP: logit soft-capping; WIN: the sliding window (p.lo, p.hi; without it
// the band is causal's); BIAS: the additive bias p.bias (without a window or
// segments, as K1 takes it), and dbias into p.dbias unless it is null.
template <int DP, bool CAP, bool WIN, bool BIAS = false>
__device__ __forceinline__ void dq_tile(const BwdParams& p) {
  static_assert(!(BIAS && WIN), "K1 takes a bias without a window");
  constexpr int BLOCK_M = DQ_BLOCK_M;
  constexpr int STRIDE = DP + 8;      // shared row stride (see load_tile)
  constexpr int KS_D = DP / 16;       // k-steps over the head dim (S, dP)
  constexpr int NT_S = BLOCK_N / 8;   // n-tiles over kv of S and dP
  constexpr int KS_N = BLOCK_N / 16;  // k-steps over kv (dQ)
  constexpr int NT_D = DP / 8;        // n-tiles over the head dim (dQ)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_do = s_q + BLOCK_M * STRIDE;
  __nv_bfloat16* s_k = s_do + BLOCK_M * STRIDE;
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;
  int* s_seg = reinterpret_cast<int*>(s_v + BLOCK_N * STRIDE);  // the KV tile's segment ids

  // Causal: heavy (late) Q tiles first, so the tail of the grid is short.
  const int m_tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = m_tile * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;  // GQA
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_rows = min(BLOCK_M, p.nq - m0);

  load_tile<DP, BLOCK_M, NUM_THREADS>(
      s_q, p.q + b * p.q_sb + h * p.q_sh + static_cast<int64_t>(m0) * p.q_sn, p.q_sn, q_rows, p.d);
  load_tile<DP, BLOCK_M, NUM_THREADS>(
      s_do, p.dout + b * p.do_sb + h * p.do_sh + static_cast<int64_t>(m0) * p.do_sn, p.do_sn,
      q_rows, p.d);

  // Rows g and g + 8 of this warp's 16: LSE (x log2 e) and Delta; rows past
  // Nq have zero Q and dO and so zero dS, and are not stored.
  const int row0 = m0 + warp * 16 + g;
  const int64_t row_base = (static_cast<int64_t>(b) * p.hq + h) * p.nq;
  float lse2[2], dlt[2];
  // Bias: rows g and g + 8 (null past Nq); a row the forward found dead
  // (LSE = ln2 * mask) is masked, as in dkv_tile.cuh.
  const float* bias_row[2] = {nullptr, nullptr};
  bool dead[2] = {false, false};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.nq ? p.lse[row_base + row] * LOG2E : 0.f;
    dlt[r] = row < p.nq ? p.delta[row_base + row] : 0.f;
    if (BIAS && row < p.nq) {
      bias_row[r] = p.bias + b * p.bias_sb + h * p.bias_sh + static_cast<int64_t>(row) * p.bias_sn;
      dead[r] = lse2[r] <= 0.5f * MASK_VALUE;
    }
  }

  // Segments: the ids of rows g and g + 8 and the id range of the Q tile.
  const bool seg = p.seg_q != nullptr;
  const int* kv_ids = seg ? p.seg_kv + b * p.seg_kv_sb : nullptr;
  int q_seg[2] = {0, 0};
  int2 q_range = make_int2(0, 0);
  if (seg) {
    const int* q_ids = p.seg_q + b * p.seg_q_sb;
    q_range = warp_id_range(q_ids + m0, q_rows);
    q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
    q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
  }

  float acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const __nv_bfloat16* s_qw = s_q + warp * 16 * STRIDE;
  const __nv_bfloat16* s_dow = s_do + warp * 16 * STRIDE;
  const __nv_bfloat16* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v_g = p.v + b * p.v_sb + hk * p.v_sh;
  const int nkv = p.kv_valid_len;
  // Causal: only KV tiles whose first column is <= this tile's last row; with
  // a window, only those that meet columns [m0 - lo, m0 + 63 + hi].
  int n_begin = 0;
  int n_end = p.causal ? min(nkv, m0 + BLOCK_M) : nkv;
  if constexpr (WIN) {
    n_begin = p.lo < NO_BOUND ? max(0, m0 - p.lo) / BLOCK_N * BLOCK_N : 0;
    n_end = p.hi < NO_BOUND ? min(nkv, m0 + BLOCK_M + p.hi) : nkv;
  }
  const int n_tiles = (n_end - n_begin + BLOCK_N - 1) / BLOCK_N;
  // ldmatrix.trans lane -> (row, col) of the 16x16 K block it addresses.
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_col = (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = n_begin + j * BLOCK_N;
    const int kv_rows = min(BLOCK_N, nkv - n0);
    // A tile of other documents only: skip it (uniform across the CTA).
    if (seg && !ranges_meet(q_range, warp_id_range(kv_ids + n0, kv_rows))) continue;
    __syncthreads();  // the previous tile is consumed (and s_q, s_do are complete)
    load_tile<DP, BLOCK_N, NUM_THREADS>(s_k, k_g + n0 * p.k_sn, p.k_sn, kv_rows, p.d);
    load_tile<DP, BLOCK_N, NUM_THREADS>(s_v, v_g + n0 * p.v_sn, p.v_sn, kv_rows, p.d);
    if (seg && threadIdx.x < kv_rows) s_seg[threadIdx.x] = kv_ids[n0 + threadIdx.x];
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 columns.
    float s[NT_S][4];
    float dp[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      const int c = ks * 16 + 2 * t;
      const uint32_t aq[4] = {ld_b32(s_qw + g * STRIDE + c), ld_b32(s_qw + (g + 8) * STRIDE + c),
                              ld_b32(s_qw + g * STRIDE + c + 8),
                              ld_b32(s_qw + (g + 8) * STRIDE + c + 8)};
      const uint32_t ad[4] = {ld_b32(s_dow + g * STRIDE + c),
                              ld_b32(s_dow + (g + 8) * STRIDE + c),
                              ld_b32(s_dow + g * STRIDE + c + 8),
                              ld_b32(s_dow + (g + 8) * STRIDE + c + 8)};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kr = s_k + (nt * 8 + g) * STRIDE + c;
        const __nv_bfloat16* vr = s_v + (nt * 8 + g) * STRIDE + c;
        mma_bf16_16816(s[nt], aq, ld_b32(kr), ld_b32(kr + 8));
        mma_bf16_16816(dp[nt], ad, ld_b32(vr), ld_b32(vr + 8));
      }
    }

    // P = exp2(S scale log2e - LSE log2e), exactly 0 where masked (KV tail,
    // pairs outside the band on edge tiles, pairs of two segments);
    // dS = P (dP - Delta) scale, in place of S (with softcap, P from the
    // capped score and dS through the cap's Jacobian 1 - t^2).
    const bool edge = WIN ? n0 + BLOCK_N - 1 - m0 > p.hi || m0 + BLOCK_M - 1 - n0 > p.lo
                          : p.causal && n0 + BLOCK_N - 1 > m0;
    const bool need_mask = seg || n0 + BLOCK_N > nkv || edge;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      float dl[4];  // dbias = P (dP - Delta), the capped logits' gradient
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const int row = row0 + 8 * r;
        const bool masked =
            need_mask && (col >= nkv ||
                          (WIN ? col - row > p.hi || row - col > p.lo : p.causal && col > row) ||
                          (seg && s_seg[col - n0] != q_seg[r]));
        if constexpr (BIAS) {
          // Kept apart from the branches below: folded into them, the bias
          // changed how nvcc compiled K6 without one (+25% time at the
          // packed shape on the H100).
          const bool off = masked || dead[r];
          const float tc = CAP && !off ? tanhf(s[nt][e] * p.cap_scale) : 0.f;
          float x = CAP ? tc * p.cap_log2 : s[nt][e] * p.scale_log2;
          if (!off && bias_row[r] != nullptr) {
            x = fmaxf(x + __ldg(bias_row[r] + col) * LOG2E, MASK_VALUE);  // K6 bias add
          }
          const float pe = off ? 0.f : exp2f(x - lse2[r]);
          dl[e] = pe * (dp[nt][e] - dlt[r]);
          s[nt][e] = dl[e] * (CAP ? (1.f - tc * tc) * p.scale : p.scale);
        } else if constexpr (CAP) {
          const float tc = masked ? 0.f : tanhf(s[nt][e] * p.cap_scale);
          const float pe = masked ? 0.f : exp2f(tc * p.cap_log2 - lse2[r]);
          s[nt][e] = pe * (dp[nt][e] - dlt[r]) * ((1.f - tc * tc) * p.scale);
        } else {
          const float pe = masked ? 0.f : exp2f(s[nt][e] * p.scale_log2 - lse2[r]);
          s[nt][e] = pe * (dp[nt][e] - dlt[r]) * p.scale;
        }
      }
      if (BIAS && p.dbias != nullptr) {
        // Rows g and g + 8, columns col, col + 1 (< Nk); rows past Nq are not stored.
        const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row >= p.nq || col >= p.nk) continue;
          float* dst = p.dbias + (row_base + row) * p.nk + col;
          if ((p.nk & 1) == 0) {
            *reinterpret_cast<float2*>(dst) = make_float2(dl[2 * r], dl[2 * r + 1]);
          } else {
            dst[0] = dl[2 * r];
            if (col + 1 < p.nk) dst[1] = dl[2 * r + 1];
          }
        }
      }
    }

    // dQ += dS K: the dS accumulators of n-tiles 2kk, 2kk+1 are exactly the A
    // fragment of k-step kk; K's B fragments come transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < KS_N; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 16; ++dt) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, s_k + (kk * 16 + k_row) * STRIDE + dt * 16 + k_col);
        mma_bf16_16816(acc[2 * dt], a, bk[0], bk[1]);
        mma_bf16_16816(acc[2 * dt + 1], a, bk[2], bk[3]);
      }
    }
  }

  // dQ of rows g and g + 8, f32, written once; ragged rows masked on store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < p.nq) {
      float* dq_row = p.dq + (row_base + row) * p.d;
#pragma unroll
      for (int nt = 0; nt < NT_D; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<float2*>(dq_row + col) = make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
        }
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) dq_kernel(const BwdParams p) {
  dq_tile<DP, false, false>(p);
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) dq_softcap_kernel(const BwdParams p) {
  dq_tile<DP, true, false>(p);
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(NUM_THREADS) dq_window_kernel(const BwdParams p) {
  dq_tile<DP, CAP, true>(p);
}

template <int DP, bool CAP>
__global__ void __launch_bounds__(NUM_THREADS) dq_bias_kernel(const BwdParams p) {
  dq_tile<DP, CAP, false, true>(p);
}

// One launch of K6 with these options: one CTA per (64-row Q tile, q-head, batch).
template <int DP, bool CAP, bool WIN, bool BIAS = false>
cudaError_t launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  void (*kernel)(const BwdParams);
  if constexpr (BIAS) {
    kernel = dq_bias_kernel<DP, CAP>;
  } else if constexpr (WIN) {
    kernel = dq_window_kernel<DP, CAP>;
  } else if constexpr (CAP) {
    kernel = dq_softcap_kernel<DP>;
  } else {
    kernel = dq_kernel<DP>;
  }
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + DQ_BLOCK_M - 1) / DQ_BLOCK_M, p.hq, batch);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
