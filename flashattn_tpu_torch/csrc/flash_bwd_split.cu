// FlashAttention-2 two-kernel backward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5,
// :139) and flashattn_tpu/ops/flash_bwd.py::_dq_kernel (K6, :234), the pair
// that the JAX package's _flash_core_bwd runs whenever the single-pass K3
// cannot (here: with segment ids; later also bias/dbias, softcap and dynamic
// offsets). Both recompute P and dS from the forward's row LSE (natural log)
// and Delta = rowsum(dO * O), as flash_bwd.py::_recompute_p_ds does:
//
//   S = Q K^T      P = exp2(S * scale * log2e - LSE * log2e), 0 where masked
//   dP = dO V^T    dS = P * (dP - Delta) * scale
//
// so `scale` enters dK once (K5) and dQ once (K6). Masks: causal (top-left,
// zero offsets), the KV tail, and segments -- pair (i, j) attends iff
// seg_q[i] == seg_kv[j] -- AND-composed; masked pairs get P = 0 explicitly.
// A dead row (no key of its segment) has LSE = ln2 * mask from the forward,
// and a mask-valued score would give exp2(mask - mask) = 1, so the mask is
// never left to underflow. Tiles whose id ranges are disjoint are skipped
// (flash.py::_seg_block_flags, computed per tile in the kernel from the ids),
// so a row whose every tile is skipped gets dQ = 0 and gives dK/dV nothing.
//
//   * K5 (dK, dV): the KV-tile body of dkv_tile.cuh without dQ -- one CTA per
//     (b, q-head, 64-row KV tile) keeps dK and dV in registers and loops over
//     the Q tiles that can see its KV tile: from the diagonal on when causal,
//     skipping Q tiles of other documents. dK/dV are written per query head
//     in f32, as K3 writes them; ops/flash.py sums each KV head's group.
//   * K6 (dQ): one CTA per (b, q-head, 64-row Q tile), 16 Q rows per warp,
//     loops over the KV tiles up to the diagonal, skipping KV tiles of other
//     documents. It recomputes S = Q K^T and dP = dO V^T as the forward
//     computes S, turns the score accumulators into dS (bf16, as the TPU
//     kernel feeds the MXU) and uses them as the A operand of dQ += dS K
//     straight from registers (K's B fragments transposed by ldmatrix). dQ
//     stays in registers and is written once: no atomics, so dQ is
//     deterministic, unlike K3's.
//   * Segment ids are int32 [B, N] with unit stride along the sequence and
//     are read only below Nq and kv_valid_len, so the TPU's -1/-2 padding
//     sentinels have no counterpart.
//
// What bounds it: the recomputation -- 7 products per tile pair across the
// two kernels against K3's 5 -- and synchronous global->shared tile loads
// behind a barrier (as K1 and K3). At 8 documents per row most tile pairs
// are skipped, so the work follows the per-document areas. Left for later
// PRs: bias/dbias (K6's full dbias tile), softcap, dynamic offsets, wgmma
// and TMA/cp.async pipelining.

#include "dkv_tile.cuh"

namespace {

constexpr int DQ_BLOCK_M = 64;  // Q rows per K6 CTA: 4 warps x 16 rows

template <int DP>
constexpr size_t dq_smem_bytes() {
  // Q, dO [64][DP+8] and K, V [64][DP+8] (bf16); the KV tile's segment ids
  return static_cast<size_t>(2 * DQ_BLOCK_M + 2 * BLOCK_N) * (DP + 8) * 2 + BLOCK_N * 4;
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) dq_kernel(const BwdParams p) {
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.nq ? p.lse[row_base + row] * LOG2E : 0.f;
    dlt[r] = row < p.nq ? p.delta[row_base + row] : 0.f;
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
  // Causal: only KV tiles whose first column is <= this tile's last row.
  const int n_end = p.causal ? min(nkv, m0 + BLOCK_M) : nkv;
  const int n_tiles = (n_end + BLOCK_N - 1) / BLOCK_N;
  // ldmatrix.trans lane -> (row, col) of the 16x16 K block it addresses.
  const int k_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int k_col = (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BLOCK_N;
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
    // causal col > row on diagonal tiles, pairs of two segments);
    // dS = P (dP - Delta) scale, in place of S.
    const bool need_mask = seg || n0 + BLOCK_N > nkv || (p.causal && n0 + BLOCK_N - 1 > m0);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const bool masked =
            need_mask && (col >= nkv || (p.causal && col > row0 + 8 * r) ||
                          (seg && s_seg[col - n0] != q_seg[r]));
        const float pe = masked ? 0.f : exp2f(s[nt][e] * p.scale_log2 - lse2[r]);
        s[nt][e] = pe * (dp[nt][e] - dlt[r]) * p.scale;
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
cudaError_t launch_dkv(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP, false>();
  const cudaError_t e = allow_smem(dkv_kernel<DP, false>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nk + BLOCK_N - 1) / BLOCK_N, p.hq, batch);
  dkv_kernel<DP, false><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  const cudaError_t e = allow_smem(dq_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + DQ_BLOCK_M - 1) / DQ_BLOCK_M, p.hq, batch);
  dq_kernel<DP><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Common arguments of both entries: q/do [B, Hq, Nq, D], k/v [B, Hkv, Nk, D]
// (bf16, unit stride on D, other strides in elements), lse/delta [B, Hq, Nq]
// f32 contiguous, seg_q [B, Nq] / seg_kv [B, Nk] int32 segment ids with unit
// stride along the sequence (both null: no segments). Requires
// 8 <= D <= 128 with D % 8 == 0, Hq % Hkv == 0, 0 <= kv_valid_len <= Nk,
// Nq >= 1, Nk >= 1. causal != 0 masks kv_pos > q_pos (zero offsets). Each
// returns a cudaError_t (0 on success).

// K5: dk/dv [B, Hq, Nk, D] f32 contiguous, written per query head.
int fa_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg_q, const void* seg_kv,
                    void* dk, void* dv, int batch, int hq, int hkv, int nq, int nk, int d,
                    int kv_valid_len, int causal, float scale, int64_t q_sb, int64_t q_sh,
                    int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                    int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                    int64_t seg_q_sb, int64_t seg_kv_sb, void* stream) {
  if (!bwd_args_ok(d, hq, hkv, nq, nk, kv_valid_len) || (seg_q == nullptr) != (seg_kv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[14] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,  v_sb,
                               v_sh, v_sn, do_sb, do_sh, do_sn, seg_q_sb, seg_kv_sb};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, seg_q, seg_kv, hq, hkv, nq, nk, d,
                           kv_valid_len, causal, scale, strides);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_head_dim(
      d, [&](auto dp) { return launch_dkv<decltype(dp)::value>(p, batch, s); }));
}

// K6: dq [B, Hq, Nq, D] f32 contiguous, written once (no atomics, no zeroing).
int fa_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg_q, const void* seg_kv,
                   void* dq, int batch, int hq, int hkv, int nq, int nk, int d,
                   int kv_valid_len, int causal, float scale, int64_t q_sb, int64_t q_sh,
                   int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                   int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                   int64_t seg_q_sb, int64_t seg_kv_sb, void* stream) {
  if (!bwd_args_ok(d, hq, hkv, nq, nk, kv_valid_len) || (seg_q == nullptr) != (seg_kv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[14] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,  v_sb,
                               v_sh, v_sn, do_sb, do_sh, do_sn, seg_q_sb, seg_kv_sb};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, seg_q, seg_kv, hq, hkv, nq, nk, d,
                           kv_valid_len, causal, scale, strides);
  p.dq = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_head_dim(
      d, [&](auto dp) { return launch_dq<decltype(dp)::value>(p, batch, s); }));
}

}  // extern "C"
