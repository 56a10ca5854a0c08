// FlashAttention-2 backward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd_fused.py::
// _bwd_fused_kernel (K3, :110) and, with causal, the banded whole-sequence
// flashattn_tpu/ops/flash_bwd_fused.py::_bwd_causal_resident_kernel (K4, :336).
// It computes what they compute -- the single-pass 5-product backward, given
// the forward's row LSE (natural log) and Delta = rowsum(dO * O):
//
//   S = Q K^T (recomputed)      P = exp2(S * scale * log2e - LSE * log2e)
//   dV += P^T dO                dP = dO V^T         dS = P * (dP - Delta) * scale
//   dK += dS^T Q                dQ += dS K
//
// so dQ and dK each carry `scale` exactly once (a dQ that came out x log2e
// would be the reference's quirk, SURVEY.md section 6). It is not a
// block-by-block copy:
//
//   * The TPU grid runs in order, so K3 keeps a whole-sequence f32 dQ
//     accumulator in VMEM and adds into it race-free. CTAs run in parallel
//     here, and a plain read-modify-write of dQ would race. This is the
//     FlashAttention-2 design instead: one CTA per (64-row KV tile, q-head,
//     batch) keeps dK and dV in registers and loops over the Q tiles that can
//     see its KV tile (from the diagonal on, when causal -- K4's band); dQ is
//     added with f32 atomicAdd into a zeroed [B, Hq, Nq, D] scratch that the
//     wrapper allocates and casts once.
//   * Each of the 4 warps owns 16 KV rows and computes the transposed scores
//     S^T = K Q^T and dP^T = V dO^T directly, so P^T and dS^T are already the
//     A operands of dV += P^T dO and dK += dS^T Q, straight from registers.
//     Only dS (bf16, as the TPU kernel feeds the MXU) goes through shared
//     memory, because dQ = dS K sums over all 64 KV rows of the tile; its
//     A fragments come transposed by ldmatrix.trans.
//   * The Q tile is 64 rows for head dims up to 64 and 32 rows above, so that
//     at D=128 the 128 f32 dK+dV accumulators and the two 16x32 score tiles
//     fit a thread's registers without spilling (`-Xptxas -v`).
//   * GQA: K/V are read at head h / rep without materialising the repeat;
//     dK/dV are written per query head (f32) and ops/flash.py reduces them.
//   * Masks: masked pairs get P = 0 exactly (causal col > row on diagonal
//     tiles, KV rows past kv_valid_len, Q rows past Nq). There is no -inf
//     anywhere. KV rows past kv_valid_len are never loaded; their dK/dV rows
//     are stored as zeros. Q/dO rows past Nq are zero-filled in shared memory.
//   * Q/K/V/dO are addressed through (batch, head, seq) strides with a unit
//     head-dim stride, so the LM's [B, N, H, D] projections and autograd's dO
//     arrive as strided views without a copy.
//
// What bounds it: the dQ atomics (Nk/64 adds per dQ element, through L2), the
// recomputed Q K^T (5 products instead of the forward's 2), and synchronous
// global->shared loads of each Q/dO tile behind a barrier, with little
// tensor-core work per barrier at D=128 (32-row Q tiles). Left for later PRs:
// wgmma on warpgroup tiles, TMA / cp.async pipelining of the Q/dO tiles, a
// larger KV tile per CTA (fewer atomics), and a deterministic dQ (a separate
// dQ pass, K5/K6's design, or an ordered reduction).

#include "common.cuh"

namespace {

using namespace fa;

constexpr int BLOCK_N = 64;  // KV rows per CTA: 4 warps x 16 rows
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, Hq, Nq] contiguous, natural log
  const float* delta;  // [B, Hq, Nq] contiguous
  float* dq;           // [B, Hq, Nq, D] contiguous, zeroed, accumulated atomically
  float* dk;           // [B, Hq, Nk, D] contiguous, per query head
  float* dv;           // [B, Hq, Nk, D] contiguous, per query head
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t do_sb, do_sh, do_sn;
  int hq, rep, nq, nk, d, kv_valid_len, causal;
  float scale;       // softmax scale
  float scale_log2;  // softmax scale * log2(e)
};

template <int DP>
__host__ __device__ constexpr int block_m() {
  return DP <= 64 ? 64 : 32;  // Q rows per inner step
}

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  // K, V [64][DP+8]; Q, dO [BM][DP+8]; dS^T [64][BM+8] (bf16); LSE, Delta [BM] (f32)
  return static_cast<size_t>(2 * BLOCK_N + 2 * block_m<DP>()) * (DP + 8) * 2 +
         static_cast<size_t>(BLOCK_N) * (block_m<DP>() + 8) * 2 + 2 * block_m<DP>() * 4;
}

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) bwd_kernel(const Params p) {
  constexpr int BLOCK_M = block_m<DP>();
  constexpr int STRIDE = DP + 8;          // shared row stride of the [rows][DP] tiles
  constexpr int DS_STRIDE = BLOCK_M + 8;  // shared row stride of dS^T [64][BLOCK_M]
  constexpr int KS_D = DP / 16;           // k-steps over the head dim (S^T, dP^T)
  constexpr int NT_Q = BLOCK_M / 8;       // n-tiles over q of S^T / dP^T
  constexpr int KS_Q = BLOCK_M / 16;      // k-steps over q (dV, dK)
  constexpr int NT_D = DP / 8;            // n-tiles over the head dim (dK, dV)
  constexpr int KS_N = BLOCK_N / 16;      // k-steps over kv (dQ)
  constexpr int ROW_GROUPS = BLOCK_M / 16;               // 16-row groups of a dQ tile
  constexpr int WARPS_PER_GROUP = NUM_WARPS / ROW_GROUPS;  // they split the head dim

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;
  __nv_bfloat16* s_q = s_v + BLOCK_N * STRIDE;
  __nv_bfloat16* s_do = s_q + BLOCK_M * STRIDE;
  __nv_bfloat16* s_ds = s_do + BLOCK_M * STRIDE;
  float* s_lse = reinterpret_cast<float*>(s_ds + BLOCK_N * DS_STRIDE);  // LSE * log2 e
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

  // A KV tile wholly past kv_valid_len does no work and stores zeros.
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
  // row-major [k][n] tile, and the A fragment of a row-major [k][m] tile
  // (the transposed dS^T).
  const int tb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int tb_col = (lane >> 4) * 8;
  const int ta_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int ta_col = ((lane >> 3) & 1) * 8;

  const __nv_bfloat16* q_g = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* do_g = p.dout + b * p.do_sb + h * p.do_sh;
  const int64_t row_base = (static_cast<int64_t>(b) * p.hq + h) * p.nq;
  float* dq_g = p.dq + row_base * p.d;

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

    // P^T = exp2(S^T scale log2e - LSE log2e), exactly 0 where masked;
    // dS^T = P^T (dP^T - Delta) scale, in place of dP^T.
    const bool need_mask = (p.causal && m0 < n0 + BLOCK_N - 1) || m0 + BLOCK_M > p.nq ||
                           n0 + BLOCK_N > nkv;
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + 2 * t + (e & 1);
        const int q = m0 + ql;
        const int kv = kv_row0 + 8 * (e >> 1);
        const bool masked =
            need_mask && (kv >= nkv || q >= p.nq || (p.causal && kv > q));
        const float pe = masked ? 0.f : exp2f(s[nt][e] * p.scale_log2 - s_lse[ql]);
        s[nt][e] = pe;
        dp[nt][e] = pe * (dp[nt][e] - s_dlt[ql]) * p.scale;
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

    // dS^T (bf16) to shared memory: dQ = dS K sums over all 64 KV rows.
#pragma unroll
    for (int nt = 0; nt < NT_Q; ++nt) {
      __nv_bfloat16* row = s_ds + (warp * 16 + g) * DS_STRIDE + nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(row) = pack_bf16(dp[nt][0], dp[nt][1]);
      *reinterpret_cast<uint32_t*>(row + 8 * DS_STRIDE) = pack_bf16(dp[nt][2], dp[nt][3]);
    }
    __syncthreads();

    // dQ rows [m0 + 16 rg, +16) += dS K; warps of one row group split the head
    // dim. f32 atomics: every KV tile's CTA adds into the same dQ rows.
    {
      const int rg = warp % ROW_GROUPS;
      uint32_t a[KS_N][4];
#pragma unroll
      for (int kk = 0; kk < KS_N; ++kk) {
        ldmatrix_x4_trans(a[kk], s_ds + (kk * 16 + ta_row) * DS_STRIDE + rg * 16 + ta_col);
      }
      const int r0 = m0 + rg * 16 + g;
      for (int dt = warp / ROW_GROUPS; dt < DP / 16; dt += WARPS_PER_GROUP) {
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KS_N; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, s_k + (kk * 16 + tb_row) * STRIDE + dt * 16 + tb_col);
          mma_bf16_16816(c[0], a[kk], bk[0], bk[1]);
          mma_bf16_16816(c[1], a[kk], bk[2], bk[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = dt * 16 + j * 8 + 2 * t;
          if (col < p.d) {
            if (r0 < p.nq) {
              float* dst = dq_g + static_cast<int64_t>(r0) * p.d + col;
              atomicAdd(dst, c[j][0]);
              atomicAdd(dst + 1, c[j][1]);
            }
            if (r0 + 8 < p.nq) {
              float* dst = dq_g + static_cast<int64_t>(r0 + 8) * p.d + col;
              atomicAdd(dst, c[j][2]);
              atomicAdd(dst + 1, c[j][3]);
            }
          }
        }
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
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  const cudaError_t e = allow_smem(bwd_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nk + BLOCK_N - 1) / BLOCK_N, p.hq, batch);
  bwd_kernel<DP><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dQ, dK, dV for q/do [B, Hq, Nq, D], k/v [B, Hkv, Nk, D] (bf16, unit stride
// on D, other strides in elements), lse/delta [B, Hq, Nq] f32 contiguous.
// dq [B, Hq, Nq, D] f32 contiguous must be zeroed (it is accumulated
// atomically); dk/dv [B, Hq, Nk, D] f32 contiguous are written per query
// head. Requires 8 <= D <= 128 with D % 8 == 0, Hq % Hkv == 0,
// 0 <= kv_valid_len <= Nk, Nq >= 1, Nk >= 1. causal != 0 masks kv_pos > q_pos
// (zero offsets). Returns a cudaError_t (0 on success).
int fa_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int batch, int hq, int hkv,
                int nq, int nk, int d, int kv_valid_len, int causal, float scale, int64_t q_sb,
                int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh,
                int64_t do_sn, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 || nq <= 0 || nk <= 0 ||
      kv_valid_len < 0 || kv_valid_len > nk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sn = do_sn;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  p.causal = causal != 0;
  p.scale = scale;
  p.scale_log2 = scale * fa::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((d + 15) / 16 * 16) {
    case 16: e = launch<16>(p, batch, s); break;
    case 32: e = launch<32>(p, batch, s); break;
    case 48: e = launch<48>(p, batch, s); break;
    case 64: e = launch<64>(p, batch, s); break;
    case 80: e = launch<80>(p, batch, s); break;
    case 96: e = launch<96>(p, batch, s); break;
    case 112: e = launch<112>(p, batch, s); break;
    default: e = launch<128>(p, batch, s); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
