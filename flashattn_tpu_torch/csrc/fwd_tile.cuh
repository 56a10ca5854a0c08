// FlashAttention-2 forward for Hopper (sm_90a) on mma.sync: the kernel body
// of the K1 calls that no TMA + wgmma route takes -- int8 / fp8 K/V that are
// not decode-shaped (flash_fwd_int8.cu, flash_fwd_fp8.cu, with or without a
// bias) -- reached through fa_fwd (flash_fwd.cu). Every bf16 call goes to a
// TMA + wgmma route (fwd_sm90_tile.cuh: the dense route without a bias, the
// bias route with one, D <= 256) or to the decode kernel.
//
// Replaces, for those calls, the TPU kernels flashattn_tpu/ops/flash_fwd.py::
// _fwd_kernel (K1, :115) and, with causal, _fwd_causal_resident_kernel (K2,
// :516): KV tail, GQA, an optional top-left causal mask, an additive bias
// and int8 / fp8 e4m3 K/V with per-token f32 scales. It
// computes what those kernels compute -- O = softmax(Q K^T * scale + bias) V
// with the online softmax in the log2 domain, f32 running max / sum /
// accumulator, and the row LSE in natural log (m * ln2 + log l) -- but is
// not a block-by-block copy:
//
//   * The TPU walks KV tiles on a sequential grid axis and carries (m, l, acc)
//     in VMEM scratch between grid steps. Here CTAs run in parallel in no
//     order, so one CTA owns (b, h, 64-row Q tile) and loops over 64-row KV
//     tiles itself, keeping (m, l, acc) in registers.
//   * Each of the 4 warps owns 16 Q rows. Q K^T and P V run as
//     mma.sync.m16n8k16 bf16 with f32 accumulation; P goes from the score
//     accumulators to the A operand of P V without touching shared memory.
//   * The softmax scale is folded in f32 on the scores (x scale * log2 e),
//     not by re-rounding a pre-scaled Q to bf16 on the host.
//   * The head dim is zero-filled in shared memory up to the MMA depth (a
//     multiple of 16: D=40 runs as 48) and only D columns are written out.
//   * K/V tail rows are never read past kv_valid_len; their scores are set to
//     the finite mask value (ops/oracle.py DEFAULT_MASK_VALUE) before the max.
//     A ragged Q tail is masked on store. A row that sees no valid key
//     (kv_valid_len == 0) stores zeros and lse = ln2 * mask, the package's
//     dead-row convention.
//   * Causal (top-left aligned, also when Nq != Nk): the CTA of Q tile m0
//     visits only the KV tiles whose first column is <= its last row and
//     masks col > row on the diagonal tiles; CTAs are issued longest-first
//     (the last Q tile gets blockIdx.x == 0).
//   * Q/K/V/O are addressed through (batch, head, seq) strides in elements
//     with a unit head-dim stride, so the models' [B, N, H, D] projections
//     and KV caches reach the kernel as transposed views without a copy.
//   * Bias (flash_fwd.py:319-320): an f32 [B|1, H|1, Nq|1, Nk] tensor read
//     through (batch, head, row) strides that are 0 on broadcast dims, with a
//     unit column stride, so a [1, 1, 1, Nk] key mask is never
//     materialised per head or row. x = s * scale * log2e + bias * log2e is
//     formed before the masks, as the TPU kernel adds it before jnp.where,
//     and floored at the finite mask value (never -inf). Bias columns are
//     read only below kv_valid_len and rows only below Nq.
//   * Quantized K/V (flash_fwd.py:259-260, 304-309, 342-345): the int8 or
//     e4m3 tile is loaded from HBM (half the bytes of bf16) and widened
//     UNSCALED into the same bf16 shared tile -- int8 -> bf16 and
//     e4m3 -> bf16 are exact -- so the mma.sync body is the bf16 one. The
//     per-token scales of the tile sit in shared memory beside it and are
//     applied where the TPU kernel applies them: k_scale[col] multiplies the
//     f32 score column, v_scale[col] multiplies P after the row sum and
//     before P is rounded to bf16 for P V. Folding the scales into K/V before
//     the bf16 rounding would compute other numbers than the JAX package.
//
// The bias and the K/V element type are template parameters, so each
// instantiation carries only the options it takes (a runtime segment flag
// once cost this body 50%, PERF.md): fwd_kernel<DP, BIAS, KV> for int8 / fp8
// K/V at every padded D. The JAX package has no softcap with quantized K/V
// (flash_attention_quantized), and fa_fwd takes none.
//
// What bounds it: mma.sync at 16 rows per warp, synchronous global->shared
// loads between two block barriers, and one dependent scalar bias load per
// score: K1 on this body ran at ~100 TFLOP/s where the TMA + wgmma routes
// reach 234-358 (PERF.md §6). What it keeps is off the main paths: the
// decode-shaped quantized calls take decode_tile.cuh, and only a quantized
// prefill (flash_attention_quantized over a whole prompt) reaches it.

#pragma once

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace fa {

struct FwdParams {
  const __nv_bfloat16* q;
  const void* k;  // KvElem<KV>::type
  const void* v;
  __nv_bfloat16* o;
  float* lse;          // [B, Hq, Nq] contiguous
  const float* bias;   // f32, unit column stride, or null
  const float* k_scale;  // [B, Hkv, Nk] f32 per-token scales (quantized K/V)
  const float* v_scale;
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  int64_t ks_sb, ks_sh, ks_sn;
  int64_t vs_sb, vs_sh, vs_sn;
  int hq, rep, nq, d, kv_valid_len, causal;
  float scale_log2;  // softmax scale * log2(e)
};

// One launch of an instantiation family over every padded head dim; defined
// in the source that instantiates the family.
cudaError_t fwd_int8(const FwdParams& p, int batch, cudaStream_t stream);  // flash_fwd_int8.cu
cudaError_t fwd_fp8(const FwdParams& p, int batch, cudaStream_t stream);   // flash_fwd_fp8.cu

}  // namespace fa

namespace {

using namespace fa;

constexpr int FWD_BLOCK_M = 64;  // Q rows per CTA: 4 warps x 16 rows
constexpr int FWD_BLOCK_N = 64;  // KV rows per inner-loop tile
constexpr int FWD_THREADS = 128;

// One int8 or e4m3 element (the low byte of `bits`) as a float; exact.
template <int KV>
__device__ __forceinline__ float kv_to_float(uint32_t bits) {
  if constexpr (KV == KV_INT8) {
    return static_cast<float>(static_cast<int8_t>(bits & 0xffu));
  } else {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(bits & 0xffu), __NV_E4M3)));
  }
}

// A quantized K/V tile into the padded bf16 shared tile of load_tile: rows
// read 8 elements (8 bytes) at a time -- so D = 8 is one load per row, and
// the wrapper guarantees 8-byte-aligned rows -- and widened to 8 bf16,
// without scaling.
template <int DP, int ROWS, int THREADS, int KV>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* smem,
                                             const typename KvElem<KV>::type* g,
                                             int64_t row_stride, int rows_valid, int d) {
  constexpr int CHUNKS = DP / 8;
  constexpr int STRIDE = DP + 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c * 8 < d) {
      const uint2 raw = *reinterpret_cast<const uint2*>(g + r * row_stride + c * 8);
      val.x = pack_bf16(kv_to_float<KV>(raw.x), kv_to_float<KV>(raw.x >> 8));
      val.y = pack_bf16(kv_to_float<KV>(raw.x >> 16), kv_to_float<KV>(raw.x >> 24));
      val.z = pack_bf16(kv_to_float<KV>(raw.y), kv_to_float<KV>(raw.y >> 8));
      val.w = pack_bf16(kv_to_float<KV>(raw.y >> 16), kv_to_float<KV>(raw.y >> 24));
    }
    *reinterpret_cast<uint4*>(smem + r * STRIDE + c * 8) = val;
  }
}

// BIAS: additive bias; KV: the quantized K/V element type (KV_INT8 or
// KV_FP8, with p.k_scale / p.v_scale).
template <int DP, bool BIAS, int KV>
__device__ __forceinline__ void fwd_tile(const FwdParams& p) {
  static_assert(KV != KV_BF16, "bf16 K/V take the TMA + wgmma routes (fwd_sm90_tile.cuh)");
  constexpr int BLOCK_M = FWD_BLOCK_M;
  constexpr int BLOCK_N = FWD_BLOCK_N;
  constexpr int STRIDE = DP + 8;  // shared row stride (see load_tile)
  constexpr int KS_QK = DP / 16;       // k-steps of Q K^T
  constexpr int NT_S = BLOCK_N / 8;    // n-tiles of the score tile
  constexpr int KS_PV = BLOCK_N / 16;  // k-steps of P V
  constexpr int NT_O = DP / 8;         // n-tiles of the output
  using KVT = typename KvElem<KV>::type;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + BLOCK_M * STRIDE;
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;
  // The KV tile's K and V scales.
  float* s_ks = reinterpret_cast<float*>(s_v + BLOCK_N * STRIDE);
  float* s_vs = s_ks + BLOCK_N;

  // Causal: heavy (late) Q tiles first, so the tail of the grid is short.
  const int m_tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int m0 = m_tile * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  const __nv_bfloat16* q_g = p.q + b * p.q_sb + h * p.q_sh + static_cast<int64_t>(m0) * p.q_sn;
  const KVT* k_g = static_cast<const KVT*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const KVT* v_g = static_cast<const KVT*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<DP, BLOCK_M, FWD_THREADS>(s_q, q_g, p.q_sn, min(BLOCK_M, p.nq - m0), p.d);

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  // Rows g and g + 8 of this warp's 16; (m, l) are in log2 units, and l is
  // this thread's partial sum over its columns (reduced over the quad at the
  // end -- m is quad-uniform, so the rescales agree).
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  const __nv_bfloat16* s_qw = s_q + warp * 16 * STRIDE;
  const int nkv = p.kv_valid_len;
  // Causal: only KV tiles whose first column is <= this tile's last row.
  const int n_end = p.causal ? min(nkv, m0 + BLOCK_M) : nkv;
  const int n_tiles = (n_end + BLOCK_N - 1) / BLOCK_N;
  // ldmatrix.trans lane -> (row, col) of the 16x16 V block it addresses.
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  const int row0 = m0 + warp * 16 + g;
  // Bias: the rows g and g + 8 (null past Nq: those rows are never stored).
  const float* bias_row[2] = {nullptr, nullptr};
  if (BIAS) {
    const float* bias_bh = p.bias + b * p.bias_sb + h * p.bias_sh;
    bias_row[0] = row0 < p.nq ? bias_bh + row0 * p.bias_sn : nullptr;
    bias_row[1] = row0 + 8 < p.nq ? bias_bh + (row0 + 8) * p.bias_sn : nullptr;
  }
  const float* ks_g = p.k_scale + b * p.ks_sb + hk * p.ks_sh;
  const float* vs_g = p.v_scale + b * p.vs_sb + hk * p.vs_sh;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    const int kv_rows = min(BLOCK_N, nkv - n0);
    __syncthreads();  // the previous tile is consumed (and s_q is complete)
    load_kv_tile<DP, BLOCK_N, FWD_THREADS, KV>(s_k, k_g + n0 * p.k_sn, p.k_sn, kv_rows, p.d);
    load_kv_tile<DP, BLOCK_N, FWD_THREADS, KV>(s_v, v_g + n0 * p.v_sn, p.v_sn, kv_rows, p.d);
    if (threadIdx.x < BLOCK_N) {
      // 0 past the tail: those columns carry P = 0, and 0 * 0 stays 0.
      const bool live = threadIdx.x < kv_rows;
      s_ks[threadIdx.x] = live ? ks_g[(n0 + threadIdx.x) * p.ks_sn] : 0.f;
      s_vs[threadIdx.x] = live ? vs_g[(n0 + threadIdx.x) * p.vs_sn] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 columns.
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS_QK; ++ks) {
      const int c = ks * 16 + 2 * t;
      const uint32_t a[4] = {ld_b32(s_qw + g * STRIDE + c), ld_b32(s_qw + (g + 8) * STRIDE + c),
                             ld_b32(s_qw + g * STRIDE + c + 8),
                             ld_b32(s_qw + (g + 8) * STRIDE + c + 8)};
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kr = s_k + (nt * 8 + g) * STRIDE + c;
        mma_bf16_16816(s[nt], a, ld_b32(kr), ld_b32(kr + 8));
      }
    }

    // Scale into the log2 domain in f32 (the column's K scale first); add
    // the bias; mask the KV tail and, on causal's diagonal tiles, its upper
    // triangle col > row.
    const bool tail = n0 + BLOCK_N > nkv;
    const bool edge = p.causal && n0 + BLOCK_N - 1 > m0;
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1);  // column within the tile
        const int col = n0 + cl;
        float x = s[nt][e] * s_ks[cl] * p.scale_log2;
        if (BIAS && bias_row[e >> 1] != nullptr && col < nkv) {
          // Floored at the mask value: a bias at the mask value (a boolean
          // mask turned additive) times log2 e would overflow to -inf, and a
          // tile of -inf only would make the rescale exp2(-inf - -inf) NaN.
          x = fmaxf(x + __ldg(bias_row[e >> 1] + col) * LOG2E, MASK_VALUE);
        }
        const int row = row0 + 8 * (e >> 1);
        if ((tail && col >= nkv) || (edge && col > row)) x = MASK_VALUE;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_i[r] - mx[r]);
      m_i[r] = mx[r];
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_i[e >> 1]);
        l_i[e >> 1] += pe;
        // Quantized V: P diag(v_scale) V, the scale on P before its bf16 rounding.
        s[nt][e] = pe * s_vs[nt * 8 + 2 * t + (e & 1)];
      }
    }
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of k-step kk; V's B fragments come transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < KS_PV; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DP / 16; ++dt) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, s_v + (kk * 16 + v_row) * STRIDE + dt * 16 + v_col);
        mma_bf16_16816(acc[2 * dt], a, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * dt + 1], a, bv[2], bv[3]);
      }
    }
  }

  // Epilogue: O = acc / l, LSE = m ln2 + log l; ragged rows masked on store.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool dead = m_i[r] <= MASK_VALUE * 0.5f;
    const float l_safe = l == 0.f ? 1.f : l;
    const float inv = dead ? 0.f : 1.f / l_safe;
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row < p.nq) {
      __nv_bfloat16* o_row = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_sn;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < p.d) {
          *reinterpret_cast<uint32_t*>(o_row + col) =
              pack_bf16(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
        }
      }
      if (t == 0) {
        p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
            dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
      }
    }
  }
}

template <int DP, bool BIAS, int KV>
__global__ void __launch_bounds__(FWD_THREADS) fwd_kernel(const FwdParams p) {
  fwd_tile<DP, BIAS, KV>(p);
}

template <int DP, bool BIAS, int KV>
cudaError_t fwd_launch_dp(const FwdParams& p, int batch, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(FWD_BLOCK_M + 2 * FWD_BLOCK_N) * (DP + 8) *
                          sizeof(__nv_bfloat16) +
                      2 * FWD_BLOCK_N * sizeof(float);
  auto kernel = fwd_kernel<DP, BIAS, KV>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + FWD_BLOCK_M - 1) / FWD_BLOCK_M, p.hq, batch);
  kernel<<<grid, FWD_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Quantized K/V, with or without a bias: one instantiation per padded head
// dim (a multiple of 16 up to 256).
template <bool BIAS, int KV>
cudaError_t fwd_launch(const FwdParams& p, int batch, cudaStream_t s) {
  switch ((p.d + 15) / 16 * 16) {
    case 16: return fwd_launch_dp<16, BIAS, KV>(p, batch, s);
    case 32: return fwd_launch_dp<32, BIAS, KV>(p, batch, s);
    case 48: return fwd_launch_dp<48, BIAS, KV>(p, batch, s);
    case 64: return fwd_launch_dp<64, BIAS, KV>(p, batch, s);
    case 80: return fwd_launch_dp<80, BIAS, KV>(p, batch, s);
    case 96: return fwd_launch_dp<96, BIAS, KV>(p, batch, s);
    case 112: return fwd_launch_dp<112, BIAS, KV>(p, batch, s);
    case 128: return fwd_launch_dp<128, BIAS, KV>(p, batch, s);
    case 144: return fwd_launch_dp<144, BIAS, KV>(p, batch, s);
    case 160: return fwd_launch_dp<160, BIAS, KV>(p, batch, s);
    case 176: return fwd_launch_dp<176, BIAS, KV>(p, batch, s);
    case 192: return fwd_launch_dp<192, BIAS, KV>(p, batch, s);
    case 208: return fwd_launch_dp<208, BIAS, KV>(p, batch, s);
    case 224: return fwd_launch_dp<224, BIAS, KV>(p, batch, s);
    case 240: return fwd_launch_dp<240, BIAS, KV>(p, batch, s);
    default: return fwd_launch_dp<256, BIAS, KV>(p, batch, s);
  }
}

}  // namespace
