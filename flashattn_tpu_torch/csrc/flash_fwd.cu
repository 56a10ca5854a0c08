// FlashAttention-2 forward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) on its flat and dense-grid routes, and, with causal, the whole-sequence
// banded flashattn_tpu/ops/flash_fwd.py::_fwd_causal_resident_kernel (K2,
// :516): no bias, KV tail, GQA, optional top-left causal mask. It computes
// what those kernels compute -- O = softmax(Q K^T * scale) V with the online softmax in
// the log2 domain, f32 running max / sum / accumulator, and the row LSE in
// natural log (m * ln2 + log l) -- but is not a block-by-block copy:
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
//     (kv_valid_len == 0, or no key of its segment) stores zeros and
//     lse = ln2 * mask, the package's dead-row convention.
//   * Causal (kv_pos <= q_pos, top-left aligned with zero offsets, also when
//     Nq != Nk): the CTA of Q tile m0 visits only the KV tiles whose first
//     column is <= its last row -- the tile skipping that K2 gets from its
//     static tile table -- and masks col > row with the finite mask value on
//     the diagonal tiles only. CTAs are issued longest-first (the last Q
//     tile, which visits the most KV tiles, gets blockIdx.x == 0).
//   * Q/K/V/O are addressed through (batch, head, seq) strides in elements
//     with a unit head-dim stride, so the U-Net's [B, N, H, D] projections
//     reach the kernel as transposed views without a copy.
//   * Segments (packed sequences): with int32 ids seg_q [B, Nq] and seg_kv
//     [B, Nk], pair (i, j) attends iff seg_q[i] == seg_kv[j], AND-composed
//     with causal and the KV tail. The ids are read only below Nq and
//     kv_valid_len, so the TPU's -1/-2 padding sentinels have no counterpart.
//     A KV tile whose id range is disjoint from the Q tile's is skipped
//     before it is loaded (flash.py::_seg_block_flags, computed per tile in
//     the kernel), so packed attention costs the sum of the per-document
//     areas; the pairs of a visited tile are masked per element. A row that
//     matches no key is a dead row like a kv_valid_len == 0 row.
//
// What bounds it at the slice's shape (B1 H8 N4096 D40): with D=40 padded to
// 48 the two matrix products do little work per score, so tensor-core
// throughput competes with the softmax's exp2 / FMA / shuffle work on the
// 64x64 score tile, and with synchronous global->shared loads that stall the
// warps between tiles. This simple design leaves for later PRs: wgmma on
// 64-row warpgroup tiles, TMA loads into a multi-stage ring with mbarriers
// (or cp.async double buffering), warp specialisation (producer warp +
// consumer warpgroups), and a persistent grid.

#include "common.cuh"

namespace {

using namespace fa;

constexpr int BLOCK_M = 64;  // Q rows per CTA: 4 warps x 16 rows
constexpr int BLOCK_N = 64;  // KV rows per inner-loop tile
constexpr int NUM_WARPS = 4;
constexpr int NUM_THREADS = NUM_WARPS * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B, Hq, Nq] contiguous
  const int* seg_q;   // [B, Nq] segment ids (row stride seg_q_sb), or null
  const int* seg_kv;  // [B, Nk] segment ids (row stride seg_kv_sb), or null
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t seg_q_sb, seg_kv_sb;
  int hq, rep, nq, d, kv_valid_len, causal;
  float scale_log2;  // softmax scale * log2(e)
};

// SEG: segment ids (p.seg_q / p.seg_kv not null). A template parameter, so
// that the instantiations without segments carry no trace of them.
template <int DP, bool SEG>
__global__ void __launch_bounds__(NUM_THREADS) fwd_kernel(const Params p) {
  constexpr int STRIDE = DP + 8;  // shared row stride (see load_tile)
  constexpr int KS_QK = DP / 16;       // k-steps of Q K^T
  constexpr int NT_S = BLOCK_N / 8;    // n-tiles of the score tile
  constexpr int KS_PV = BLOCK_N / 16;  // k-steps of P V
  constexpr int NT_O = DP / 8;         // n-tiles of the output

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + BLOCK_M * STRIDE;
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;
  int* s_seg = reinterpret_cast<int*>(s_v + BLOCK_N * STRIDE);  // the KV tile's segment ids

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
  const __nv_bfloat16* k_g = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v_g = p.v + b * p.v_sb + hk * p.v_sh;
  load_tile<DP, BLOCK_M, NUM_THREADS>(s_q, q_g, p.q_sn, min(BLOCK_M, p.nq - m0), p.d);

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

  // Segments: the ids of rows g and g + 8 and the id range of the Q tile.
  const int row0 = m0 + warp * 16 + g;
  const int* kv_ids = SEG ? p.seg_kv + b * p.seg_kv_sb : nullptr;
  int q_seg[2] = {0, 0};
  int2 q_range = make_int2(0, 0);
  if (SEG) {
    const int* q_ids = p.seg_q + b * p.seg_q_sb;
    q_range = warp_id_range(q_ids + m0, min(BLOCK_M, p.nq - m0));
    q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
    q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BLOCK_N;
    const int kv_rows = min(BLOCK_N, nkv - n0);
    // A tile of other documents only: skip it (uniform across the CTA).
    if (SEG && !ranges_meet(q_range, warp_id_range(kv_ids + n0, kv_rows))) continue;
    __syncthreads();  // the previous tile is consumed (and s_q is complete)
    load_tile<DP, BLOCK_N, NUM_THREADS>(s_k, k_g + n0 * p.k_sn, p.k_sn, kv_rows, p.d);
    load_tile<DP, BLOCK_N, NUM_THREADS>(s_v, v_g + n0 * p.v_sn, p.v_sn, kv_rows, p.d);
    if (SEG && threadIdx.x < kv_rows) s_seg[threadIdx.x] = kv_ids[n0 + threadIdx.x];
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

    // Scale into the log2 domain in f32; mask the KV tail, on diagonal
    // tiles the causal upper triangle (col > row), and pairs of two segments.
    const bool tail = n0 + BLOCK_N > nkv;
    const bool diag = p.causal && n0 + BLOCK_N - 1 > m0;
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        if ((tail && col >= nkv) || (diag && col > row0 + 8 * (e >> 1)) ||
            (SEG && s_seg[col - n0] != q_seg[e >> 1])) {
          x = MASK_VALUE;
        }
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
        s[nt][e] = pe;
        l_i[e >> 1] += pe;
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

template <int DP, bool SEG>
cudaError_t launch_kernel(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BLOCK_M + 2 * BLOCK_N) * (DP + 8) * sizeof(__nv_bfloat16) +
                      (SEG ? BLOCK_N * sizeof(int) : 0);
  const cudaError_t e = allow_smem(fwd_kernel<DP, SEG>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.nq + BLOCK_M - 1) / BLOCK_M, p.hq, batch);
  fwd_kernel<DP, SEG><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  return p.seg_q != nullptr ? launch_kernel<DP, true>(p, batch, stream)
                            : launch_kernel<DP, false>(p, batch, stream);
}

}  // namespace

extern "C" {

// O and LSE for q [B, Hq, Nq, D], k/v [B, Hkv, Nk, D] (bf16, unit stride on D,
// other strides in elements); o has q's shape, lse is [B, Hq, Nq] f32
// contiguous. seg_q [B, Nq] / seg_kv [B, Nk] are int32 segment ids with unit
// stride along the sequence (both null: no segments). Requires 8 <= D <= 256
// with D % 8 == 0, Hq % Hkv == 0, 0 <= kv_valid_len <= Nk, Nq >= 1.
// causal != 0 masks kv_pos > q_pos (zero offsets). Returns a cudaError_t (0
// on success).
int fa_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                const void* seg_q, const void* seg_kv, int batch,
                int hq, int hkv, int nq, int d, int kv_valid_len, int causal, float scale,
                int64_t q_sb,
                int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh,
                int64_t o_sn, int64_t seg_q_sb, int64_t seg_kv_sb, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 || nq <= 0 ||
      kv_valid_len < 0 || (seg_q == nullptr) != (seg_kv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.seg_q_sb = seg_q_sb; p.seg_kv_sb = seg_kv_sb;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  p.causal = causal != 0;
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
    case 128: e = launch<128>(p, batch, s); break;
    case 144: e = launch<144>(p, batch, s); break;
    case 160: e = launch<160>(p, batch, s); break;
    case 176: e = launch<176>(p, batch, s); break;
    case 192: e = launch<192>(p, batch, s); break;
    case 208: e = launch<208>(p, batch, s); break;
    case 224: e = launch<224>(p, batch, s); break;
    case 240: e = launch<240>(p, batch, s); break;
    default: e = launch<256>(p, batch, s); break;
  }
  return static_cast<int>(e);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
