// K1's bias route for Hopper (sm_90a): a warp-specialised wgmma forward that
// streams the f32 bias tile through shared memory -- the kernel body of
// flash_fwd_bias_sm90.cu.
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115, the bias added at :319-320) on the dense calls that carry an additive
// bias: bf16 Q/K/V, D 64 or 128, no softcap, segment ids or window, not
// decode-shaped (ops/flash_fwd.py::bias_route). It computes what
// fwd_tile<DP, false, true, KV_BF16, false, false> computes: scores
// x = s * scale * log2 e + bias * log2 e, floored at the finite mask value;
// the KV tail and top-left causal masks; the online softmax in the log2 domain
// with f32 (m, l, acc); O in bf16 and the LSE in natural log; a row whose
// largest score is at or below half the mask value is dead (O = 0,
// LSE = ln2 * mask, bit for bit the convention K5 / K6 read). The bias is
// [B|1, H|1, Nq|1, Nk] f32, read through (batch, head, row) strides that are 0
// on broadcast dims, columns only below kv_valid_len, rows only below Nq; GQA
// maps query head h to KV head h / rep; Q, K, V and O are strided views.
//
// What bounds it: at path A's shape (B4 H16 N2048 D128, bias [4, 1, N, N])
// the two products are 137 GFLOP: 0.139 ms at 989 TFLOP/s, operations. With a
// learned [4, 16, N, N] bias the kernel must read 1.07 GB of it: 0.32 ms at
// 3.35 TB/s, bytes. fwd_tile ran this at 56 TFLOP/s: mma.sync at 16 rows per
// warp, synchronous K / V loads between two block barriers, and one scalar
// dependent bias load per score. This design:
//
//   * One CTA owns 128 Q rows of one (batch, head): warpgroup 0 is the
//     producer (setmaxnreg gives its registers away), warpgroups 1 and 2 the
//     consumers, 64 rows each.
//   * S = Q K^T by wgmma m64n64k16 with Q and K from shared memory (K's
//     row-major [keys, D] tile is the K-major B operand); O += P V by wgmma
//     with A from registers: the f32 score accumulators, rounded to bf16, are
//     the A fragments (the wgmma accumulator layout is mma.sync's, row g and
//     g + 8 of each warp's 16), so P never touches shared memory; V is the
//     N-major B operand (transpose bit), as K9's B.
//   * A ring of (K, V, bias) tiles on full / empty mbarriers, 3 stages at
//     D 128 (224 KB of shared memory) and 4 at D 64. Q, K and V come by TMA
//     (4-D maps over (D, seq, head, batch) with the 128-byte swizzle; the
//     sequence extents are Nq and kv_valid_len, so the tails read zeros). The
//     bias tile (128 rows x 64 columns f32) comes by 16-byte cp.async from all
//     128 producer threads, 16 copies each with no branch -- a TMA map cannot
//     take the zero row stride of a [B, H, 1, Nk] bias; such a bias is copied
//     as one row and read by every row -- whose completion arrives on the same
//     full barrier (cp.async.mbarrier.arrive.noinc). Each consumer warp
//     releases a stage once its products on it have retired. Every tile
//     carries 32 KB of K / V and 32 KB of bias.
//   * The bias tile's rows are unpadded (the third stage needs the room) and
//     their 16-byte chunks are permuted, chunk c of row r stored at
//     c ^ 2 (r % 4): a thread reads rows g and g + 8, columns 8j + 2t and + 1
//     (the accumulator's layout) as float2 by ld.shared, and with the
//     permutation the 16 lanes of each half-warp hit 32 distinct banks, while
//     the copies (8 lanes, 8 consecutive chunks of one row) stay
//     conflict-free.
//   * The softmax spends one MUFU.EX2 per score, and the tail and causal
//     masks are applied only on the tiles that need them.
//   * Grid (head, Q tile, batch): the head varies fastest, so the 16 CTAs that
//     share a [B, 1, N, N] bias tile run together and read it from HBM once.
//     With causal, the longest Q tiles go first and KV tiles past the
//     diagonal are never loaded; a warpgroup releases unread the tile that
//     lies wholly above its 64 rows.
// Tried on the card and left out (H100, path A's mask arm; PERF.md §6):
// overlapping a tile's softmax with the previous tile's P V inside a
// warpgroup, alone or with the two warpgroups taking turns on named barriers
// (5-10% slower), and Q's fragments in registers (no faster).

#pragma once

#include "sm90.cuh"

namespace fa {

struct FwdBiasParams {
  __nv_bfloat16* o;
  float* lse;          // [B, Hq, Nq] contiguous
  const float* bias;   // f32, unit column stride, 16-byte-aligned rows
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  int hq, rep, nq, kv_valid_len, causal;
  float scale_log2;  // softmax scale * log2(e)
};

}  // namespace fa

namespace {

using namespace fa;

constexpr int FB_BLOCK_M = 128;  // Q rows per CTA: two consumer warpgroups of 64
constexpr int FB_BLOCK_N = 64;   // keys per KV tile
constexpr int FB_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int FB_BOX_ROW = 128;  // bytes per row of a 64-column bf16 box (the swizzle's span)

// Shared-memory layout (bytes, from a 1024-byte-aligned base): Q, then per
// stage K, V (each D / 64 boxes of 64 columns) and the bias tile, then the
// mbarriers q_full, full[STAGES], empty[STAGES].
template <int D>
struct FbSmem {
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q = FB_BLOCK_M * D * 2;
  static constexpr int KV = FB_BLOCK_N * D * 2;
  static constexpr int BIAS = FB_BLOCK_M * FB_BLOCK_N * 4;
  static constexpr int STAGE = 2 * KV + BIAS;
  static constexpr int BARS = Q + STAGES * STAGE;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES) * 8;
  static_assert(Q % 1024 == 0 && KV % 1024 == 0 && BIAS % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// Where column chunk c (4 floats) of row r of the bias tile is stored, in
// floats from the tile's start (the permutation of the header's notes).
__device__ __forceinline__ int bias_slot(int r, int c) {
  return r * FB_BLOCK_N + 4 * (c ^ ((r & 3) << 1));
}

// One tile's scores to probabilities, sc[4jj + 2r + e] being row g + 8r,
// column 8jj + 2t + e: scale into the log2 domain in f32, add the bias, floor
// at the mask value (a bias at the mask value times log2 e would overflow to
// -inf, and a tile of -inf only would make the rescale NaN), and with MASKED
// (a tile over the KV tail or causal's diagonal) set the tail and causal's
// upper triangle to the mask value; then the online max and sum. The bias of
// column 8jj + 2t of row g is at shared address b_addr ^ 32jj (bias_slot's
// permutation: b_addr has bits 5-6 = row % 4 and bits 3-4 = t), row g + 8's
// b_step bytes on (0 for a row-broadcast bias). Returns the rescale factor of
// the earlier tiles' O in alpha.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], uint32_t b_addr, uint32_t b_step,
                                             int n0, int t, int row0, int nkv, bool causal,
                                             float scale_log2, float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2]) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int jj = 0; jj < FB_BLOCK_N / 8; ++jj) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 bv = lds_f2((b_addr ^ (32 * jj)) + r * b_step);
      const float bias2[2] = {bv.x, bv.y};  // K1 bias sm90 read
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * r + e;
        float x = fmaxf(sc[i] * scale_log2 + bias2[e] * LOG2E, MASK_VALUE);
        if (MASKED) {
          const int col = n0 + 8 * jj + 2 * t + e;
          if (col >= nkv || (causal && col > row0 + 8 * r)) x = MASK_VALUE;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m_i[r] - mx[r]);
    m_i[r] = mx[r];
    l_i[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pe = ex2(sc[i] - m_i[(i >> 1) & 1]);
    l_i[(i >> 1) & 1] += pe;
    sc[i] = pe;
  }
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fwd_bias_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const FwdBiasParams p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  using S = FbSmem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S::STAGES;

  const int h = blockIdx.x;
  // Causal: heavy (late) Q tiles first, so the tail of the grid is short.
  const int m_tile = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * FB_BLOCK_M;
  const int b = blockIdx.z;
  const int nkv = p.kv_valid_len;
  // Causal: only KV tiles whose first column is <= this CTA's last row.
  const int n_end = p.causal ? min(nkv, m0 + FB_BLOCK_M) : nkv;
  const int n_tiles = (n_end + FB_BLOCK_N - 1) / FB_BLOCK_N;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::Q + (j % S::STAGES) * S::STAGE; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1 + 128);  // the TMA thread's expect_tx, each producer's cp.async
      mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 issues the TMA loads, all 128 threads the bias copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
    if (tid == 0) {
      mbar_expect_tx(q_full, S::Q);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * FB_BLOCK_M * FB_BOX_ROW, &tm_q, q_full, 64 * x, m0, h, b);
      }
    }
    // The bias tile, 4 columns a copy: thread tid copies chunk c of rows
    // r0 + 8i (row 0 alone for a row-broadcast bias); zeros past Nq (rows
    // never stored) and past kv_valid_len (columns the tail mask sets).
    const int c = tid % (FB_BLOCK_N / 4);
    const int r0 = tid / (FB_BLOCK_N / 4);
    const int bias_rows = p.bias_sn ? FB_BLOCK_M : 1;
    const int rows_valid = p.nq - m0;
    const float* bias_src = p.bias + b * p.bias_sb + h * p.bias_sh  // K1 bias sm90 head
                            + (m0 + r0) * p.bias_sn + 4 * c;
    const int64_t src_step = 8 * p.bias_sn;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S::STAGES;
      const int n0 = j * FB_BLOCK_N;
      unsigned char* st = stage(j);
      mbar_wait(&empty[s], ((j / S::STAGES) & 1) ^ 1);  // round 0 passes at once
      if (tid == 0) {
        mbar_expect_tx(&full[s], 2 * S::KV);
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * FB_BLOCK_N * FB_BOX_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
          tma_load_4d(st + S::KV + x * FB_BLOCK_N * FB_BOX_ROW, &tm_v, &full[s], 64 * x, n0, hk,
                      b);
        }
      }
      const int col_bytes = 4 * min(max(nkv - n0 - 4 * c, 0), 4);
      float* dst = reinterpret_cast<float*>(st + 2 * S::KV) + bias_slot(r0, c);
      if (bias_rows == 1) {
        if (r0 == 0) cp_async_16_zfill(dst, col_bytes ? bias_src + n0 : p.bias, col_bytes);
      } else {
#pragma unroll
        for (int i = 0; i < FB_BLOCK_M / 8; ++i) {
          const int bytes = r0 + 8 * i < rows_valid ? col_bytes : 0;
          cp_async_16_zfill(dst + 8 * i * FB_BLOCK_N, bytes ? bias_src + n0 + i * src_step : p.bias,
                            bytes);
        }
      }
      cp_async_mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // Consumers: warpgroup 1 owns rows m0..m0+63, warpgroup 2 rows m0+64..m0+127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int half = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int r_first = m0 + half * 64;          // this warpgroup's first row
    const int tr = half * 64 + warp * 16 + g;    // row g of this warp in the CTA's tile
    const int row0 = m0 + tr;
    const unsigned char* q_s = smem + half * 64 * FB_BOX_ROW;
    // Causal: the tiles that meet this warpgroup's rows (the rest, past its
    // diagonal, are released unread).
    const int n_mine = p.causal ? min(n_tiles, (r_first + 64 + FB_BLOCK_N - 1) / FB_BLOCK_N)
                                : n_tiles;
    // This thread's bias: its row of the tile (row 0 of a row-broadcast
    // bias), chunk 2jj + t / 2 at bias_slot's place (softmax_tile).
    const int b_row = p.bias_sn ? tr : 0;
    const uint32_t b_off = 4 * (b_row * FB_BLOCK_N + 8 * (b_row & 3) + 2 * t);
    const uint32_t b_step = p.bias_sn ? 4 * 8 * FB_BLOCK_N : 0;
    auto bias_of = [&](int j) { return smem_u32(stage(j) + 2 * S::KV) + b_off; };
    auto masked = [&](int j) {
      return j * FB_BLOCK_N + FB_BLOCK_N > nkv ||
             (p.causal && j * FB_BLOCK_N + FB_BLOCK_N - 1 > r_first);
    };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % S::STAGES]);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Rows g and g + 8; (m, l) in log2 units, l this thread's partial sum over
    // its columns (reduced over the quad at the end; m is quad-uniform).
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[32], alpha[2];
    uint32_t pa[4][4];
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_mine; ++j) {
      mbar_wait(&full[j % S::STAGES], (j / S::STAGES) & 1);
      issue_qk<D, FB_BLOCK_M, FB_BLOCK_N>(sc, q_s, stage(j));
      wgmma_wait<0>();
      fence_regs(sc);
      if (masked(j)) {
        softmax_tile<true>(sc, bias_of(j), b_step, j * FB_BLOCK_N, t, row0, nkv, p.causal,
                           p.scale_log2, m_i, l_i, alpha);
      } else {
        softmax_tile<false>(sc, bias_of(j), b_step, j * FB_BLOCK_N, t, row0, nkv, p.causal,
                            p.scale_log2, m_i, l_i, alpha);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(pa, sc);
      issue_pv<D, FB_BLOCK_N>(o, pa, stage(j) + S::KV);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      release(j);
    }
    for (int j = n_mine; j < n_tiles; ++j) {
      mbar_wait(&full[j % S::STAGES], (j / S::STAGES) & 1);
      release(j);
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
      const int row = row0 + 8 * r;
      if (row < p.nq) {
        __nv_bfloat16* o_row = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_sn;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(o_row + 8 * jj + 2 * t) =
              pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
        }
        if (t == 0) {
          p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
              dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
        }
      }
    }
  }
}

template <int D>
cudaError_t fwd_bias_sm90_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                 const CUtensorMap& tm_v, const FwdBiasParams& p, int batch,
                                 cudaStream_t stream) {
  auto kernel = fwd_bias_sm90_kernel<D>;
  const cudaError_t e = allow_smem(kernel, FbSmem<D>::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nq + FB_BLOCK_M - 1) / FB_BLOCK_M, batch);
  kernel<<<grid, FB_THREADS, FbSmem<D>::BYTES, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

}  // namespace
