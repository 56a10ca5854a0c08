// K1's f32 route for Hopper (sm_90a): the forward body of every f32 call,
// with the options of K1's dense route (fwd_sm90_tile.cuh) -- the causal /
// window band as runtime ints, shifted by q / kv offsets (common.cuh
// band_bounds), segment ids with their tile ranges, the logit softcap, GQA,
// any Nq and kv_valid_len -- computed to f32 accuracy, as the TPU kernel
// computes its f32 calls at Precision.HIGHEST.
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) on f32 inputs and, with causal or a window, K2
// (_fwd_causal_resident_kernel, :516). It computes what the dense route
// computes: scores x = s * scale * log2 e (with the softcap, CAP: x = cap *
// log2 e * tanh(s * scale / cap), the accurate tanhf), the masks (the band,
// the KV tail, unequal segment ids: the finite mask value), the online
// softmax in the log2 domain by exp2f (not ex2.approx: the f32 budget,
// FWD_TOL[f32] 1e-4, leaves no room for a fast-math exponential), O in f32 and
// the LSE in natural log; a row whose largest score is at or below half the
// mask value is dead (O = 0, LSE = ln2 * mask, the convention the backward
// reads).
//
// What bounds it: the two products are f32-accurate only as 3xTF32 (three
// TF32 products per product, common.cuh mma_3xtf32) or as FFMA (67 TFLOP/s):
// at the f32 LM's attention (B1 Hq16 Hkv8 N2049 D128 causal) the products are
// 17.2 GFLOP, 0.104 ms at 165 TFLOP/s (the dense TF32 peak 495 / 3), against
// 24 MB of Q / K / V / O: 0.007 ms at 3.35 TB/s -- operations. wgmma takes a
// TF32 operand only K-major from shared memory (its transpose bits are for
// 16-bit types), so P V would need V transposed in shared memory; this first
// design keeps to mma.sync, whose fragments are the bf16 body's
// (fwd_tile.cuh) at half the depth:
//
//   * One CTA owns 128 Q rows of one (batch, head), 8 warps of 16 rows; Q
//     stays in shared memory as f32 and each warp splits its fragments into
//     TF32 (hi, lo) halves as it reads them.
//   * KV tiles of 64 keys, double-buffered: every thread issues cp.async
//     copies of the next visited tile (K, V and, with SEG, its 64 ids) while
//     the warps work on the current one; rows past kv_valid_len and columns
//     past D are zero-filled, and D 40 / 80 / 96 run in the D 64 / 128 boxes
//     with the k-steps and O's columns past D skipped at run time.
//   * The CTA visits the KV tiles that meet its rows' band (and, with SEG,
//     whose id range meets its Q tile's), each warp computes only the tiles
//     that meet its own 16 rows, and masks only the tiles that the band, the
//     KV tail or a document edge cuts.
//   * S = Q K^T and O += P V on mma.sync.m16n8k8.tf32, 3xTF32: P's C
//     fragments are P V's A fragments with the keys of each 8 taken in the
//     order (0, 2, 4, 6, 1, 3, 5, 7) (common.cuh), V read in that order, so P
//     never leaves registers. Row strides of D + 4 floats keep every
//     fragment load free of bank conflicts.

#pragma once

#include "common.cuh"

namespace fa {

struct FwdF32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;            // [B, Hq, Nq] contiguous
  const int* seg_q;      // [B, Nq] ids, batch stride seg_q_sb, unit along the rows
  const int* seg_kv;     // [B, kv_tiles * 64] ids, contiguous, each row padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 128-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) id of each 64-key tile's keys below kv_valid_len
  int64_t q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh, o_sn;
  int64_t seg_q_sb;
  int hq, rep, nq, d, kv_valid_len;
  int lo, hi;              // band: row - lo <= col <= row + hi (NO_BOUND: none)
  int q_tiles, kv_tiles;   // ceil(Nq / 128), ceil(kv_valid_len / 64)
  float scale_log2;        // softmax scale * log2(e)
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
};

}  // namespace fa

namespace {

using namespace fa;

constexpr int F32_BLOCK_M = 128;  // Q rows per CTA: 8 warps of 16
constexpr int F32_BLOCK_N = 64;   // keys per KV tile
constexpr int F32_THREADS = 256;

// Shared memory (floats): Q [128][DB + 4], then two stages of K and V [64][DB
// + 4] each, then (SEG) the two stages' 64 key ids.
template <int DB>
struct F32FwdSmem {
  static constexpr int DS = DB + 4;
  static constexpr int Q = F32_BLOCK_M * DS;
  static constexpr int KV = F32_BLOCK_N * DS;
  static constexpr int OFF_SEG = Q + 4 * KV;
  static constexpr int BYTES = (OFF_SEG + 2 * F32_BLOCK_N) * 4;
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// The log2-domain score of raw score s (fwd_sm90_tile.cuh's log2_score).
template <bool CAP>
__device__ __forceinline__ float f32_log2_score(float s, float scale_log2, float cap_scale,
                                                float cap_log2) {
  if constexpr (CAP) return cap_log2 * tanhf(s * cap_scale);
  return s * scale_log2;
}

template <int DB, bool SEG, bool CAP>
__global__ void __launch_bounds__(F32_THREADS, 1) fwd_f32_kernel(const FwdF32Params p) {
  static_assert(DB == 64 || DB == 128, "instantiated for D boxes 64 and 128");
  using S = F32FwdSmem<DB>;
  constexpr int DS = S::DS;
  extern __shared__ __align__(16) float smem[];
  int* seg_s = reinterpret_cast<int*>(smem + S::OFF_SEG);

  const int h = blockIdx.x;
  // A right bound (causal): the late Q tiles meet the most KV tiles; run them first.
  const int m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * F32_BLOCK_M;
  const int b = blockIdx.z;
  const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
  const int nkv = p.kv_valid_len;
  // The KV tiles that meet the CTA's rows: columns [m0 - lo, m0 + 127 + hi].
  int n_begin = 0;
  if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / F32_BLOCK_N * F32_BLOCK_N;
  const int n_end = p.hi < NO_BOUND ? min(nkv, m0 + F32_BLOCK_M + p.hi) : nkv;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + F32_BLOCK_N - 1) / F32_BLOCK_N : 0;
  const int t_begin = n_begin / F32_BLOCK_N;
  int2 q_rng = make_int2(0, 0);
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m_tile];
  // The first visited tile at or after j (SEG: whose id range meets the Q
  // tile's); every thread walks the same tiles.
  auto next_visit = [&](int j) {
    if constexpr (SEG) {
      while (j < n_tiles && !ranges_meet(q_rng, p.kv_range[b * p.kv_tiles + t_begin + j])) ++j;
    }
    return j;
  };
  const float* k_base = p.k + b * p.k_sb + hk * p.k_sh;
  const float* v_base = p.v + b * p.v_sb + hk * p.v_sh;
  auto load_kv = [&](int j, int s) {
    const int n0 = n_begin + j * F32_BLOCK_N;
    float* k_s = smem + S::Q + 2 * s * S::KV;
    load_f32_tile<DB, F32_BLOCK_N, F32_THREADS>(k_s, k_base, n0, p.k_sn, nkv - n0, p.d);
    load_f32_tile<DB, F32_BLOCK_N, F32_THREADS>(k_s + S::KV, v_base, n0, p.v_sn, nkv - n0, p.d);
    if constexpr (SEG) {
      if (threadIdx.x < F32_BLOCK_N / 4) {
        cp_async_16(seg_s + s * F32_BLOCK_N + 4 * threadIdx.x,
                    p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * F32_BLOCK_N + n0 +
                        4 * threadIdx.x,
                    16);
      }
    }
  };

  load_f32_tile<DB, F32_BLOCK_M, F32_THREADS>(smem, p.q + b * p.q_sb + h * p.q_sh, m0, p.q_sn,
                                              p.nq - m0, p.d);
  int j = next_visit(0);
  if (j < n_tiles) load_kv(j, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // thread in group
  const int r_first = m0 + 16 * warp;  // this warp's first row
  const int row0 = r_first + g;        // this thread's rows row0 and row0 + 8
  const int dsteps = (p.d + 7) / 8;    // 8-column steps that hold data
  const float* q_w = smem + (16 * warp + g) * DS + t;
  float o[DB / 8][4];
#pragma unroll
  for (int i = 0; i < DB / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // (m, l) in log2 units; l this thread's partial sum over its columns
  // (reduced over the quad at the end; m is quad-uniform).
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};
  int q_seg[2] = {0, 0};
  if constexpr (SEG) {
    const int* ids = p.seg_q + b * p.seg_q_sb;
    q_seg[0] = row0 < p.nq ? ids[row0] : 0;
    q_seg[1] = row0 + 8 < p.nq ? ids[row0 + 8] : 0;
  }

  for (int it = 0; j < n_tiles; ++it) {
    const int nxt = next_visit(j + 1);
    if (nxt < n_tiles) load_kv(nxt, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int s = it & 1;
    const float* k_s = smem + S::Q + 2 * s * S::KV;
    const float* v_s = k_s + S::KV;
    const int c0 = n_begin + j * F32_BLOCK_N;  // the tile's first column
    // The tiles that meet this warp's band, [r_first - lo, r_first + 15 + hi].
    if (r_first < p.nq && c0 <= r_first + 15 + p.hi &&
        c0 + F32_BLOCK_N - 1 >= r_first - p.lo) {
      float sc[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DB / 8; ++ks) {
        if (ks < dsteps) {
          const float* qa = q_w + 8 * ks;
          const float af[4] = {qa[0], qa[8 * DS], qa[4], qa[8 * DS + 4]};
          uint32_t a_hi[4], a_lo[4];
          split_tf32(af, a_hi, a_lo);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float* kb = k_s + (8 * nt + g) * DS + 8 * ks + t;
            const float bf[2] = {kb[0], kb[4]};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(bf, b_hi, b_lo);
            mma_3xtf32(sc[nt], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
      bool edge = c0 + F32_BLOCK_N > nkv || c0 + F32_BLOCK_N - 1 - r_first > p.hi ||
                  r_first + 15 - c0 > p.lo;
      if constexpr (SEG) {
        const int2 k_rng = p.kv_range[b * p.kv_tiles + c0 / F32_BLOCK_N];
        edge = edge || !(q_rng.x == q_rng.y && k_rng.x == k_rng.y && k_rng.x == q_rng.x);
      }
      float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float x = f32_log2_score<CAP>(sc[nt][e], p.scale_log2, p.cap_scale, p.cap_log2);
          if (edge) {
            const int tc = 8 * nt + 2 * t + (e & 1);  // column in the tile
            const int col = c0 + tc;
            const int row = row0 + 8 * r;
            if (col - row > p.hi || row - col > p.lo || col >= nkv) x = MASK_VALUE;  // K1 f32 band mask
            if (SEG && seg_s[s * F32_BLOCK_N + tc] != q_seg[r]) x = MASK_VALUE;
          }
          sc[nt][e] = x;
          mx[r] = fmaxf(mx[r], x);
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
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f(sc[nt][e] - m_i[e >> 1]);
          l_i[e >> 1] += pe;
          sc[nt][e] = pe;
        }
      }
#pragma unroll
      for (int nt = 0; nt < DB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] *= alpha[e >> 1];
      }
      // O += P V: P's C fragments of keys 8kt.. are the A fragment (c0, c2,
      // c1, c3), V's rows 2t and 2t + 1 of them the B fragment.
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        const float pf[4] = {sc[kt][0], sc[kt][2], sc[kt][1], sc[kt][3]};
        uint32_t a_hi[4], a_lo[4];
        split_tf32(pf, a_hi, a_lo);
        const float* vr = v_s + (8 * kt + 2 * t) * DS + g;
#pragma unroll
        for (int nt = 0; nt < DB / 8; ++nt) {
          if (nt < dsteps) {
            const float bf[2] = {vr[8 * nt], vr[DS + 8 * nt]};
            uint32_t b_hi[2], b_lo[2];
            split_tf32(bf, b_hi, b_lo);
            mma_3xtf32(o[nt], a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copy after next
    j = nxt;
  }
  cp_async_wait<0>();

  // Epilogue: O = acc / l, LSE = m ln2 + log l; rows past Nq and O's
  // columns >= D masked on store.
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
      float* o_row = p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_sn;
#pragma unroll
      for (int nt = 0; nt < DB / 8; ++nt) {
        if (8 * nt + 2 * t >= p.d) continue;
        *reinterpret_cast<float2*>(o_row + 8 * nt + 2 * t) =
            make_float2(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
      }
      if (t == 0) {
        p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
            dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
      }
    }
  }
}

}  // namespace
