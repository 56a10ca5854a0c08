// The ring kernels for Hopper (sm_90a), bf16 tensor cores: K7, one forward
// step of ring attention, and K8, one backward step.
//
// Replace the TPU kernels flashattn_tpu/parallel/ring_kernel.py::
// _ring_fwd_kernel (K7, :74, with _merge_tile :257 and _finalize_tile :357)
// and ::_ring_bwd_kernel (K8, :389). Each rank of the ring holds one
// contiguous chunk of Q (nq rows, global rows q_base ..) and, at step s, the
// K/V chunk of rank src = (rank - s) mod P (nk rows, global columns kv_off ..).
// The TPU kernel is ONE launch per device that runs every step on its
// sequential grid and moves the chunks by remote DMA from inside the kernel.
// Here the host runs the ring (flashattn_tpu_torch/parallel/ring_kernel.py):
// one launch per live (rank, step) -- the host knows rank and step, so a chunk
// wholly outside the causal / window band is never launched -- and the
// rotation is a copy (virtual ranks) or torch.distributed send / recv (NCCL
// on the card) between launches, issued for step s + 1 before step s's launch
// so that it overlaps the compute (the hopper guide's table: remote copies
// inside a kernel become NCCL outside it).
//
// K7 (ring_fwd_kernel): one CTA per (64-row Q tile, q head, batch) runs K1's
// online softmax (fwd_tile.cuh) over the KV tiles of the chunk that meet the
// band, in the log2 domain (q arrives pre-scaled by scale * log2 e, as
// ring_kernel.py:886 pre-scales it), with the causal / window masks in GLOBAL
// positions: row q_base + i sees column kv_off + j iff row - lo <= col <= row
// + hi. Its epilogue merges the chunk's partial into the rank's running f32
// state -- the unnormalized accumulator acc [B, Hq, nq, D] and (m, l)
// [B, Hq, nq], m in log2 units -- by the LSE rule of ring_kernel.py:317-354,
// and drops a partial whose chunk max is at or below half the mask value
// (:69-71, :343-345): a row that the band leaves no column in this chunk has
// max = mask value and would add exp2(0) = 1 of garbage. The first live step
// of a rank starts from (m, l, acc) = (mask, 0, 0) without reading the state;
// the last live step finalizes in its epilogue -- O = acc / l in bf16, LSE =
// (m + log2 l) ln2, and O = 0, LSE = -inf on a row that no step gave a column
// (:357-386) -- instead of writing the state back. The TPU kernel needed a
// separate normalize pass because its chunk skip was traced (:219-222); the
// host knows each rank's last live step, so finalize costs no launch.
//
// K8 (ring_bwd_kernel): one CTA per (64-row KV tile of the chunk, KV head,
// batch) -- KV-major like K3 (dkv_tile.cuh) -- reads its tile of the rotating
// f32 (dK, dV) accumulator, loops over the rep = Hq / Hkv query heads of its
// KV head (GQA reduced in the kernel, as ring_kernel.py:118 folds it) and over
// the local Q tiles that meet the band, recomputes P = exp2(S2 - LSE log2 e)
// from the GLOBAL LSE and Delta = rowsum(dO * O), and adds
//   dV += P^T dO      dK += dS^T Q2      with dS = P (dP - Delta),  dP = dO V^T
// before writing the tile back: the CTA owns its tile, so there is no race.
// dQ += dS K goes by f32 atomics into the rank's f32 dQ, zeroed once before the
// ring (the discipline of K3's dQ, and no per-step dQ init as in :667-684).
// Q2 carries scale * log2 e, so the caller multiplies dK by ln2 and dQ by
// scale (ring_kernel.py:726, :934). A dead row (LSE = -inf, or the finite
// dead sentinel) gets P = 0: its LSE is replaced by +inf in shared memory, so
// exp2(S2 - LSE) is exactly 0 rather than exp2(+inf).
//
// The bodies are written here and not by templating fwd_tile.cuh / dkv_tile.cuh:
// the offsets and the merge are runtime state of every launch, and a runtime
// window slowed K1 by 13.7% (PERF.md, PR 5), while a shared masking branch
// edited for the bias changed nvcc's code for kernels without one (K6 +24.9%,
// PR 6). Sharing only common.cuh's helpers leaves every existing
// instantiation's code as it was. Chunks are multiples of 64 rows (the
// wrapper asks for 128, the JAX contract), so there are no ragged tiles.
//
// What bounds them: at the LM's attention width over 4 x 4096 tokens, the
// tensor-core work of the pairs (K1's and K3's arithmetic per tile, mma.sync
// with synchronous global->shared loads, no wgmma or TMA), plus, per step, the
// state's read and write (K7: 4 (D + 2) bytes per row; K8: the f32 dK / dV
// tile and dQ's atomics) and a launch per (rank, step). Left for later PRs:
// what fwd_tile.cuh and dkv_tile.cuh leave, a persistent kernel that runs a
// rank's steps back to back, and the state kept in registers across steps
// where one CTA owns a tile for the whole ring.

#include <type_traits>

#include "common.cuh"

namespace {

using namespace fa;

constexpr int RING_THREADS = 128;   // 4 warps
constexpr int RING_FWD_BLOCK_M = 64;  // K7: Q rows per CTA, 16 per warp
constexpr int RING_BLOCK_N = 64;      // KV rows per tile (K7's inner loop, K8's CTA)
constexpr float NEG_GUARD = 0.5f * MASK_VALUE;

struct RingFwdParams {
  const __nv_bfloat16* q;  // q * scale * log2 e, (batch, head, seq) strides
  const __nv_bfloat16* k;  // the step's K/V chunk, (batch, head, seq) strides
  const __nv_bfloat16* v;
  float* acc;              // [B, Hq, nq, D] f32 contiguous: running unnormalized O
  float* m;                // [B, Hq, nq] f32 contiguous: running max (log2 units)
  float* l;                // [B, Hq, nq] f32 contiguous: running sum
  __nv_bfloat16* o;        // written on the last step, (batch, head, seq) strides
  float* lse;              // [B, Hq, nq] f32 contiguous, written on the last step
  int64_t q_sb, q_sh, q_sn;
  int64_t kv_sb, kv_sh, kv_sn;
  int64_t o_sb, o_sh, o_sn;
  int hq, rep, nq, nk, d;
  int q_base, kv_off;  // global position of the chunk's first Q row / KV column
  int lo, hi;          // band: row - lo <= col <= row + hi (NO_BOUND: none)
  int first, last;
};

struct RingBwdParams {
  const __nv_bfloat16* q;  // q * scale * log2 e
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, Hq, nq] contiguous, natural log (-inf: dead row)
  const float* delta;  // [B, Hq, nq] contiguous
  float* dq;           // [B, Hq, nq, D] f32 contiguous, zeroed before the ring
  float* dk;           // [B, Hkv, nk, D] f32 contiguous: the rotating accumulators
  float* dv;
  int64_t q_sb, q_sh, q_sn;
  int64_t kv_sb, kv_sh, kv_sn;
  int64_t do_sb, do_sh, do_sn;
  int hq, rep, nq, nk, d;
  int q_base, kv_off;
  int lo, hi;
};

template <int DP>
__global__ void __launch_bounds__(RING_THREADS) ring_fwd_kernel(const RingFwdParams p) {
  constexpr int BLOCK_M = RING_FWD_BLOCK_M;
  constexpr int BLOCK_N = RING_BLOCK_N;
  constexpr int STRIDE = DP + 8;
  constexpr int KS_QK = DP / 16;
  constexpr int NT_S = BLOCK_N / 8;
  constexpr int KS_PV = BLOCK_N / 16;
  constexpr int NT_O = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_k = s_q + BLOCK_M * STRIDE;
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;

  const int m0 = blockIdx.x * BLOCK_M;  // local row of the tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // The chunk's KV tiles that meet the tile's band, global columns
  // [r0 - lo, r0 + 63 + hi] (the same for every thread: no divergence).
  const int r0 = p.q_base + m0;
  int n_begin = 0;
  int n_end = p.nk;
  if (p.lo < NO_BOUND) n_begin = max(0, r0 - p.lo - p.kv_off) / BLOCK_N * BLOCK_N;
  if (p.hi < NO_BOUND) n_end = min(p.nk, r0 + BLOCK_M + p.hi - p.kv_off);
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + BLOCK_N - 1) / BLOCK_N : 0;
  // An empty partial merges as a no-op: only the first and the last step
  // still have a state to start or to finalize.
  if (n_tiles == 0 && !p.first && !p.last) return;

  load_tile<DP, BLOCK_M, RING_THREADS>(
      s_q, p.q + b * p.q_sb + h * p.q_sh + static_cast<int64_t>(m0) * p.q_sn, p.q_sn, BLOCK_M,
      p.d);
  const __nv_bfloat16* k_g = p.k + b * p.kv_sb + hk * p.kv_sh;
  const __nv_bfloat16* v_g = p.v + b * p.kv_sb + hk * p.kv_sh;

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  const __nv_bfloat16* s_qw = s_q + warp * 16 * STRIDE;
  const int row0 = r0 + warp * 16 + g;  // global row of fragment row g
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = n_begin + j * BLOCK_N;
    __syncthreads();  // the previous tile is consumed (and s_q is complete)
    load_tile<DP, BLOCK_N, RING_THREADS>(s_k, k_g + static_cast<int64_t>(n0) * p.kv_sn, p.kv_sn,
                                         BLOCK_N, p.d);
    load_tile<DP, BLOCK_N, RING_THREADS>(s_v, v_g + static_cast<int64_t>(n0) * p.kv_sn, p.kv_sn,
                                         BLOCK_N, p.d);
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
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

    // The scores are already in the log2 domain; on a tile that holds a pair
    // outside the band, mask it in global positions.
    const int c0 = p.kv_off + n0;
    const bool edge = c0 + BLOCK_N - 1 - r0 > p.hi || r0 + BLOCK_M - 1 - c0 > p.lo;
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (edge && (col - row > p.hi || row - col > p.lo)) s[nt][e] = MASK_VALUE;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
        s[nt][e] = exp2f(s[nt][e] - m_i[e >> 1]);
        l_i[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
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

  // Epilogue: merge the chunk partial (m_i, l, acc) into the running state
  // (ring_kernel.py:342-347), then write the state back or, on the last live
  // step, finalize into O and LSE (:373-378).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + warp * 16 + g + 8 * r;  // local row
    const int64_t srow = (static_cast<int64_t>(b) * p.hq + h) * p.nq + row;
    const float m_run = p.first ? MASK_VALUE : p.m[srow];
    const float l_run = p.first ? 0.f : p.l[srow];
    const float m_new = fmaxf(m_run, m_i[r]);
    const float a_run = m_run <= NEG_GUARD ? 0.f : exp2f(m_run - m_new);
    const float a_c = m_i[r] <= NEG_GUARD ? 0.f : exp2f(m_i[r] - m_new);
    const float l_new = l_run * a_run + l * a_c;
    float* acc_row = p.acc + srow * p.d;
    if (p.last) {
      const bool alive = l_new > 0.f;
      const float inv = alive ? 1.f / l_new : 0.f;
      __nv_bfloat16* o_row =
          p.o + b * p.o_sb + h * p.o_sh + static_cast<int64_t>(row) * p.o_sn;
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < p.d) {
          float2 prev = make_float2(0.f, 0.f);
          if (!p.first) prev = *reinterpret_cast<const float2*>(acc_row + col);
          *reinterpret_cast<uint32_t*>(o_row + col) =
              pack_bf16((prev.x * a_run + acc[nt][2 * r] * a_c) * inv,
                        (prev.y * a_run + acc[nt][2 * r + 1] * a_c) * inv);
        }
      }
      if (t == 0) p.lse[srow] = alive ? (m_new + log2f(l_new)) * LN2 : -INFINITY;
    } else {
#pragma unroll
      for (int nt = 0; nt < NT_O; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col < p.d) {
          float2 prev = make_float2(0.f, 0.f);
          if (!p.first) prev = *reinterpret_cast<const float2*>(acc_row + col);
          *reinterpret_cast<float2*>(acc_row + col) =
              make_float2(prev.x * a_run + acc[nt][2 * r] * a_c,
                          prev.y * a_run + acc[nt][2 * r + 1] * a_c);
        }
      }
      if (t == 0) {
        p.m[srow] = m_new;
        p.l[srow] = l_new;
      }
    }
  }
}

template <int DP>
__host__ __device__ constexpr int ring_bwd_block_m() {
  return DP <= 64 ? 64 : 32;  // Q rows per inner step (dkv_tile.cuh's block_m)
}

template <int DP>
__host__ __device__ constexpr size_t ring_bwd_smem_bytes() {
  // K, V [64][DP+8]; Q, dO [BM][DP+8]; dS^T [64][BM+8] (bf16); LSE, Delta [BM] (f32)
  return static_cast<size_t>(2 * RING_BLOCK_N + 2 * ring_bwd_block_m<DP>()) * (DP + 8) * 2 +
         static_cast<size_t>(RING_BLOCK_N) * (ring_bwd_block_m<DP>() + 8) * 2 +
         2 * ring_bwd_block_m<DP>() * 4;
}

template <int DP>
__global__ void __launch_bounds__(RING_THREADS) ring_bwd_kernel(const RingBwdParams p) {
  constexpr int BLOCK_N = RING_BLOCK_N;
  constexpr int BLOCK_M = ring_bwd_block_m<DP>();
  constexpr int NUM_WARPS = RING_THREADS / 32;
  constexpr int STRIDE = DP + 8;
  constexpr int DS_STRIDE = BLOCK_M + 8;
  constexpr int KS_D = DP / 16;
  constexpr int NT_Q = BLOCK_M / 8;
  constexpr int KS_Q = BLOCK_M / 16;
  constexpr int NT_D = DP / 8;
  constexpr int KS_N = BLOCK_N / 16;
  constexpr int ROW_GROUPS = BLOCK_M / 16;
  constexpr int WARPS_PER_GROUP = NUM_WARPS / ROW_GROUPS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + BLOCK_N * STRIDE;
  __nv_bfloat16* s_q = s_v + BLOCK_N * STRIDE;
  __nv_bfloat16* s_do = s_q + BLOCK_M * STRIDE;
  __nv_bfloat16* s_ds = s_do + BLOCK_M * STRIDE;
  float* s_lse = reinterpret_cast<float*>(s_ds + BLOCK_N * DS_STRIDE);  // LSE * log2 e
  float* s_dlt = s_lse + BLOCK_M;

  const int n0 = blockIdx.x * BLOCK_N;  // local KV row of the tile
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // The local Q tiles that meet the tile's band, global rows
  // [c0 - hi, c0 + 63 + lo]; none: the accumulator tile stays as it is.
  const int c0 = p.kv_off + n0;
  int m_begin = 0;
  int m_end = p.nq;
  if (p.hi < NO_BOUND) m_begin = max(0, c0 - p.hi - p.q_base) / BLOCK_M * BLOCK_M;
  if (p.lo < NO_BOUND) m_end = min(p.nq, c0 + BLOCK_N + p.lo - p.q_base);
  if (m_end <= m_begin) return;

  load_tile<DP, BLOCK_N, RING_THREADS>(
      s_k, p.k + b * p.kv_sb + hk * p.kv_sh + static_cast<int64_t>(n0) * p.kv_sn, p.kv_sn,
      BLOCK_N, p.d);
  load_tile<DP, BLOCK_N, RING_THREADS>(
      s_v, p.v + b * p.kv_sb + hk * p.kv_sh + static_cast<int64_t>(n0) * p.kv_sn, p.kv_sn,
      BLOCK_N, p.d);

  // This warp's 16 KV rows of the rotating accumulators, in the C fragment
  // layout: rows g and g + 8, columns nt * 8 + 2t, +1.
  const int kv_row0 = n0 + warp * 16 + g;  // local KV row of fragment row g
  const int64_t acc_base = (static_cast<int64_t>(b) * (p.hq / p.rep) + hk) * p.nk;
  float dk_acc[NT_D][4];
  float dv_acc[NT_D][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* dk_row = p.dk + (acc_base + kv_row0 + 8 * r) * p.d;
    const float* dv_row = p.dv + (acc_base + kv_row0 + 8 * r) * p.d;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      const int col = nt * 8 + 2 * t;
      float2 a = make_float2(0.f, 0.f);
      float2 c = make_float2(0.f, 0.f);
      if (col < p.d) {
        a = *reinterpret_cast<const float2*>(dk_row + col);
        c = *reinterpret_cast<const float2*>(dv_row + col);
      }
      dk_acc[nt][2 * r] = a.x;
      dk_acc[nt][2 * r + 1] = a.y;
      dv_acc[nt][2 * r] = c.x;
      dv_acc[nt][2 * r + 1] = c.y;
    }
  }

  const __nv_bfloat16* s_kw = s_k + warp * 16 * STRIDE;
  const __nv_bfloat16* s_vw = s_v + warp * 16 * STRIDE;
  const int tb_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int tb_col = (lane >> 4) * 8;
  const int ta_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int ta_col = ((lane >> 3) & 1) * 8;

  for (int hr = 0; hr < p.rep; ++hr) {
    const int h = hk * p.rep + hr;
    const __nv_bfloat16* q_g = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* do_g = p.dout + b * p.do_sb + h * p.do_sh;
    const int64_t row_base = (static_cast<int64_t>(b) * p.hq + h) * p.nq;
    float* dq_g = p.dq + row_base * p.d;

    for (int m0 = m_begin; m0 < m_end; m0 += BLOCK_M) {
      __syncthreads();  // the previous step's Q / dO / dS^T are consumed
      load_tile<DP, BLOCK_M, RING_THREADS>(s_q, q_g + static_cast<int64_t>(m0) * p.q_sn, p.q_sn,
                                           BLOCK_M, p.d);
      load_tile<DP, BLOCK_M, RING_THREADS>(s_do, do_g + static_cast<int64_t>(m0) * p.do_sn,
                                           p.do_sn, BLOCK_M, p.d);
      for (int i = threadIdx.x; i < BLOCK_M; i += RING_THREADS) {
        const float lse2 = p.lse[row_base + m0 + i] * LOG2E;
        s_lse[i] = lse2 <= NEG_GUARD ? INFINITY : lse2;  // dead row: P = exp2(-inf) = 0
        s_dlt[i] = p.delta[row_base + m0 + i];
      }
      __syncthreads();

      // S^T = K Q2^T (log2 domain) and dP^T = V dO^T, this warp's 16 KV rows.
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
        const uint32_t ak[4] = {ld_b32(s_kw + g * STRIDE + c),
                                ld_b32(s_kw + (g + 8) * STRIDE + c),
                                ld_b32(s_kw + g * STRIDE + c + 8),
                                ld_b32(s_kw + (g + 8) * STRIDE + c + 8)};
        const uint32_t av[4] = {ld_b32(s_vw + g * STRIDE + c),
                                ld_b32(s_vw + (g + 8) * STRIDE + c),
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

      // P^T = exp2(S2^T - LSE log2 e), exactly 0 outside the band;
      // dS^T = P^T (dP^T - Delta), in place of dP^T (no scale: Q2 carries it).
      const int r0 = p.q_base + m0;
      const bool edge = c0 + BLOCK_N - 1 - r0 > p.hi || r0 + BLOCK_M - 1 - c0 > p.lo;
#pragma unroll
      for (int nt = 0; nt < NT_Q; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = nt * 8 + 2 * t + (e & 1);
          const int row = r0 + ql;
          const int col = p.kv_off + kv_row0 + 8 * (e >> 1);
          const bool masked = edge && (col - row > p.hi || row - col > p.lo);
          const float pe = masked ? 0.f : exp2f(s[nt][e] - s_lse[ql]);
          s[nt][e] = pe;
          dp[nt][e] = pe * (dp[nt][e] - s_dlt[ql]);
        }
      }

      // dV += P^T dO and dK += dS^T Q2: A from registers, B by ldmatrix.trans.
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

      // dS^T (bf16) to shared memory: dQ = dS K sums over the tile's 64 KV rows.
#pragma unroll
      for (int nt = 0; nt < NT_Q; ++nt) {
        __nv_bfloat16* row = s_ds + (warp * 16 + g) * DS_STRIDE + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(row) = pack_bf16(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(row + 8 * DS_STRIDE) = pack_bf16(dp[nt][2], dp[nt][3]);
      }
      __syncthreads();

      // dQ rows [m0 + 16 rg, +16) += dS K by f32 atomics: the CTAs of every KV
      // tile of the chunk add into the same rows.
      const int rg = warp % ROW_GROUPS;
      uint32_t a[KS_N][4];
#pragma unroll
      for (int kk = 0; kk < KS_N; ++kk) {
        ldmatrix_x4_trans(a[kk], s_ds + (kk * 16 + ta_row) * DS_STRIDE + rg * 16 + ta_col);
      }
      const int qr0 = m0 + rg * 16 + g;
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
            float* dst = dq_g + static_cast<int64_t>(qr0) * p.d + col;
            atomicAdd(dst, c[j][0]);
            atomicAdd(dst + 1, c[j][1]);
            atomicAdd(dst + 8 * p.d, c[j][2]);
            atomicAdd(dst + 8 * p.d + 1, c[j][3]);
          }
        }
      }
    }
  }

  // The accumulator tile back into the rotating buffers.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* dk_row = p.dk + (acc_base + kv_row0 + 8 * r) * p.d;
    float* dv_row = p.dv + (acc_base + kv_row0 + 8 * r) * p.d;
#pragma unroll
    for (int nt = 0; nt < NT_D; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col < p.d) {
        *reinterpret_cast<float2*>(dk_row + col) =
            make_float2(dk_acc[nt][2 * r], dk_acc[nt][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_row + col) =
            make_float2(dv_acc[nt][2 * r], dv_acc[nt][2 * r + 1]);
      }
    }
  }
}

// Head dims pad to 64 (D <= 64) or 128: only the LM's D128 and the tests'
// D64 are instantiated, zero-filled in shared memory up to the MMA depth.
template <typename Launch>
cudaError_t dispatch_ring_head_dim(int d, Launch&& launch) {
  return d <= 64 ? launch(std::integral_constant<int, 64>{})
                 : launch(std::integral_constant<int, 128>{});
}

bool ring_args_ok(int batch, int d, int hq, int hkv, int nq, int nk) {
  return batch > 0 && d >= 8 && d <= 128 && d % 8 == 0 && hkv > 0 && hq % hkv == 0 && nq > 0 &&
         nk > 0 && nq % RING_BLOCK_N == 0 && nk % RING_BLOCK_N == 0;
}

}  // namespace

extern "C" {

// K7: one ring forward step of one rank. q [B, Hq, nq, D] (q * scale * log2 e)
// and k/v [B, Hkv, nk, D] bf16 with unit stride on D and the given (batch,
// head, seq) strides (k and v share theirs); acc [B, Hq, nq, D] and m, l, lse
// [B, Hq, nq] f32 contiguous; o like q with its own strides. q_base and kv_off
// are the global positions of the chunks' first row and column; causal != 0
// masks col > row, the window (wl, wr) col < row - wl (wl >= 0) and col > row
// + wr (wr >= 0). first != 0: start the state instead of reading it; last != 0:
// write O and LSE instead of the state. Requires 8 <= D <= 128, D % 8 == 0,
// Hq % Hkv == 0, nq and nk multiples of 64. Returns a cudaError_t (0: success).
int fa_ring_fwd_bf16(const void* q, const void* k, const void* v, void* acc, void* m, void* l,
                     void* o, void* lse, int batch, int hq, int hkv, int nq, int nk, int d,
                     int q_base, int kv_off, int causal, int wl, int wr, int first, int last,
                     int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb, int64_t kv_sh,
                     int64_t kv_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn, void* stream) {
  if (!ring_args_ok(batch, d, hq, hkv, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  RingFwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.kv_sb = kv_sb; p.kv_sh = kv_sh; p.kv_sn = kv_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.q_base = q_base;
  p.kv_off = kv_off;
  band_bounds(causal, wl, wr, &p.lo, &p.hi);
  p.first = first != 0;
  p.last = last != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_ring_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr size_t smem =
        static_cast<size_t>(RING_FWD_BLOCK_M + 2 * RING_BLOCK_N) * (DP + 8) * 2;
    void (*kernel)(const RingFwdParams) = ring_fwd_kernel<DP>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(nq / RING_FWD_BLOCK_M, hq, batch);
    kernel<<<grid, RING_THREADS, smem, s>>>(p);
    return cudaGetLastError();
  }));
}

// K8: one ring backward step of one rank. q (q * scale * log2 e) / dout
// [B, Hq, nq, D] and k/v [B, Hkv, nk, D] bf16 with unit stride on D and the
// given strides (k and v share theirs); lse (natural log, -inf on a dead row)
// and delta [B, Hq, nq] f32 contiguous; dq [B, Hq, nq, D] f32 contiguous,
// accumulated by atomics (zero it before the ring); dk/dv [B, Hkv, nk, D] f32
// contiguous, read, accumulated over the query heads of each KV head and
// written back. dq comes out x 1/scale and dk x 1/ln2 of the gradients (q
// carries scale * log2 e). Positions and band as fa_ring_fwd_bf16; the same
// requirements. Returns a cudaError_t (0: success).
int fa_ring_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, void* dk, void* dv, int batch,
                     int hq, int hkv, int nq, int nk, int d, int q_base, int kv_off, int causal,
                     int wl, int wr, int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb,
                     int64_t kv_sh, int64_t kv_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                     void* stream) {
  if (!ring_args_ok(batch, d, hq, hkv, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  RingBwdParams p;
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
  p.kv_sb = kv_sb; p.kv_sh = kv_sh; p.kv_sn = kv_sn;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_sn = do_sn;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.q_base = q_base;
  p.kv_off = kv_off;
  band_bounds(causal, wl, wr, &p.lo, &p.hi);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_ring_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    constexpr size_t smem = ring_bwd_smem_bytes<DP>();
    void (*kernel)(const RingBwdParams) = ring_bwd_kernel<DP>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(nk / RING_BLOCK_N, hkv, batch);
    kernel<<<grid, RING_THREADS, smem, s>>>(p);
    return cudaGetLastError();
  }));
}

}  // extern "C"
