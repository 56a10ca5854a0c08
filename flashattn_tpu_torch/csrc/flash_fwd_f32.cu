// K1's f32 route for Hopper (sm_90a): the forward of every f32 call, with the
// options of K1's dense route (fwd_sm90_tile.cuh) -- the causal / window band
// as runtime ints, shifted by q / kv offsets (common.cuh band_bounds),
// segment ids with their tile ranges, the logit softcap, GQA, any Nq (decode
// shapes too) and kv_valid_len -- computed to f32 accuracy as the TPU
// kernel computes its f32 calls at Precision.HIGHEST: on bf16 pieces.
// With BIAS, an additive f32 bias [B|1, H|1, Nq|1, Nk] (K1's bias route's,
// fwd_sm90_tile.cuh) with all of these. Kernels fwd_f32_kernel<D, SEG, CAP,
// BIAS> (D 64 and 128, every D <= 128 that is a multiple of 8 by the TMA
// boxes' zero fill), its D 256 form fwd_f32_wide_kernel<SEG, CAP, BIAS>
// (every D 136-256: 64 Q rows a CTA, its notes below) and the C entry
// fa_fwd_f32.
//
// With RING the same kernels are K7's f32 forms, one ring forward step of
// one rank (C entry fa_ring_fwd_f32): they replace
// flashattn_tpu/parallel/ring_kernel.py::_ring_fwd_kernel (K7, :74) on f32,
// whose products the JAX kernel takes at Precision.HIGHEST (:280). At the f32
// LM's attention (B1 Hq16 Hkv8 D128) a full off-diagonal 4096 x 4096 chunk
// pair is 137 GFLOP of f32 products, six bf16 products each: 0.83 ms at 165
// TFLOP/s, against ~140 MB of Q, K / V and f32 state (0.04 ms): operations,
// as for K1. So K7 is this body unchanged in its main loop -- the band shifted
// by q_base - kv_off, scale_log2 = 1 (q arrives pre-scaled into the log2
// domain) -- with the ring's epilogue (ring_merge.cuh: the chunk's partial
// merged into the rank's f32 (acc, m, l), or O and the LSE on its last live
// step) in place of K1's. The C entry splits k and v on each live step (they
// rotate as f32: 4 bytes an element on the wire, not the pieces' 6) and q
// only on the rank's first (q does not rotate; the pieces stay in the
// caller's scratch for the ring).
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) on f32 inputs and, with causal or a window, K2
// (_fwd_causal_resident_kernel, :516). It computes what the dense route
// computes -- scores x = s * scale * log2 e (CAP: x = cap * log2 e * tanh(s
// * scale / cap), the accurate tanhf; BIAS: + bias * log2 e, added in f32,
// not split, and floored at the mask value), the masks (the band, the KV tail,
// unequal segment ids: the finite mask value), the online softmax in the
// log2 domain by exp2f (not ex2.approx: FWD_TOL[f32], 1e-4, leaves no room
// for it), O in f32 and the LSE in natural log; a row whose largest score is
// at or below half the mask value is dead (O = 0, LSE = ln2 * mask, the
// convention the backward reads) -- with each f32 product taken as the JAX
// kernel's MXU takes it: the C entry first splits Q, K and V into three
// bf16 pieces each (x = x0 + x1 + x2; one launch of split_bf16x3.cu into
// scratch the caller gives), the kernel reads the pieces, P is split the
// same way in registers, and S = Q K^T and O += P V are each the six bf16
// products a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0, summed in f32, the
// small ones first. The split leaves ~2^-24 |x| and the dropped products
// 2^-24 of the product or less; 3xTF32 (the mma.sync body this one
// replaced) left ~2^-22.
//
// What bounds it: operations. At the f32 LM's attention (B1 Hq16 Hkv8 N2049
// D128 causal) the two f32 products are 17.2 GFLOP, six bf16 products each:
// 0.104 ms at 989 / 6 = 165 TFLOP/s, against 24 MB of Q / K / V / O (0.007
// ms at 3.35 TB/s; the split writes 50 MB of pieces, which this kernel reads
// mostly from L2). bf16 wgmma has transpose bits, so this body is
// fwd_sm90_tile.cuh's dense route on pieces:
//
//   * One CTA owns 128 Q rows of one (batch, head): warpgroup 0 is the
//     producer (one thread issues every TMA copy; setmaxnreg gives its
//     registers away), warpgroups 1 and 2 the consumers, 64 rows each, with
//     f32 (m, l, O) in registers.
//   * Q's three pieces come once (4-D maps over the pieces' [3B, H, N, D]:
//     piece p of batch b at batch p B + b), K's and V's through rings of
//     their own, each slot a 64-key tile of all three pieces on its own full /
//     empty mbarriers, so K's next tile loads during this tile's softmax and
//     P V, and V's during the next S.
//   * Shared memory at D 128: Q 3 x 128 rows x 256 B = 96 KB, a K slot 3 x
//     64 x 256 B = 48 KB, a V slot 48 KB: one slot each, 192 KB (two slots of
//     each, 288 KB, pass the 227 KB; 32-key slots would halve S's wgmma width
//     and double the softmax's rescales). At D 64 everything halves: three
//     slots each, 48 + 72 + 72 = 192 KB.
//   * S = Q K^T: six wgmma m64n64k16 chains from shared memory into one
//     accumulator. The f32 S goes through the dense route's softmax
//     (dense_softmax_tile with exp2f); P is split into three bf16 A fragments
//     (the accumulator layout is the A layout), and O += P V is six chains of
//     wgmma with A from registers, V's pieces the N-major B (transpose bit).
//   * BIAS: the bias route's bias stream (fwd_sm90_tile.cuh) on the K ring.
//     The tile (128 rows x 64 keys of f32, 32 KB) comes by 16-byte cp.async
//     from all 128 producer threads, 16 copies each (one row alone for a
//     row-broadcast bias: a TMA map cannot take its zero row stride), each
//     thread's completion arriving on the K slot's full barrier (1 + 128
//     arrivals), from the tile's absolute column n0 (a band shifted by
//     offsets starts at n_begin, not 0) through the (batch, head, row)
//     strides, 0 on broadcast dims; zeros past Nq and past kv_valid_len.
//     The bias is read in the softmax, so the K slot is released after it,
//     as before. Its rows keep the bias route's chunk permutation (chunk c
//     of row r at c ^ 2 (r % 4)), so the two rows a thread reads are
//     conflict-free float2 loads. Shared memory at D 128: 192 KB + one bias
//     slot of 32 KB + the ids, alignment and barriers = 230,696 B of the
//     232,448. At D 64 three K / V / bias stages (48 + 3 x 80 KB) pass the
//     limit, so the BIAS family keeps two (48 + 2 x 80 = 208 KB): a bias
//     ring of its own would need its own barriers for the same bytes.
//   * The CTA visits the KV tiles that meet its rows' band, [m0 - lo, m0 +
//     127 + hi] (with segment ids, those whose id range meets the Q tile's;
//     the tile's 64 ids come by a bulk copy on the K slot's barrier), each
//     warpgroup computes only the tiles that meet its own 64 rows, and masks
//     only those that the band, the KV tail or a document edge cuts. With a
//     right bound (causal) the longest Q tiles go first.

#include "fwd_sm90_tile.cuh"
#include "ring_merge.cuh"
#include "split_bf16x3.cuh"

namespace fa {

struct FwdF32Params {
  float* o;
  float* lse;            // [B, Hq, Nq] contiguous
  const int* seg_q;      // [B, Nq] ids, batch stride seg_q_sb, unit along the rows
  const int* seg_kv;     // [B, kv_tiles * 64] ids, contiguous, each row padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 128-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) id of each 64-key tile's keys
  int64_t o_sb, o_sh, o_sn;
  int64_t seg_q_sb;
  int batch, hq, rep, nq, d, kv_valid_len;
  int lo, hi;              // band: row - lo <= col <= row + hi (NO_BOUND: none)
  int q_tiles, kv_tiles;   // ceil(Nq / 128), ceil(kv_valid_len / 64)
  float scale_log2;        // softmax scale * log2(e)
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
  const float* bias;       // BIAS: f32, unit column stride, 16-byte-aligned rows
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  RingState ring;          // RING: the ring's running state (ring_merge.cuh)
};

}  // namespace fa

namespace {

using namespace fa;

constexpr int F32_BLOCK_M = 128;  // Q rows per CTA: two consumer warpgroups of 64
constexpr int F32_BLOCK_N = 64;   // keys per KV tile
constexpr int F32_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int F32W_BLOCK_M = 64;  // the D 256 form's Q rows per CTA: one consumer warpgroup
constexpr int F32W_THREADS = 256;  // its producer warpgroup + consumer warpgroup

// Shared-memory layout (bytes, from a 1024-byte-aligned base): Q's three
// pieces (each D / 64 boxes of 128 rows), STAGES K slots and STAGES V slots
// (each three pieces of D / 64 boxes of 64 rows), with BIAS the K slots'
// bias tiles, the K slots' 64 segment ids, then the mbarriers q_full,
// k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES].
template <int D, bool BIAS = false>
struct F32FwdSmem {
  static constexpr int STAGES = D == 64 ? (BIAS ? 2 : 3) : 1;
  static constexpr int QP = F32_BLOCK_M * D * 2;  // one piece of Q
  static constexpr int KP = F32_BLOCK_N * D * 2;  // one piece of a K or V tile
  static constexpr int SLOT = 3 * KP;
  static constexpr int BIAS_TILE = BIAS ? F32_BLOCK_M * F32_BLOCK_N * 4 : 0;
  static constexpr int OFF_K = 3 * QP;
  static constexpr int OFF_V = OFF_K + STAGES * SLOT;
  static constexpr int OFF_BIAS = OFF_V + STAGES * SLOT;   // float[STAGES][128 * 64]
  static constexpr int OFF_SEG = OFF_BIAS + STAGES * BIAS_TILE;  // int[STAGES][64]
  static constexpr int BARS = OFF_SEG + STAGES * F32_BLOCK_N * 4;
  static constexpr int BYTES = 1024 + BARS + (1 + 4 * STAGES) * 8;
  static_assert(QP % 1024 == 0 && KP % 1024 == 0, "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// Issue S = Q K^T for one warpgroup's 64 rows: q_s at the warpgroup's first
// row of piece 0 (pieces QP bytes apart, boxes of 128 rows), k_s the K slot
// (pieces KP apart, boxes of 64 rows); the first product starts S at 0.
template <int D>
__device__ __forceinline__ void issue_qk6(float (&sc)[32], const unsigned char* q_s,
                                          const unsigned char* k_s) {
  using S = F32FwdSmem<D>;
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    const unsigned char* a = q_s + pair_a(x) * S::QP;
    const unsigned char* b = k_s + pair_b(x) * S::KP;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_m64n64k16(
          sc, smem_desc(a + (kk / 4) * F32_BLOCK_M * SW128_ROW + (kk % 4) * 32, 16, 1024),
          smem_desc(b + (kk / 4) * F32_BLOCK_N * SW128_ROW + (kk % 4) * 32, 16, 1024),
          x > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

// Issue O += P V: pa[i] P's piece i as A fragments, v_s the V slot (pieces KP
// apart, N-major boxes of 64 rows).
template <int D>
__device__ __forceinline__ void issue_pv6(float (&o)[D / 2], const uint32_t (&pa)[3][4][4],
                                          const unsigned char* v_s) {
  using S = F32FwdSmem<D>;
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x) {
    const unsigned char* b = v_s + pair_b(x) * S::KP;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_pv<D>(o, pa[pair_a(x)][kk],
                  smem_desc(b + kk * 16 * SW128_ROW, F32_BLOCK_N * SW128_ROW, 1024));
    }
  }
  wgmma_commit();
}

template <int D, bool SEG, bool CAP, bool BIAS, bool RING>
__global__ void __launch_bounds__(F32_THREADS, 1)
    fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const FwdF32Params p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  using S = F32FwdSmem<D, BIAS>;
  constexpr int BOXES = D / 64;
  constexpr int ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  auto k_slot = [&](int s) { return smem + S::OFF_K + s * S::SLOT; };
  auto v_slot = [&](int s) { return smem + S::OFF_V + s * S::SLOT; };
  auto bias_slot_base = [&](int s) { return smem + S::OFF_BIAS + s * S::BIAS_TILE; };

  const int h = blockIdx.x;
  // A right bound (causal): the late Q tiles meet the most KV tiles; run them first.
  const int m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * F32_BLOCK_M;
  const int b = blockIdx.z;
  const int nkv = p.kv_valid_len;
  // The KV tiles from n_begin that meet the CTA's rows: columns [m0 - lo, m0 + 127 + hi].
  int n_begin = 0;
  if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / F32_BLOCK_N * F32_BLOCK_N;
  const int n_end = p.hi < NO_BOUND ? min(nkv, m0 + F32_BLOCK_M + p.hi) : nkv;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + F32_BLOCK_N - 1) / F32_BLOCK_N : 0;
  const int t_begin = n_begin / F32_BLOCK_N;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // SEG: the Q tile's id range; producer and consumers visit the same KV
  // tiles, those whose id range meets it.
  int2 q_rng = make_int2(0, 0);
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m_tile];
  auto kv_rng = [&](int j) { return p.kv_range[b * p.kv_tiles + t_begin + j]; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      // The TMA thread's expect_tx (BIAS: and each producer thread's cp.async).
      mbar_init(&k_full[s], BIAS ? 1 + 128 : 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
    if (tid == 0) {
      mbar_expect_tx(q_full, 3 * S::QP);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(smem + pc * S::QP + x * F32_BLOCK_M * SW128_ROW, &tm_q, q_full, 64 * x, m0,
                      h, pc * p.batch + b);
        }
      }
    }
    // BIAS: thread tid copies 4 columns (chunk c) of rows r0 + 8i of each
    // tile (row 0 alone for a row-broadcast bias); zeros past Nq (rows never
    // stored) and past kv_valid_len (columns the tail mask sets).
    const int c = tid % (F32_BLOCK_N / 4);
    const int r0 = tid / (F32_BLOCK_N / 4);
    const float* bias_src = nullptr;
    if constexpr (BIAS) {
      bias_src = p.bias + b * p.bias_sb + h * p.bias_sh + (m0 + r0) * p.bias_sn + 4 * c;
    }
    if (BIAS || tid == 0) {
      int it = 0;  // tiles issued
      for (int j = 0; j < n_tiles; ++j) {
        if constexpr (SEG) {
          if (!ranges_meet(q_rng, kv_rng(j))) continue;
        }
        const int s = it % ST;
        const int parity = ((it / ST) & 1) ^ 1;  // round 0 passes at once
        const int n0 = n_begin + j * F32_BLOCK_N;
        mbar_wait(&k_empty[s], parity);
        if (tid == 0) {
          mbar_expect_tx(&k_full[s], S::SLOT + (SEG ? F32_BLOCK_N * 4 : 0));
#pragma unroll
          for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
            for (int x = 0; x < BOXES; ++x) {
              tma_load_4d(k_slot(s) + pc * S::KP + x * F32_BLOCK_N * SW128_ROW, &tm_k,
                          &k_full[s], 64 * x, n0, hk, pc * p.batch + b);
            }
          }
          if constexpr (SEG) {
            bulk_load(smem + S::OFF_SEG + s * F32_BLOCK_N * 4,
                      p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * F32_BLOCK_N + n0,
                      F32_BLOCK_N * 4, &k_full[s]);
          }
        }
        if constexpr (BIAS) {
          const int col_bytes = 4 * min(max(nkv - n0 - 4 * c, 0), 4);
          float* dst = reinterpret_cast<float*>(bias_slot_base(s)) + bias_slot(r0, c);
          const float* src = bias_src + n0;  // K1 f32 bias column
          if (p.bias_sn == 0) {
            if (r0 == 0) cp_async_16_zfill(dst, col_bytes ? src : p.bias, col_bytes);
          } else {
#pragma unroll
            for (int i = 0; i < F32_BLOCK_M / 8; ++i) {
              const int bytes = r0 + 8 * i < p.nq - m0 ? col_bytes : 0;
              cp_async_16_zfill(dst + 8 * i * F32_BLOCK_N,
                                bytes ? src + i * 8 * p.bias_sn : p.bias, bytes);
            }
          }
          cp_async_mbar_arrive(&k_full[s]);
        }
        if (tid == 0) {
          mbar_wait(&v_empty[s], parity);
          mbar_expect_tx(&v_full[s], S::SLOT);
#pragma unroll
          for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
            for (int x = 0; x < BOXES; ++x) {
              tma_load_4d(v_slot(s) + pc * S::KP + x * F32_BLOCK_N * SW128_ROW, &tm_v,
                          &v_full[s], 64 * x, n0, hk, pc * p.batch + b);
            }
          }
        }
        ++it;
      }
      if constexpr (BIAS) asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // Consumers: warpgroup 1 owns rows m0..m0+63, warpgroup 2 rows m0+64..m0+127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int half = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int r_first = m0 + half * 64;                  // this warpgroup's first row
    const int row0 = r_first + warp * 16 + g;            // this thread's rows row0, row0 + 8
    const unsigned char* q_s = smem + half * 64 * SW128_ROW;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // Rows g and g + 8; (m, l) in log2 units, l this thread's partial sum over
    // its columns (reduced over the quad at the end; m is quad-uniform).
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[32], alpha[2];
    uint32_t pa[3][4][4];
    int q_seg[2] = {0, 0};  // SEG: the ids of rows g and g + 8 (rows past Nq are never stored)
    if constexpr (SEG) {
      const int* q_ids = p.seg_q + b * p.seg_q_sb;
      q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
      q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
    }
    const bool q_one_doc = q_rng.x == q_rng.y;
    // BIAS: this thread's bias, its row of the tile (row 0 of a
    // row-broadcast bias) at bias_slot's place (dense_softmax_tile).
    uint32_t b_off = 0, b_step = 0;
    if constexpr (BIAS) {
      const int b_row = p.bias_sn ? row0 - m0 : 0;
      b_off = 4 * (b_row * F32_BLOCK_N + 8 * (b_row & 3) + 2 * t);
      b_step = p.bias_sn ? 4 * 8 * F32_BLOCK_N : 0;
    }
    mbar_wait(q_full, 0);
    int it = 0;  // tiles visited, in the producer's order
    for (int j = 0; j < n_tiles; ++j) {
      int2 k_rng = make_int2(0, 0);
      if constexpr (SEG) {
        k_rng = kv_rng(j);
        if (!ranges_meet(q_rng, k_rng)) continue;
      }
      const int s = it % ST;
      const int parity = (it / ST) & 1;
      const int c0 = n_begin + j * F32_BLOCK_N;  // the tile's first column
      mbar_wait(&k_full[s], parity);
      // A tile that meets this warpgroup's band, [r_first - lo, r_first + 63
      // + hi]; the others are released unread.
      if (c0 <= r_first + 63 + p.hi && c0 + F32_BLOCK_N - 1 >= r_first - p.lo) {
        issue_qk6<D>(sc, q_s, k_slot(s));
        wgmma_wait<0>();
        fence_regs(sc);
        const bool edge = c0 + F32_BLOCK_N > nkv || c0 + F32_BLOCK_N - 1 - r_first > p.hi ||
                          r_first + 63 - c0 > p.lo ||
                          (SEG && !(q_one_doc && k_rng.x == k_rng.y && k_rng.x == q_rng.x));
        const int* ids = reinterpret_cast<const int*>(smem + S::OFF_SEG + s * F32_BLOCK_N * 4);
        const uint32_t b_addr = BIAS ? smem_u32(bias_slot_base(s)) + b_off : 0;
        if (edge) {
          dense_softmax_tile<true, SEG, CAP, true, BIAS>(
              sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
              p.cap_log2, m_i, l_i, alpha, b_addr, b_step);
        } else {
          dense_softmax_tile<false, SEG, CAP, true, BIAS>(
              sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
              p.cap_log2, m_i, l_i, alpha, b_addr, b_step);
        }
        release(&k_empty[s]);  // S, the tile's ids and its bias have been read
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        split3_frags<4>(pa, sc);
        mbar_wait(&v_full[s], parity);
        issue_pv6<D>(o, pa, v_slot(s));
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) fence_regs(pa[pc][kk]);
        }
      } else {
        release(&k_empty[s]);
        mbar_wait(&v_full[s], parity);
      }
      release(&v_empty[s]);
      ++it;
    }

    // Epilogue: O = acc / l, LSE = m ln2 + log l; ragged rows and O's
    // columns >= D (zeros the boxes read) masked on store. RING: K7's merge
    // into the ring's state, or its finalize (ring_merge.cuh).
    if constexpr (RING) {
      ring_merge_store<D>(p.ring, p.o, p.o_sb, p.o_sh, p.o_sn, p.lse, p.hq, p.nq, p.d, o, m_i,
                          l_i, b, h, row0, t);
      return;
    }
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
        for (int jj = 0; jj < D / 8; ++jj) {
          if (8 * jj + 2 * t >= p.d) continue;
          *reinterpret_cast<float2*>(o_row + 8 * jj + 2 * t) =
              make_float2(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
        }
        if (t == 0) {
          p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
              dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
        }
      }
    }
  }
}

// The D 256 form (every D 136-256): Q's three pieces of 64 rows (4 boxes
// each), then two chunk slots, each one 128-column half of a K or V tile's
// three pieces (2 boxes of 64 keys), with BIAS the tile's bias [64 rows x 64
// keys] f32 on a barrier pair of its own, the tile's 64 ids, then the
// mbarriers q_full, full[2], empty[2], bias_full, bias_empty.
template <bool BIAS>
struct F32WideFwdSmem {
  static constexpr int QP = F32W_BLOCK_M * 256 * 2;   // one piece of Q
  static constexpr int CP = F32_BLOCK_N * 128 * 2;    // one piece of a chunk
  static constexpr int SLOT = 3 * CP;
  static constexpr int OFF_SLOT = 3 * QP;
  static constexpr int BIAS_TILE = BIAS ? F32W_BLOCK_M * F32_BLOCK_N * 4 : 0;
  static constexpr int OFF_BIAS = OFF_SLOT + 2 * SLOT;
  static constexpr int OFF_SEG = OFF_BIAS + BIAS_TILE;  // int[64]
  static constexpr int BARS = OFF_SEG + F32_BLOCK_N * 4;
  static constexpr int BYTES = 1024 + BARS + 7 * 8;
  static_assert(QP % 1024 == 0 && CP % 1024 == 0, "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// K1's f32 route at D 256. The D 128 layout does not double (Q's pieces
// alone would be 192 KB), so a CTA owns 64 Q rows of one (batch, head):
// warpgroup 0 the producer (thread 0 issues the TMA copies; with BIAS all
// 128 copy the bias tile by cp.async), warpgroup 1 the one consumer, its
// f32 O (128 registers a thread) in two halves of 128 columns. Every KV tile
// comes as four chunks through a two-slot ring -- K's column halves, then
// V's -- so V's halves load during the softmax and the next K's during P V.
// S = Q K^T: six wgmma m64n64k16 chains over both K halves into one
// accumulator, the small products first; O += P V: six chains of m64n128k16
// per half, P's three pieces from registers. The two-CTA cluster that
// splits D (each CTA the D 128 body on its half, the partial S summed
// through distributed shared memory) would keep 128 rows a pair, but its
// 32 KB exchange buffer leaves no room for a bias tile beside the D 128
// layout's 192 KB; 64 rows leave 16 KB for it in shared memory. No
// setmaxnreg: at 256 threads a thread may hold 255 registers.
template <bool SEG, bool CAP, bool BIAS, bool RING>
__global__ void __launch_bounds__(F32W_THREADS, 1)
    fwd_f32_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const FwdF32Params p) {
  using S = F32WideFwdSmem<BIAS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + 2;
  uint64_t* bias_full = empty + 2;
  uint64_t* bias_empty = bias_full + 1;
  auto slot = [&](int s) { return smem + S::OFF_SLOT + s * S::SLOT; };
  const int* ids = reinterpret_cast<const int*>(smem + S::OFF_SEG);

  const int h = blockIdx.x;
  const int m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * F32W_BLOCK_M;
  const int b = blockIdx.z;
  const int nkv = p.kv_valid_len;
  int n_begin = 0;
  if (p.lo < NO_BOUND) n_begin = max(0, m0 - p.lo) / F32_BLOCK_N * F32_BLOCK_N;
  const int n_end = p.hi < NO_BOUND ? min(nkv, m0 + F32W_BLOCK_M + p.hi) : nkv;
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + F32_BLOCK_N - 1) / F32_BLOCK_N : 0;
  const int t_begin = n_begin / F32_BLOCK_N;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // SEG: the id range of the 128-row tile that holds these 64 rows (the C
  // entry's ranges; a superset of theirs, so no visited tile is missed).
  int2 q_rng = make_int2(0, 0);
  if constexpr (SEG) q_rng = p.q_range[b * p.q_tiles + m0 / F32_BLOCK_M];
  auto kv_rng = [&](int j) { return p.kv_range[b * p.kv_tiles + t_begin + j]; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(bias_full, 128);  // each producer thread's cp.async
    mbar_init(bias_empty, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    const int hk = h / p.rep;
    if (tid == 0) {
      mbar_expect_tx(q_full, 3 * S::QP);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          tma_load_4d(smem + pc * S::QP + x * F32W_BLOCK_M * SW128_ROW, &tm_q, q_full, 64 * x, m0,
                      h, pc * p.batch + b);
        }
      }
    }
    // One chunk: the column half `half` of K's or V's tile at n0 into the
    // next slot (ring position it); K's first half brings the tile's ids.
    auto chunk = [&](const CUtensorMap* map, int half, int n0, int it, bool with_ids) {
      const int s = it & 1;
      mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);  // round 0 passes at once
      mbar_expect_tx(&full[s], S::SLOT + (with_ids ? F32_BLOCK_N * 4 : 0));
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          tma_load_4d(slot(s) + pc * S::CP + x * F32_BLOCK_N * SW128_ROW, map, &full[s],
                      64 * (2 * half + x), n0, hk, pc * p.batch + b);
        }
      }
      if (with_ids) {
        bulk_load(smem + S::OFF_SEG,
                  p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * F32_BLOCK_N + n0,
                  F32_BLOCK_N * 4, &full[s]);
      }
    };
    // BIAS: thread tid copies 4 columns (chunk c) of rows r0 + 8i (row 0
    // alone for a row-broadcast bias); zeros past Nq and past kv_valid_len.
    const int c = tid % (F32_BLOCK_N / 4);
    const int r0 = tid / (F32_BLOCK_N / 4);
    const float* bias_src = nullptr;
    if constexpr (BIAS) {
      bias_src = p.bias + b * p.bias_sb + h * p.bias_sh + (m0 + r0) * p.bias_sn + 4 * c;
    }
    if (BIAS || tid == 0) {
      int it = 0, v = 0;  // chunks and tiles issued
      for (int j = 0; j < n_tiles; ++j) {
        if constexpr (SEG) {
          if (!ranges_meet(q_rng, kv_rng(j))) continue;
        }
        const int n0 = n_begin + j * F32_BLOCK_N;
        if (tid == 0) {
          chunk(&tm_k, 0, n0, it, SEG);
          chunk(&tm_k, 1, n0, it + 1, false);
        }
        if constexpr (BIAS) {
          mbar_wait(bias_empty, (v & 1) ^ 1);
          const int col_bytes = 4 * min(max(nkv - n0 - 4 * c, 0), 4);
          float* dst = reinterpret_cast<float*>(smem + S::OFF_BIAS) + bias_slot(r0, c);
          const float* src = bias_src + n0;  // K1 f32 d256 bias column
          if (p.bias_sn == 0) {
            if (r0 == 0) cp_async_16_zfill(dst, col_bytes ? src : p.bias, col_bytes);
          } else {
#pragma unroll
            for (int i = 0; i < F32W_BLOCK_M / 8; ++i) {
              const int bytes = r0 + 8 * i < p.nq - m0 ? col_bytes : 0;
              cp_async_16_zfill(dst + 8 * i * F32_BLOCK_N,
                                bytes ? src + i * 8 * p.bias_sn : p.bias, bytes);
            }
          }
          cp_async_mbar_arrive(bias_full);
        }
        if (tid == 0) {
          chunk(&tm_v, 0, n0, it + 2, false);
          chunk(&tm_v, 1, n0, it + 3, false);
        }
        it += 4;
        ++v;
      }
      if constexpr (BIAS) asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = m0 + warp * 16 + g;  // this thread's rows row0, row0 + 8
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o[2][64];  // O's column halves
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[hf][i] = 0.f;
    }
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float sc[32], alpha[2];
    uint32_t pa[3][4][4];
    int q_seg[2] = {0, 0};
    if constexpr (SEG) {
      const int* q_ids = p.seg_q + b * p.seg_q_sb;
      q_seg[0] = row0 < p.nq ? q_ids[row0] : 0;
      q_seg[1] = row0 + 8 < p.nq ? q_ids[row0 + 8] : 0;
    }
    const bool q_one_doc = q_rng.x == q_rng.y;
    uint32_t b_off = 0, b_step = 0;
    if constexpr (BIAS) {
      const int b_row = p.bias_sn ? row0 - m0 : 0;
      b_off = smem_u32(smem + S::OFF_BIAS) + 4 * (b_row * F32_BLOCK_N + 8 * (b_row & 3) + 2 * t);
      b_step = p.bias_sn ? 4 * 8 * F32_BLOCK_N : 0;
    }
    mbar_wait(q_full, 0);
    int v = 0;  // tiles visited, in the producer's order
    for (int j = 0; j < n_tiles; ++j) {
      int2 k_rng = make_int2(0, 0);
      if constexpr (SEG) {
        k_rng = kv_rng(j);
        if (!ranges_meet(q_rng, k_rng)) continue;
      }
      const int c0 = n_begin + j * F32_BLOCK_N;
      // K's halves are in slots 0 and 1 (the phase of each slot's even
      // use), V's after them (the odd use).
      mbar_wait(&full[0], 0);
      mbar_wait(&full[1], 0);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < 6; ++x) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const unsigned char* a = smem + pair_a(x) * S::QP + 2 * hf * F32W_BLOCK_M * SW128_ROW;
          const unsigned char* kb = slot(hf) + pair_b(x) * S::CP;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            wgmma_ss_m64n64k16(
                sc,
                smem_desc(a + (kk / 4) * F32W_BLOCK_M * SW128_ROW + (kk % 4) * 32, 16, 1024),
                smem_desc(kb + (kk / 4) * F32_BLOCK_N * SW128_ROW + (kk % 4) * 32, 16, 1024),
                x > 0 || hf > 0 || kk > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(&empty[0]);
      release(&empty[1]);
      const bool edge = c0 + F32_BLOCK_N > nkv || c0 + F32_BLOCK_N - 1 - m0 > p.hi ||
                        m0 + F32W_BLOCK_M - 1 - c0 > p.lo ||
                        (SEG && !(q_one_doc && k_rng.x == k_rng.y && k_rng.x == q_rng.x));
      if constexpr (BIAS) mbar_wait(bias_full, v & 1);
      if (edge) {
        dense_softmax_tile<true, SEG, CAP, true, BIAS>(
            sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
            p.cap_log2, m_i, l_i, alpha, b_off, b_step);
      } else {
        dense_softmax_tile<false, SEG, CAP, true, BIAS>(
            sc, c0, row0, t, p.lo, p.hi, nkv, ids, q_seg, p.scale_log2, p.cap_scale,
            p.cap_log2, m_i, l_i, alpha, b_off, b_step);
      }
      if constexpr (BIAS) release(bias_empty);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int i = 0; i < 64; ++i) o[hf][i] *= alpha[(i >> 1) & 1];
      }
      split3_frags<4>(pa, sc);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mbar_wait(&full[hf], 1);
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < 6; ++x) {
          const unsigned char* vb = slot(hf) + pair_b(x) * S::CP;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            wgmma_pv<128>(o[hf], pa[pair_a(x)][kk],
                          smem_desc(vb + kk * 16 * SW128_ROW, F32_BLOCK_N * SW128_ROW, 1024));
          }
        }
        wgmma_commit();
      }
      wgmma_wait<1>();  // V's first half has been read
      fence_regs(o[0]);
      release(&empty[0]);
      wgmma_wait<0>();
      fence_regs(o[1]);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[pc][kk]);
      }
      release(&empty[1]);
      ++v;
    }

    // Epilogue: O = acc / l, LSE = m ln2 + log l; rows past Nq and O's
    // columns >= D (zeros the boxes read) masked on store. RING: K7's merge
    // (ring_merge.cuh), O's halves as one accumulator of 256 columns.
    if constexpr (RING) {
      ring_merge_store<256>(p.ring, p.o, p.o_sb, p.o_sh, p.o_sn, p.lse, p.hq, p.nq, p.d,
                            *reinterpret_cast<const float(*)[128]>(&o[0][0]), m_i, l_i, b, h,
                            row0, t);
      return;
    }
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
        for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
          for (int jj = 0; jj < 16; ++jj) {
            const int col = 128 * hf + 8 * jj + 2 * t;
            if (col >= p.d) continue;  // K1 f32 d256 O columns
            *reinterpret_cast<float2*>(o_row + col) =
                make_float2(o[hf][4 * jj + 2 * r] * inv, o[hf][4 * jj + 2 * r + 1] * inv);
          }
        }
        if (t == 0) {
          p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + row] =
              dead ? LN2 * MASK_VALUE : m_i[r] * LN2 + logf(l_safe);
        }
      }
    }
  }
}

template <int D, bool SEG, bool CAP, bool BIAS, bool RING = false>
cudaError_t fwd_f32_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                           const CUtensorMap& tm_v, const FwdF32Params& p, cudaStream_t stream) {
  if constexpr (D == 256) {
    auto kernel = fwd_f32_wide_kernel<SEG, CAP, BIAS, RING>;
    constexpr int smem = F32WideFwdSmem<BIAS>::BYTES;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(p.hq, (p.nq + F32W_BLOCK_M - 1) / F32W_BLOCK_M, p.batch);
    kernel<<<grid, F32W_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p);
  } else {
    auto kernel = fwd_f32_kernel<D, SEG, CAP, BIAS, RING>;
    constexpr int smem = F32FwdSmem<D, BIAS>::BYTES;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(p.hq, p.q_tiles, p.batch);
    kernel<<<grid, F32_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p);
  }
  return cudaGetLastError();
}

template <int D, bool BIAS>
cudaError_t fwd_f32_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                             const CUtensorMap& tm_v, const FwdF32Params& p, bool seg, bool cap,
                             cudaStream_t stream) {
  if (seg) {
    return cap ? fwd_f32_launch<D, true, true, BIAS>(tm_q, tm_k, tm_v, p, stream)
               : fwd_f32_launch<D, true, false, BIAS>(tm_q, tm_k, tm_v, p, stream);
  }
  return cap ? fwd_f32_launch<D, false, true, BIAS>(tm_q, tm_k, tm_v, p, stream)
             : fwd_f32_launch<D, false, false, BIAS>(tm_q, tm_k, tm_v, p, stream);
}

}  // namespace

extern "C" {

// O and LSE of f32 attention: the arguments of K1's dense route (fa_fwd_sm90,
// flash_fwd_sm90.cu) in its order and with its meaning, then the bias, on f32 q [B, Hq, Nq,
// D] and k / v [B, Hkv, Nk, D] (unit stride on D, other strides in elements,
// any alignment), o [B, Hq, Nq, D] f32 (strides in elements, even), lse [B,
// Hq, Nq] f32 contiguous, and after lse `pieces`: bf16 scratch of 3 DB (B Hq
// Nq + 2 B Hkv kv_valid_len) elements, 16-byte aligned (DB = 64 for D <= 64,
// 128 for D <= 128, else 256). One launch of the split (split_bf16x3.cu) writes the three bf16
// pieces of q's rows and of k's and v's first kv_valid_len rows there, in
// that order, each [3, B, H, N, DB]; the attention kernel then reads them.
// Positions are absolute (q_off + row, kv_off + key) for causal and the
// window (wl, wr; a negative bound is none); dead rows give O = 0, LSE = ln2
// * mask; segment ids as four pointers or none, at 128-row Q tiles and 64-key
// KV tiles (fa_fwd_sm90's); softcap > 0 the cap (0: none); bias an f32
// [B|1, Hq|1, Nq|1, Nk] added to the (capped) scores, or null: unit column
// stride, (batch, head, row) strides in elements, 0 on broadcast dims, a
// 16-byte-aligned address and row stride (fa_fwd_bias_sm90's), its columns
// read only below kv_valid_len and its rows below Nq. Requires 8 <= D
// <= 256 with D % 8 == 0 (above 128 the D 256 form, 64 Q rows a CTA; the
// id ranges stay those of 128-row tiles), Hq % Hkv == 0, 1 <= Nq, 0 <=
// kv_valid_len, B <= 65535; o 8-byte aligned; seg_kv 16-byte aligned. Returns a cudaError_t (0
// on success; cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or refuses a
// tensor map).
int fa_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, void* pieces,
               const void* seg_q, const void* seg_kv, const void* q_range, const void* kv_range,
               int batch, int hq, int hkv, int nq, int d, int kv_valid_len, int causal, int wl,
               int wr, int q_off, int kv_off, float scale, float softcap, int64_t q_sb,
               int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
               int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh,
               int64_t o_sn, int64_t seg_q_sb, const void* bias, int64_t bias_sb,
               int64_t bias_sh, int64_t bias_sn, void* stream) {
  const bool seg = seg_q != nullptr;
  const bool has_bias = bias != nullptr;
  const int q_tiles = (nq + F32_BLOCK_M - 1) / F32_BLOCK_M;
  const int cta_rows = d > 128 ? F32W_BLOCK_M : F32_BLOCK_M;  // Q rows per CTA
  if (d < 8 || d > 256 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq > 65535 || hq % hkv != 0 || nq < 1 || (nq + cta_rows - 1) / cta_rows > 65535 ||
      kv_valid_len < 0 ||
      !(softcap >= 0.f) || !aligned(pieces, 16) || !aligned(o, 8) ||
      (o_sb | o_sh | o_sn) % 2 || seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) || (seg && !aligned(seg_kv, 16)) ||
      (has_bias && (!aligned(bias, 16) || (bias_sb | bias_sh | bias_sn) % 4 || bias_sb < 0 ||
                    bias_sh < 0 || bias_sn < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The pieces: q's [3, B, Hq, Nq, DB], then k's and v's [3, B, Hkv, kv_valid_len, DB].
  const int db = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* kp = qp + 3LL * db * batch * hq * nq;
  __nv_bfloat16* vp = kp + 3LL * db * batch * hkv * kv_valid_len;
  const fa::SplitArg split[3] = {{q, qp, batch, hq, nq, d, q_sb, q_sh, q_sn},
                                 {k, kp, batch, hkv, kv_valid_len, d, k_sb, k_sh, k_sn},
                                 {v, vp, batch, hkv, kv_valid_len, d, v_sb, v_sh, v_sn}};
  cudaError_t e = fa::split_bf16x3(split, kv_valid_len > 0 ? 3 : 1, db, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // The K/V maps' sequence extent (at least 1: a map has no empty dim; with
  // kv_valid_len 0 no KV tile is loaded, and the maps point at q's pieces).
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  if (kv_valid_len == 0) kp = vp = qp;
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  const int64_t q_row = db, q_head = q_row * nq, kv_row = db, kv_head = kv_row * nkv;
  if (!make_bhnd_map(&tm_q, qp, 3 * batch, hq, nq, d, q_head * hq, q_head, q_row, cta_rows) ||
      !make_bhnd_map(&tm_k, kp, 3 * batch, hkv, nkv, d, kv_head * hkv, kv_head, kv_row,
                     F32_BLOCK_N) ||
      !make_bhnd_map(&tm_v, vp, 3 * batch, hkv, nkv, d, kv_head * hkv, kv_head, kv_row,
                     F32_BLOCK_N)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::FwdF32Params p;
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.seg_q_sb = seg_q_sb;
  p.batch = batch;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.q_tiles = q_tiles;
  p.kv_tiles = (kv_valid_len + F32_BLOCK_N - 1) / F32_BLOCK_N;
  p.scale_log2 = scale * fa::LOG2E;
  const bool cap = softcap > 0.f;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * fa::LOG2E;
  p.bias = static_cast<const float*>(bias);
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
  if (has_bias) {
    e = d <= 64    ? fwd_f32_dispatch<64, true>(tm_q, tm_k, tm_v, p, seg, cap, s)
        : d <= 128 ? fwd_f32_dispatch<128, true>(tm_q, tm_k, tm_v, p, seg, cap, s)
                   : fwd_f32_dispatch<256, true>(tm_q, tm_k, tm_v, p, seg, cap, s);
  } else {
    e = d <= 64    ? fwd_f32_dispatch<64, false>(tm_q, tm_k, tm_v, p, seg, cap, s)
        : d <= 128 ? fwd_f32_dispatch<128, false>(tm_q, tm_k, tm_v, p, seg, cap, s)
                   : fwd_f32_dispatch<256, false>(tm_q, tm_k, tm_v, p, seg, cap, s);
  }
  return static_cast<int>(e);
}


// K7 on f32 inputs, one ring forward step of one rank (ring_fwd.cu's
// fa_ring_fwd_bf16, whose argument list this takes in its order, with the
// pieces after lse): f32 q [B, Hq, nq, D] (q * scale * log2 e), k / v [B,
// Hkv, nk, D] and o [B, Hq, nq, D] (unit stride on D, other strides in
// elements; o's even and 8-byte aligned), the f32 state and lse as there.
// The step runs this file's kernels with RING -- the band shifted by q_base -
// kv_off, scale_log2 = 1 (q arrives in the log2 domain), the epilogue
// ring_merge.cuh's -- on three bf16 pieces per operand: one launch of the
// split (split_bf16x3.cu) writes k's and v's pieces into kv_pieces (3 DB 2 B
// Hkv nk elements: k's [3, B, Hkv, nk, DB], then v's) and, with split_q != 0,
// q's into q_pieces (3 DB B Hq nq elements, [3, B, Hq, nq, DB]); without it
// q_pieces holds what an earlier step of the rank's ring wrote there (q does
// not rotate: the rank's first live step splits it). Both 16-byte aligned; DB
// = 64 for D <= 64, 128 for D <= 128, else 256. Requires 8 <= D <= 256 with D
// % 8 == 0, Hq % Hkv == 0, nq and nk multiples of 128, B <= 65535. Returns a
// cudaError_t (0: success; cudaErrorInvalidValue for arguments it does not
// take, cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or
// refuses a tensor map).
int fa_ring_fwd_f32(const void* q, const void* k, const void* v, void* acc, void* m, void* l,
                    void* o, void* lse, void* q_pieces, void* kv_pieces, int split_q, int batch,
                    int hq, int hkv, int nq, int nk, int d, int q_base, int kv_off, int causal,
                    int wl, int wr, int first, int last, int64_t q_sb, int64_t q_sh,
                    int64_t q_sn, int64_t kv_sb, int64_t kv_sh, int64_t kv_sn, int64_t o_sb,
                    int64_t o_sh, int64_t o_sn, void* stream) {
  if (batch < 1 || batch > 65535 || d < 8 || d > 256 || d % 8 || hkv < 1 || hq < 1 ||
      hq > 65535 || hq % hkv || nq < F32_BLOCK_M || nk < F32_BLOCK_M || nq % F32_BLOCK_M ||
      nk % F32_BLOCK_M || nq / F32W_BLOCK_M > 65535 || !aligned(q_pieces, 16) ||
      !aligned(kv_pieces, 16) || !aligned(o, 8) || (o_sb | o_sh | o_sn) % 2 ||
      (!(first && last) && (acc == nullptr || m == nullptr || l == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int db = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(q_pieces);
  __nv_bfloat16* kp = static_cast<__nv_bfloat16*>(kv_pieces);
  __nv_bfloat16* vp = kp + 3LL * db * batch * hkv * nk;
  const fa::SplitArg split[3] = {{k, kp, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn},
                                 {v, vp, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn},
                                 {q, qp, batch, hq, nq, d, q_sb, q_sh, q_sn}};
  cudaError_t e = fa::split_bf16x3(split, split_q ? 3 : 2, db, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cta_rows = d > 128 ? F32W_BLOCK_M : F32_BLOCK_M;  // Q rows per CTA
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  const int64_t q_head = static_cast<int64_t>(db) * nq, kv_head = static_cast<int64_t>(db) * nk;
  if (!make_bhnd_map(&tm_q, qp, 3 * batch, hq, nq, d, q_head * hq, q_head, db, cta_rows) ||
      !make_bhnd_map(&tm_k, kp, 3 * batch, hkv, nk, d, kv_head * hkv, kv_head, db, F32_BLOCK_N) ||
      !make_bhnd_map(&tm_v, vp, 3 * batch, hkv, nk, d, kv_head * hkv, kv_head, db,
                     F32_BLOCK_N)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::FwdF32Params p = {};
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.batch = batch;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = nk;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_base) - kv_off);
  p.q_tiles = nq / F32_BLOCK_M;
  p.kv_tiles = nk / F32_BLOCK_N;
  p.scale_log2 = 1.f;
  p.ring = {static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
            first != 0, last != 0};
  e = d <= 64    ? fwd_f32_launch<64, false, false, false, true>(tm_q, tm_k, tm_v, p, s)
      : d <= 128 ? fwd_f32_launch<128, false, false, false, true>(tm_q, tm_k, tm_v, p, s)
                 : fwd_f32_launch<256, false, false, false, true>(tm_q, tm_k, tm_v, p, s);
  return static_cast<int>(e);
}

}  // extern "C"
