// The f32 attention backward for Hopper (sm_90a): one body for K3 and for
// K5 + K6 on f32 inputs, with or without a bias, KV-major, one launch writing
// dQ, dK, dV and (on request) dbias to f32 accuracy as the TPU kernels
// compute their f32 calls at Precision.HIGHEST: on bf16 pieces. Kernels
// bwd_f32_kernel<D, SEG, CAP, BIAS> (D 64 and 128, every D <= 128 that is a
// multiple of 8 by the TMA boxes' zero fill, and the D 256 form, every D
// 136-256, a cluster of two CTAs that split D; segment ids, the logit
// softcap and the bias as compile-time flags, none being K3's call; dbias a
// runtime null pointer, so it adds no instantiation) and the C entry
// fa_bwd_f32.
//
// With RING the same kernel is K8's f32 forms, one ring backward step of one
// rank (C entry fa_ring_bwd_f32): it replaces
// flashattn_tpu/parallel/ring_kernel.py::_ring_bwd_kernel (K8, :389) on f32
// (Precision.HIGHEST, :451). At the f32 LM's attention a full off-diagonal
// 4096 x 4096 chunk pair is 344 GFLOP of f32 products: 2.1 ms at 165 TFLOP/s,
// operations. The body is unchanged but for two things: the CTA (or cluster,
// at D 256) is one per (KV head, 64 keys) and walks the Q tiles of each query
// head of the KV head's group in turn, so its dK / dV sum the group inside
// the CTA (one owner per accumulator tile, no race), and the epilogue adds
// them into the ring's rotating f32 dK / dV instead of storing them; q
// arrives pre-scaled (scale = scale_log2 = 1) and the band is shifted by
// q_base - kv_off. The C entry splits k and v on each live step and q and dO
// on the rank's first.
//
// Replaces, on f32 inputs, flashattn_tpu/ops/flash_bwd_fused.py::
// _bwd_fused_kernel (K3, :110) and _bwd_causal_resident_kernel (K4, :336),
// and flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5, :139) with _dq_kernel
// (K6, :234), with the bias (BIAS) as K5 + K6's bias route (bwd_bias_sm90.cu).
// With the forward's LSE (natural log; ln2 * mask on a dead row) and Delta =
// rowsum(dO * O) it computes what bwd_sm90_tile.cuh computes for K3, the
// split route and the bias route, for each (query row i, key j):
//   x = S scale log2 e, S = Q K^T (with the softcap, CAP: x = cap log2 e t,
//       t = tanh(S scale / cap), the accurate tanhf); BIAS: + bias log2 e,
//       in f32 (not split), floored at the mask value, as the forward adds it;
//   P = exp2(x - LSE log2 e) by exp2f, exactly 0 on keys at or past
//       kv_valid_len, on rows past Nq, outside the band (row i sees key j iff
//       i - lo <= j <= i + hi, shifted by q / kv offsets: common.cuh
//       band_bounds), on a pair whose segment ids differ (SEG) and on a dead
//       row (LSE log2 e <= mask / 2);
//   dL = P (dP - Delta), dP = dO V^T;  dS = dL scale (CAP: dL (1 - t^2) scale);
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,  dbias = dL (f32, before the
//       scale and the cap's Jacobian: the JAX kernel's, flash_bwd.py:300-302;
//       written only when the caller passes dbias),
// with dK / dV per query head (the caller sums each KV head's group) and dQ
// added into a zeroed f32 dQ. Every one of the five products is the six bf16
// products a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0 of three-piece
// operands (split_bf16x3.cu: Q, K, V and dO; P^T and dS^T are split in
// registers), summed in f32. The C entry splits Q, K, V and dO in one
// launch before the kernel, into scratch the caller gives.
//
// What bounds it: operations. At f32 path A's attention (B4 H16 N2048 D128,
// no band) the five f32 products are 344 GFLOP, six bf16 products each:
// 2.08 ms at 989 / 6 = 165 TFLOP/s, against 0.19 GB of inputs and outputs
// with a [B, 1, N, N] bias (0.06 ms at 3.35 TB/s; 2.3 GB, 0.69 ms, with a
// [B, H, N, N] bias and its dbias). The design:
//
//   * One CTA owns 64 keys of one (batch, query head) and walks the Q tiles
//     of 32 rows that the band leaves (SEG: whose id range meets the KV
//     tile's, from the wrapper's tile ranges). Warpgroup 0 is the producer
//     (one thread issues every copy; setmaxnreg leaves it 24 registers),
//     warpgroups 1 and 2 are two consumers (240 registers each) that take
//     the visits in turn: consumer c the visits c, c + 2, ..., each with its
//     own (Q, dO) stage, dQ stage and f32 dK / dV for the CTA's 64 keys
//     (2 x D / 2 registers a thread). While one consumer's products run, the
//     other forms P^T with exp2f, splits P^T and dS^T and stores dbias, dS
//     and dQ, so the tensor cores are fed from two instruction streams. The
//     two partial dK / dV are added once through shared memory at the end,
//     each consumer writing out one of the two. Each (query row, key) pair
//     belongs to one CTA, so dbias [B, Hq, Nq, Nk] takes plain stores; the
//     pairs of the Q tiles a CTA skips (the band, the ids) and the keys of
//     the CTAs past kv_valid_len are never written: the wrapper zero-fills
//     dbias for such calls.
//   * Shared memory at D 128: K's and V's pieces for 64 keys, 2 x 3 x 16 KB =
//     96 KB, once by TMA (rows past kv_valid_len read zeros, so a key the
//     forward never read cannot put a NaN into dQ); per consumer a (Q, dO)
//     stage of the three pieces with LSE, Delta and (SEG) ids, 48 KB, and a
//     16 KB region that holds the tile's dS pieces and then its f32 dQ:
//     96 + 2 x 64 = 224 KB of the 227. The stage is released as soon as dK
//     has retired, before dQ^T, so the producer loads the consumer's next
//     tile under its dQ^T and the other consumer's products (released at
//     the visit's end instead, the kernel takes 4-11% longer at D 128:
//     chip_variants.py f32bias). A third stage has no room.
//   * A Q / dO stage holds the three pieces stacked, rows 32p..32p+31 of a
//     96-row tile. S^T = K Q^T and dP^T = V dO^T are each six chains of
//     wgmma m64n32k16 from shared memory into one accumulator, issued
//     together; P^T is formed while dP^T runs. The chains are unrolled
//     (chain_ss6), every base descriptor formed before the fence and each
//     wgmma's own two inside its asm statement, so that ptxas issues them
//     back to back (no C75xx note: chip_smoke.py phase_build) with two
//     64-bit registers of descriptors live. As loops ptxas serializes them
//     (C7520) and the kernel takes 1.4-1.9x as long; unrolled with the
//     descriptors formed in C++ (which the compiler keeps in registers) it
//     takes as long at D 128 and 8-19% longer at D 256 (chip_variants.py
//     f32bias's "chain loops" and "descriptors in C++").
//   * BIAS: each consumer thread reads its 16 values of the tile from global
//     memory (L2) straight into S^T's fragment layout -- query row m + 8jj +
//     2t + e, key 16w + g + 8r: each load instruction covers 8 keys of 4
//     rows, four whole 32-byte sectors -- issued right after S^T and dP^T,
//     so that they land while the products run. dbias is stored from the
//     same layout, P^T (dP^T - Delta) taken once dP^T has retired
//     (streaming stores, whole sectors).
//   * P^T and dS^T are split into three bf16 A fragments each (the
//     accumulator layout is the A layout); dV += P^T dO and dK += dS^T Q are
//     six chains of wgmma m64nDk16 with A from registers and the stacked
//     pieces as the N-major B. dS's pieces go to the consumer's dS / dQ
//     region as [96 rows (piece, query)][64 keys], and dQ^T = K^T dS^T is
//     computed per 64 of D's columns as S^T is, K's box the M-major A and
//     dS's pieces the K-major B (a 32-row dQ tile is below wgmma's 64 rows;
//     its transpose is not), all boxes' chains issued before one wait; it is
//     staged over dS as f32 [32][d] (exactly d columns) and added to dQ
//     by ONE cp.reduce.async.bulk per tile, for the tile's rows below Nq only
//     (dQ is [B, Hq, Nq, d] contiguous: a full tile on the last, partial Q
//     tile, or a row of D > d columns, would add into the next rows). dQ's
//     sums therefore vary in their last bits from run to run.
//   * D 256 (every D 136-256): the D 128 layout does not double (K's and V's
//     pieces alone would be 192 KB), so a cluster of two CTAs owns each (query
//     head, 64 keys), rank r the D 128 body on D's columns [128 r, 128 r +
//     128): its K / V / Q / dO pieces, dK / dV and dQ there, with the same
//     two consumers and two stages (the next tile's loads overlap this one's
//     work). S^T and dP^T reduce over all of D, so consumer c of each CTA
//     sends its partial S^T and dP^T (32 floats a thread, 16 KB) into its
//     peer consumer's dS / dQ region (st.shared::cluster, an arrival on the
//     peer's mbarrier at cluster scope) and adds the peer's: both then hold
//     the same S^T and dP^T and form the same P^T and dS^T. The region is
//     the exchange buffer first, then dS, then the dQ stage: a consumer
//     writes into its peer's only once the peer's last bulk reduction has
//     read it (the peer's arrival on x_free), so the layout is D 128's,
//     224 KB. While one consumer waits on its peer, the other's products
//     run. Without the softcap rank 0 alone reads the bias and adds bias /
//     scale to its partial S^T before the exchange (both ranks then form
//     the same sum, as IEEE addition commutes); the cap's tanh lies between
//     S and the bias, so with it both ranks read the bias. The walk (the
//     band, the ids, the KV tail) derives from the head, the KV tile and
//     the batch, never the rank, so both visit the same Q tiles. dQ's half
//     rows are not contiguous, so each is added by a bulk reduction of its
//     own (warp 0's lanes, the tile's rows below Nq); dbias by rank 0
//     alone. At D 136 rank 1 holds 8 real columns and the boxes' zeros.

#include "sm90.cuh"
#include "split_bf16x3.cuh"

namespace fa {

struct BwdF32Params {
  const float* lse;      // [B, Hq, nq_pad] f32, natural log (ln2 * mask: a dead row)
  const float* delta;    // [B, Hq, nq_pad] f32
  float* dq;             // [B, Hq, Nq, d] f32 contiguous, zeroed, added to
  float* dk;             // [B, Hq, Nk, d] f32 contiguous, written
  float* dv;
  const int* seg_q;      // [B, q_tiles * 32] ids, contiguous, rows padded to whole tiles
  const int* seg_kv;     // [B, kv_tiles * 64] ids, contiguous, rows padded to whole tiles
  const int2* q_range;   // [B, q_tiles] (min, max) id of each 32-row Q tile's rows below Nq
  const int2* kv_range;  // [B, kv_tiles] (min, max) id of each 64-key tile's keys
  int batch, hq, rep, nq, nq_pad, nk, kv_valid_len, d;
  int lo, hi;              // band: row - lo <= key <= row + hi (NO_BOUND: none)
  int q_tiles, kv_tiles;   // ceil(Nq / 32), ceil(kv_valid_len / 64)
  float scale, scale_log2;
  float cap_scale, cap_log2;  // CAP: scale / cap, cap * log2(e)
  const float* bias;     // BIAS: f32 [B|1, Hq|1, Nq|1, Nk], unit column stride
  float* dbias;          // BIAS: [B, Hq, Nq, Nk] f32 contiguous, or null (no dbias)
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
};

}  // namespace fa

namespace {

using namespace fa;

constexpr int F32B_BLOCK_N = 64;   // keys per CTA
constexpr int F32B_BLOCK_M = 32;   // query rows per Q tile
constexpr int F32B_STACK = 3 * F32B_BLOCK_M;  // rows of a stacked tile: three pieces
constexpr int F32B_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float F32B_NEG_GUARD = 0.5f * MASK_VALUE;

// Shared-memory layout (bytes, from a 1024-byte-aligned base): K's three
// pieces, V's three pieces (each DH / 64 boxes of 64 rows; DH the columns a
// CTA holds: D, or at D 256 its half), then per consumer c a slot: its (Q,
// dO) stage as stacked tiles (DH / 64 boxes of 96 rows each, piece p at rows
// 32p..) and its region R (dS's stacked tile [96][64] bf16, then the f32 dQ
// stage [32][DH]; at D 256 first the peer's partial S^T and dP^T, [8][128]
// float4: chunk k of thread i at k 128 + i); then the ids (the KV tile's
// [64], each stage's Q tile's [2][32]), LSE and Delta [2][32] each, then the
// mbarriers kv_full, full[2], empty[2] and at D 256 x_full[2], x_free[2].
template <int D>
struct F32BwdSmem {
  static constexpr bool WIDE = D == 256;
  static constexpr int DH = WIDE ? 128 : D;
  static constexpr int KVP = F32B_BLOCK_N * DH * 2;  // one piece of K or V
  static constexpr int OFF_V = 3 * KVP;
  static constexpr int QT = F32B_STACK * DH * 2;     // a stacked Q or dO tile
  static constexpr int STAGE = 2 * QT;
  static constexpr int DS = F32B_STACK * F32B_BLOCK_N * 2;
  static constexpr int DQ = F32B_BLOCK_M * DH * 4;
  static constexpr int R = DS > DQ ? DS : DQ;        // a consumer's dS / dQ region
  static constexpr int SLOT = STAGE + R;
  static constexpr int OFF_SLOT = 6 * KVP;
  static constexpr int OFF_SEG = OFF_SLOT + 2 * SLOT;
  static constexpr int OFF_STATS = OFF_SEG + (F32B_BLOCK_N + 2 * F32B_BLOCK_M) * 4;
  static constexpr int BARS = OFF_STATS + 2 * 2 * F32B_BLOCK_M * 4;
  static constexpr int BYTES = 1024 + BARS + (5 + (WIDE ? 4 : 0)) * 8;
  static_assert(KVP % 1024 == 0 && QT % 1024 == 0 && R % 1024 == 0 && SLOT % 1024 == 0,
                "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(!WIDE || R == 128 * 32 * 4, "D 256: the region holds the peer's partials");
  static_assert(STAGE >= F32B_BLOCK_N * DH * 4, "a stage holds one consumer's dK or dV");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// One wgmma m64n32k16 from shared memory, D (64 x 32, f32) = A (64 x 16) B
// (16 x 32), B K-major, A K-major (TA 0) or M-major (TA 1), added to D
// unless ACC is 0: its descriptors a0 + AO and b0 + BO (AO, BO in 16-byte
// units, into the start address) are formed inside this asm statement, so
// that no chain holds more than its two base descriptors in registers.
template <int TA, int AO, int BO, int ACC>
__device__ __forceinline__ void wgmma_n32_at(float (&d)[16], uint64_t a0, uint64_t b0) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "add.s64 da, %16, %19;\n"
      "add.s64 db, %17, %20;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " da, db, p, 1, 1, %21, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a0), "l"(b0), "r"(ACC), "n"(AO), "n"(BO), "n"(TA));
}

// Product I.. of a chain: acc = the six bf16 products of A's pieces (A_PIECE
// bytes apart) and B's (a stacked K-major tile, piece p at rows 32p..), the
// small terms first, over KS k-steps of 16 along the reduction; k-step kk is
// (kk / 4) A_BOX + (kk % 4) A_COL bytes into A and (kk / 4) B_BOX + (kk % 4)
// 32 into B. Unrolled by recursion: every offset is a constant.
template <int TA, int KS, int A_PIECE, int A_BOX, int A_COL, int B_BOX, int I = 0>
__device__ __forceinline__ void chain_ss6(float (&acc)[16], uint64_t a0, uint64_t b0) {
  constexpr int x = I / KS, kk = I % KS;
  constexpr int ao = pair_a(x) * A_PIECE + (kk / 4) * A_BOX + (kk % 4) * A_COL;
  constexpr int bo = pair_b(x) * F32B_BLOCK_M * SW128_ROW + (kk / 4) * B_BOX + (kk % 4) * 32;
  wgmma_n32_at<TA, (ao >> 4), (bo >> 4), (I > 0)>(acc, a0, b0);
  if constexpr (I + 1 < 6 * KS) chain_ss6<TA, KS, A_PIECE, A_BOX, A_COL, B_BOX, I + 1>(acc, a0, b0);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// acc += the six bf16 products of a's pieces (A fragments of 2 k-steps, 32
// query rows) and a stacked N-major B tile (b_s: rows 32p.. piece p, boxes
// of 96 rows), the small terms first.
template <int D>
__device__ __forceinline__ void issue_rs6(float (&acc)[D / 2], const uint32_t (&a)[3][2][4],
                                          const unsigned char* b_s) {
  const uint64_t b0 = opaque(smem_desc(b_s, F32B_STACK * SW128_ROW, 1024));
  wgmma_fence();
#pragma unroll
  for (int x = 0; x < 6; ++x) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wgmma_pv<D>(acc, a[pair_a(x)][kk],
                  b0 + (((F32B_BLOCK_M * pair_b(x) + 16 * kk) * SW128_ROW) >> 4));
    }
  }
  wgmma_commit();
}

// One consumer's dK and dV of this thread's keys (kv0, kv0 + 8): written per
// query head, every key below Nk (zeros for keys no row reached); RING: per
// KV head, added to the ring's rotating f32 accumulators (read, summed,
// written back: the CTA is their one owner).
template <int DH, bool RING>
__device__ __forceinline__ void store_dkv(float* out, const float (&acc)[DH / 2],
                                          const BwdF32Params& p, int64_t dkv_head, int kv0,
                                          int c_off, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kv0 + 8 * r;
    if (key >= p.nk) continue;
    float* row = out + (dkv_head * p.nk + key) * p.d + c_off + 2 * t;
#pragma unroll
    for (int jj = 0; jj < DH / 8; ++jj) {
      if (c_off + 8 * jj + 2 * t >= p.d) continue;
      float2 v2 = make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
      if constexpr (RING) {
        const float2 v0 = *reinterpret_cast<const float2*>(row + 8 * jj);
        v2 = make_float2(v0.x + v2.x, v0.y + v2.y);
      }
      *reinterpret_cast<float2*>(row + 8 * jj) = v2;
    }
  }
}

template <int D, bool SEG, bool CAP, bool BIAS, bool RING>
__global__ void __launch_bounds__(F32B_THREADS, 1)
    bwd_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const BwdF32Params p) {
  static_assert(D == 64 || D == 128 || D == 256, "instantiated for D 64, 128 and 256");
  static_assert(!(RING && (SEG || CAP || BIAS)), "K8 takes no ids, cap or bias");
  using S = F32BwdSmem<D>;
  constexpr bool WIDE = S::WIDE;
  constexpr int DH = S::DH;
  constexpr int BOXES = DH / 64;
  // D 256 without the cap: rank 0 folds the bias into its partial S^T.
  constexpr bool FOLD = WIDE && BIAS && !CAP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;   // [2]
  uint64_t* empty = full + 2;     // [2]
  uint64_t* x_full = empty + 2;   // WIDE: [2], the peer's partials have landed
  uint64_t* x_free = x_full + 2;  // WIDE: [2], the peer's region may be written
  int* seg_kv_s = reinterpret_cast<int*>(smem + S::OFF_SEG);
  int* seg_q_s = seg_kv_s + F32B_BLOCK_N;                            // [2][32]
  float* s_stats = reinterpret_cast<float*>(smem + S::OFF_STATS);   // lse[2][32], delta[2][32]
  auto stage = [&](int s) { return smem + S::OFF_SLOT + s * S::SLOT; };

  // WIDE: a cluster of two CTAs per (query head, KV tile), rank r holding D's
  // columns [128 r, 128 r + 128); both walk the same Q tiles (everything
  // below derives from h, the KV tile and b, never from the rank).
  const int rank = WIDE ? static_cast<int>(cluster_ctarank()) : 0;
  const int c_off = rank * DH;  // the CTA's first column
  // RING (K8): the grid's head is a KV head, and the CTA walks the Q tiles
  // of each query head of its group in turn (visit w: head h0 + w / n_m, Q
  // tile w % n_m), so its dK / dV sum the group and have one owner.
  const int head = WIDE ? blockIdx.x >> 1 : blockIdx.x;
  const int hk = RING ? head : head / p.rep;
  const int h0 = RING ? head * p.rep : head;  // the first query head walked
  const int heads = RING ? p.rep : 1;         // K8 GQA heads
  // A left bound alone: the late KV tiles meet the most Q tiles; run them
  // first (causal's first tiles are its longest already).
  const int n_tile =
      p.lo < NO_BOUND && p.hi >= NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int n0 = n_tile * F32B_BLOCK_N;
  const int b = blockIdx.z;
  // Rows [n0 - hi, n0 + 63 + lo] meet the tile's keys; none when the tile
  // lies past kv_valid_len (its dK / dV rows are then zeros).
  const int m_begin = p.hi < NO_BOUND ? max(0, n0 - p.hi) / F32B_BLOCK_M * F32B_BLOCK_M : 0;
  const int m_end = p.lo < NO_BOUND ? min(p.nq, n0 + F32B_BLOCK_N + p.lo) : p.nq;
  const int n_m = n0 < p.kv_valid_len && m_end > m_begin
                      ? (m_end - m_begin + F32B_BLOCK_M - 1) / F32B_BLOCK_M
                      : 0;
  const int t0 = m_begin / F32B_BLOCK_M;
  int2 k_rng = make_int2(0, 0);
  if constexpr (SEG) {
    if (n_m > 0) k_rng = p.kv_range[b * p.kv_tiles + n_tile];
  }
  // The first visited Q tile at or after i (SEG: whose id range meets the KV
  // tile's); producer and consumers walk the same tiles, visit `it` (0, 1,
  // ...) going to consumer it % 2 through stage it % 2.
  auto next_visit = [&](int i) {
    if constexpr (SEG) {
      while (i < n_m && !ranges_meet(p.q_range[b * p.q_tiles + t0 + i], k_rng)) ++i;
    }
    return i;
  };
  const int first = next_visit(0);
  const int n_w = heads * n_m;  // visits: the Q tiles of each head walked
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 4);  // one arrival per warp of the stage's consumer
    }
    if constexpr (WIDE) {
      for (int s = 0; s < 2; ++s) {
        mbar_init(&x_full[s], 128);  // each thread of the peer's consumer s
        mbar_init(&x_free[s], 1);    // the peer's consumer s, once its region is read
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (WIDE) cluster_sync();  // the peer's barriers exist before any remote arrival

  if (wg == 0) {
    // Producer: thread 0 issues the copies.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && first < n_m) {
      mbar_expect_tx(kv_full, 6 * S::KVP + (SEG ? F32B_BLOCK_N * 4 : 0));
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(smem + pc * S::KVP + x * F32B_BLOCK_N * SW128_ROW, &tm_k, kv_full,
                      c_off + 64 * x, n0, hk, pc * p.batch + b);
          tma_load_4d(smem + S::OFF_V + pc * S::KVP + x * F32B_BLOCK_N * SW128_ROW, &tm_v,
                      kv_full, c_off + 64 * x, n0, hk, pc * p.batch + b);
        }
      }
      if constexpr (SEG) {
        bulk_load(seg_kv_s, p.seg_kv + static_cast<int64_t>(b) * p.kv_tiles * F32B_BLOCK_N + n0,
                  F32B_BLOCK_N * 4, kv_full);
      }
      int it = 0;
      for (int w = first; w < n_w; w = next_visit(w + 1), ++it) {
        const int s = it & 1;
        const int m = m_begin + (RING ? w % n_m : w) * F32B_BLOCK_M;
        const int h = RING ? h0 + w / n_m : h0;
        unsigned char* st = stage(s);
        mbar_wait(&empty[s], ((it >> 1) & 1) ^ 1);  // each stage's round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::QT + 2 * F32B_BLOCK_M * 4 + (SEG ? F32B_BLOCK_M * 4 : 0));
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
          for (int x = 0; x < BOXES; ++x) {
            const int off = (x * F32B_STACK + pc * F32B_BLOCK_M) * SW128_ROW;
            tma_load_4d(st + off, &tm_q, &full[s], c_off + 64 * x, m, h, pc * p.batch + b);
            tma_load_4d(st + S::QT + off, &tm_do, &full[s], c_off + 64 * x, m, h,
                        pc * p.batch + b);
          }
        }
        const int64_t row = (static_cast<int64_t>(b) * p.hq + h) * p.nq_pad + m;
        bulk_load(s_stats + s * F32B_BLOCK_M, p.lse + row, F32B_BLOCK_M * 4, &full[s]);
        bulk_load(s_stats + (2 + s) * F32B_BLOCK_M, p.delta + row, F32B_BLOCK_M * 4, &full[s]);
        if constexpr (SEG) {
          bulk_load(seg_q_s + s * F32B_BLOCK_M,
                    p.seg_q + static_cast<int64_t>(b) * p.q_tiles * F32B_BLOCK_M + m,
                    F32B_BLOCK_M * 4, &full[s]);
        }
      }
    }
  } else {
    // Consumer c: warpgroup 1 + c, the tile's 64 keys, visits c, c + 2, ...
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = wg - 1;
    const int bar = 1 + c;  // this consumer's named barrier (128 threads)
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int kv0 = n0 + warp * 16 + g;  // this thread's keys kv0 and kv0 + 8
    const unsigned char* k_s = smem;
    const unsigned char* v_s = smem + S::OFF_V;
    unsigned char* q_st = stage(c);
    const unsigned char* do_st = q_st + S::QT;
    unsigned char* r_s = q_st + S::STAGE;  // WIDE: the peer's partials, then dS, then dQ
    float* dq_stage = reinterpret_cast<float*>(r_s);
    // Issue the dQ reductions: thread 0 the tile's, or at D 256 the 32 lanes
    // of warp 0 one row each (a CTA's columns are not contiguous across rows).
    const bool issuer = WIDE ? tid < 32 : tid == 0;
    const int d = p.d;  // the columns of dQ / dK / dV, d <= D (the boxes read zeros past it)
    const int dcols = WIDE ? min(DH, d - c_off) : d;  // this CTA's columns of dQ
    // The rank that reads the bias (FOLD: rank 0 alone).
    const bool bias_reader = !FOLD || rank == 0;

    float dk[DH / 2], dv[DH / 2];
    zero(dk);
    zero(dv);
    int kv_seg[2] = {0, 0};  // SEG: the ids of this thread's keys
    if (first < n_m) {
      mbar_wait(kv_full, 0);
      if constexpr (SEG) {
        kv_seg[0] = seg_kv_s[kv0 - n0];
        kv_seg[1] = seg_kv_s[kv0 - n0 + 8];
      }
    }
    int it = 0;
    for (int w = first; w < n_w; w = next_visit(w + 1), ++it) {
      if ((it & 1) != c) continue;  // the other consumer's visit
      const int j = it >> 1;        // this consumer's visit count
      const int m = m_begin + (RING ? w % n_m : w) * F32B_BLOCK_M;  // the tile's first row
      const int h = RING ? h0 + w / n_m : h0;
      mbar_wait(&full[c], j & 1);
      // This thread's coordinates, opaque to the compiler: the ~60 addresses
      // derived from them (LSE / Delta, the dS and dQ stage stores) are
      // recomputed each tile instead of being held in registers across the
      // loop, which spilled.
      const int tw = opaque(warp), tg = opaque(g), tt = opaque(t);
      const int kvt = n0 + tw * 16 + tg;  // this thread's keys kvt and kvt + 8

      // Edge tiles: those that the tails, the band or (SEG) a document edge cut.
      bool edge = m + F32B_BLOCK_M > p.nq || n0 + F32B_BLOCK_N > p.kv_valid_len ||
                  n0 + F32B_BLOCK_N - 1 - m > p.hi || m + F32B_BLOCK_M - 1 - n0 > p.lo;
      if constexpr (SEG) {
        const int2 q_rng = p.q_range[b * p.q_tiles + m / F32B_BLOCK_M];
        edge = edge || !(q_rng.x == q_rng.y && k_rng.x == k_rng.y && q_rng.x == k_rng.x);
      }

      // S^T = K Q^T and dP^T = V dO^T: rows are the tile's keys, columns its
      // 32 query rows; dP^T runs while P^T is formed.
      float sc[16], dp[16];
      {
        // Every descriptor a chain reads is formed before the fence.
        const uint64_t kd = opaque(smem_desc(k_s, 16, 1024));
        const uint64_t vd = opaque(smem_desc(v_s, 16, 1024));
        const uint64_t qd = opaque(smem_desc(q_st, 16, 1024));
        const uint64_t dd = opaque(smem_desc(do_st, 16, 1024));
        wgmma_fence();
        chain_ss6<0, DH / 16, S::KVP, F32B_BLOCK_N * SW128_ROW, 32, F32B_STACK * SW128_ROW>(
            sc, kd, qd);
        wgmma_commit();
        chain_ss6<0, DH / 16, S::KVP, F32B_BLOCK_N * SW128_ROW, 32, F32B_STACK * SW128_ROW>(
            dp, vd, dd);
        wgmma_commit();
      }
      // BIAS: bv[4jj + 2r + e] the bias of query row m + 8jj + 2t + e, key kvt
      // + 8r (S^T's layout), loaded while the products run; an edge tile
      // reads only rows below Nq and keys below kv_valid_len.
      float bv[BIAS ? 16 : 1];
      if constexpr (BIAS) {  // bwd f32 bias prefetch
        if (bias_reader) {
          const float* brow = p.bias + b * p.bias_sb + h * p.bias_sh +
                              static_cast<int64_t>(m + 2 * tt) * p.bias_sn + kvt;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int row = m + 8 * jj + 2 * tt + e;
                const bool in = !edge || (row < p.nq && kvt + 8 * r < p.kv_valid_len);
                bv[4 * jj + 2 * r + e] =
                    in ? __ldg(brow + (8 * jj + e) * p.bias_sn + 8 * r) : 0.f;
              }
            }
          }
        }
      }
      if constexpr (WIDE) {
        // The peer's region is free once its last bulk reduction has read
        // it: tell the peer that ours is (the reduction of our visit j - 1).
        if (j > 0 && issuer) {
          bulk_wait_read();
          __syncwarp();
          if (tid == 0) mbar_arrive_cluster(cluster_addr(smem_u32(&x_free[c]), rank ^ 1));
        }
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if constexpr (FOLD) {
          if (rank == 0) {
#pragma unroll
            // bias / scale may overflow to -inf on the mask value: floored at
            // the mask value in P^T, P stays exactly 0 there.
            for (int i = 0; i < 16; ++i) sc[i] += bv[i] * (1.f / p.scale);  // bwd f32 d256 bias fold
          }
        }
        // The partial S^T and dP^T over this CTA's 128 columns to the peer
        // consumer, and the peer's added to them (mine + peer's: the same
        // sums, bit for bit, in both CTAs, as IEEE addition commutes),
        // through distributed shared memory: thread tid writes its 32
        // floats into the peer's region at chunk k 128 + tid, then arrives
        // there on x_full[c].
        mbar_wait_cluster(&x_free[c], (j & 1) ^ 1);  // round 0 passes at once
        const uint32_t mine = smem_u32(r_s) + 16 * tid;
        const uint32_t peer = cluster_addr(mine, rank ^ 1);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          st_cluster_f4(peer + k4 * 128 * 16, sc[4 * k4], sc[4 * k4 + 1], sc[4 * k4 + 2],
                        sc[4 * k4 + 3]);
          st_cluster_f4(peer + (4 + k4) * 128 * 16, dp[4 * k4], dp[4 * k4 + 1], dp[4 * k4 + 2],
                        dp[4 * k4 + 3]);
        }
        mbar_arrive_cluster(cluster_addr(smem_u32(&x_full[c]), rank ^ 1));
        mbar_wait_cluster(&x_full[c], j & 1);
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const float4 xs = *reinterpret_cast<const float4*>(r_s + 16 * (k4 * 128 + tid));
          const float4 xd = *reinterpret_cast<const float4*>(r_s + 16 * ((4 + k4) * 128 + tid));
          sc[4 * k4] += xs.x;  // bwd f32 d256 peer S^T
          sc[4 * k4 + 1] += xs.y;
          sc[4 * k4 + 2] += xs.z;
          sc[4 * k4 + 3] += xs.w;
          dp[4 * k4] += xd.x;
          dp[4 * k4 + 1] += xd.y;
          dp[4 * k4 + 2] += xd.z;
          dp[4 * k4 + 3] += xd.w;
        }
      } else {
        wgmma_wait<1>();
        fence_regs(sc);
      }

      // P^T: sc[4jj + 2r + e] is key kvt + 8r, query row m + 8jj + 2t + e; a
      // dead row's LSE becomes +inf (P = 0 exactly).
      const uint32_t lse_addr = smem_u32(s_stats + c * F32B_BLOCK_M + 2 * tt);
      const uint32_t dlt_addr = smem_u32(s_stats + (2 + c) * F32B_BLOCK_M + 2 * tt);
      const int* q_ids = seg_q_s + c * F32B_BLOCK_M + 2 * tt;  // SEG: this thread's query ids
      float pj[16];  // P^T (CAP: P^T (1 - tt^2)), all dS^T needs
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 lv = lds_f2(lse_addr + 32 * jj);
        float l2[2] = {lv.x * LOG2E, lv.y * LOG2E};
        int2 qi = make_int2(0, 0);
        if (SEG && edge) qi = *reinterpret_cast<const int2*>(q_ids + 8 * jj);
#pragma unroll
        for (int e = 0; e < 2; ++e) l2[e] = l2[e] <= F32B_NEG_GUARD ? INFINITY : l2[e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * r + e;
            float x, jac = 1.f;
            if constexpr (CAP) {
              // The forward's accurate tanhf (flash_fwd_f32.cu), not tanh.approx.
              const float tc = tanhf(sc[i] * p.cap_scale);
              x = p.cap_log2 * tc;
              jac = 1.f - tc * tc;  // bwd f32 softcap jacobian
            } else {
              x = sc[i] * p.scale_log2;
            }
            if constexpr (FOLD) {
              x = fmaxf(x, MASK_VALUE);  // the bias is in S^T already
            } else if constexpr (BIAS) {
              x = fmaxf(x + bv[i] * LOG2E, MASK_VALUE);
            }
            float pe = exp2f(x - l2[e]);
            if (edge) {
              const int key = kvt + 8 * r;
              const int row = m + 8 * jj + 2 * tt + e;
              if (row >= p.nq || key >= p.kv_valid_len || key - row > p.hi ||
                  row - key > p.lo) {  // bwd f32 band mask
                pe = 0.f;
              }
              if (SEG && (e ? qi.y : qi.x) != kv_seg[r]) pe = 0.f;
            }
            sc[i] = pe;
            pj[i] = pe * jac;
          }
        }
      }
      if constexpr (!WIDE) {
        wgmma_wait<0>();
        fence_regs(dp);
      }
      if constexpr (BIAS) {
        if (p.dbias != nullptr && (!WIDE || rank == 0)) {  // bwd f32 dbias rank
          // dbias = dL^T = P^T (dP^T - Delta), before the scale and the cap's
          // Jacobian (pj holds P^T (1 - t^2)): 8 lanes store 8 keys of a row.
          float* db = p.dbias +
                      ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m + 2 * tt) * p.nk + kvt;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * jj + 2 * r + e;
                if (m + 8 * jj + 2 * tt + e < p.nq && kvt + 8 * r < p.nk) {
                  __stcs(db + static_cast<int64_t>(8 * jj + e) * p.nk + 8 * r,
                         sc[i] * (dp[i] - (e ? dl.y : dl.x)));  // bwd f32 dbias
                }
              }
            }
          }
        }
      }

      // dV += P^T dO, its six products with A from registers; dS^T = P^T
      // (dP^T - Delta) scale (CAP: P^T (1 - tt^2)) meanwhile. P^T's and dS^T's
      // pieces are not live together: 48 registers would pass the budget.
      {
        uint32_t pa[3][2][4];
        split3_frags<2>(pa, sc);
        issue_rs6<DH>(dv, pa, do_st);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 dl = lds_f2(dlt_addr + 32 * jj);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * jj + 2 * r;
            dp[i] = pj[i] * (dp[i] - dl.x) * p.scale;
            dp[i + 1] = pj[i + 1] * (dp[i + 1] - dl.y) * p.scale;
          }
        }
        wgmma_wait<0>();  // dV has retired
        fence_regs(dv);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) fence_regs(pa[pc][kk]);
        }
      }
      // dK += dS^T Q; then the stage (Q, dO, LSE, Delta, ids) is free for the
      // consumer's next tile while dQ^T runs.
      uint32_t da[3][2][4];
      split3_frags<2>(da, dp);
      issue_rs6<DH>(dk, da, q_st);
      wgmma_wait<0>();  // dK has retired
      fence_regs(dk);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) fence_regs(da[pc][kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[c]);  // bwd f32 stage release
      // The region: every thread has read the peer's partials (WIDE), the
      // last tile's reduction has read the dQ stage (issuer's wait).
      if (!WIDE && issuer) bulk_wait_read();
      named_sync(bar, 128);
      // dS's pieces into the stacked [96][64] tile (rows 32p + query, keys
      // along the 128-byte rows, the swizzle's chunk order: 16-byte chunk c
      // of row R at c ^ (R % 8)): da[p][kk][i] holds key kvt + 8 (i & 1),
      // queries 16kk + 8 (i >> 1) + 2t and + 1.
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = tw * 16 + tg + 8 * (i & 1);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = F32B_BLOCK_M * pc + 16 * kk + 8 * (i >> 1) + 2 * tt + e;
              *reinterpret_cast<uint16_t*>(r_s + row * SW128_ROW +
                                           (((key >> 3) ^ (row & 7)) << 4) + (key & 7) * 2) =
                  static_cast<uint16_t>(da[pc][kk][i] >> (16 * e));
            }
          }
        }
      }
      fence_proxy_async();
      named_sync(bar, 128);  // dS written by every warp

      // dQ^T = K^T dS^T, 64 of the CTA's columns a box, every box's chain
      // issued before one wait: dq[x][4jj + 2r + e] is column c_off + 64x +
      // 16 tw + tg + 8r, query row 8jj + 2t + e, staged over dS into the
      // row-major [32][dcols] tile (dQ's own layout; at D 256 the CTA's half
      // of each row).
      float dq[BOXES][16];
      {
        const uint64_t sd = opaque(smem_desc(r_s, 16, 1024));
        uint64_t kb[BOXES];
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          kb[x] = opaque(smem_desc(k_s + x * F32B_BLOCK_N * SW128_ROW, F32B_BLOCK_N * SW128_ROW,
                                   1024));
        }
        wgmma_fence();
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          chain_ss6<1, F32B_BLOCK_N / 16, S::KVP, 0, 16 * SW128_ROW, 0>(dq[x], kb[x], sd);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < BOXES; ++x) fence_regs(dq[x]);
      }
      named_sync(bar, 128);  // every warp's dQ^T has read dS
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 64 * x + tw * 16 + tg + 8 * r;
          if (col >= dcols) continue;  // bwd f32 dQ stage columns
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            dq_stage[(8 * jj + 2 * tt) * dcols + col] = dq[x][4 * jj + 2 * r];
            dq_stage[(8 * jj + 2 * tt + 1) * dcols + col] = dq[x][4 * jj + 2 * r + 1];
          }
        }
      }
      fence_proxy_async();
      named_sync(bar, 128);  // the whole dQ tile is staged
      if (issuer) {
        // Only the tile's rows below Nq: dQ is [B, Hq, Nq, d] contiguous, so
        // a full 32 rows on the last tile would add into the next head's.
        const int q_rows = min(F32B_BLOCK_M, p.nq - m);
        float* dq_tile = p.dq + ((static_cast<int64_t>(b) * p.hq + h) * p.nq + m) * d;
        if constexpr (WIDE) {
          // One reduction per row of this CTA's columns: a span over rows
          // would add into the peer's columns and the next rows.
          if (tid < q_rows) {
            bulk_reduce_add_f32(dq_tile + static_cast<int64_t>(tid) * d + c_off,
                                dq_stage + tid * dcols, dcols * 4);  // bwd f32 d256 dQ reduce
          }
        } else {
          bulk_reduce_add_f32(dq_tile, dq_stage, q_rows * d * 4);  // bwd f32 dQ reduce
        }
        bulk_commit();
      }
    }

    // The two consumers' dK / dV added once: consumer 0 hands its dK over
    // through its stage, consumer 1 its dV through its own (both stages are
    // done with: every visit has retired), each thread's values at [i][tid],
    // the same thread of the other consumer holding the same keys and
    // columns; consumer 0 then writes dV, consumer 1 dK.
    float* mine_s = reinterpret_cast<float*>(stage(c));
    const float* theirs_s = reinterpret_cast<const float*>(stage(c ^ 1));
    const int64_t dkv_head = RING ? static_cast<int64_t>(b) * (p.hq / p.rep) + hk
                                  : static_cast<int64_t>(b) * p.hq + head;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) mine_s[i * 128 + tid] = dk[i];
    } else {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) mine_s[i * 128 + tid] = dv[i];
    }
    named_sync(3, 256);  // bwd f32 dkv handover
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) dv[i] += theirs_s[i * 128 + tid];
      store_dkv<DH, RING>(p.dv, dv, p, dkv_head, kv0, c_off, t);
    } else {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) dk[i] += theirs_s[i * 128 + tid];
      store_dkv<DH, RING>(p.dk, dk, p, dkv_head, kv0, c_off, t);
    }
    if (issuer) bulk_wait();
  }
  // WIDE: no CTA leaves while its peer may still write into its shared memory.
  if constexpr (WIDE) cluster_sync();
}

template <int D, bool SEG, bool CAP, bool BIAS, bool RING = false>
cudaError_t bwd_f32_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                           const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                           const BwdF32Params& p, cudaStream_t stream) {
  auto kernel = bwd_f32_kernel<D, SEG, CAP, BIAS, RING>;
  constexpr int smem = F32BwdSmem<D>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  constexpr int ranks = F32BwdSmem<D>::WIDE ? 2 : 1;  // CTAs per cluster
  const int heads = RING ? p.hq / p.rep : p.hq;  // RING: a CTA (pair) per KV head
  const dim3 grid(heads * ranks, (p.nk + F32B_BLOCK_N - 1) / F32B_BLOCK_N, p.batch);
  if constexpr (ranks == 1) {
    kernel<<<grid, F32B_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
    return cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(F32B_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, tm_q, tm_k, tm_v, tm_do, p);
    return le != cudaSuccess ? le : cudaGetLastError();
  }
}

template <int D, bool BIAS>
cudaError_t bwd_f32_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                             const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                             const BwdF32Params& p, bool seg, bool cap, cudaStream_t stream) {
  if (seg) {
    return cap ? bwd_f32_launch<D, true, true, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream)
               : bwd_f32_launch<D, true, false, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream);
  }
  return cap ? bwd_f32_launch<D, false, true, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream)
             : bwd_f32_launch<D, false, false, BIAS>(tm_q, tm_k, tm_v, tm_do, p, stream);
}

}  // namespace

extern "C" {

// dQ, dK, dV (and dbias) of attention on f32 inputs: the argument list of
// fa_bwd_split_sm90 (flash_bwd_split_sm90.cu) in its order, then the bias and
// dbias before the stream, on f32 q / dout
// [B, Hq, Nq, D] and k / v [B, Hkv, Nk, D] (unit stride on D, other strides
// in elements, any alignment), and after dv `pieces`: bf16 scratch of 3 DB (2
// B Hq Nq + 2 B Hkv kv_valid_len) elements, 16-byte aligned (DB = 64 for D <=
// 64, 128 for D <= 128, else 256; above 128 the D 256 form, a cluster of two
// CTAs a KV tile). One launch of the split (split_bf16x3.cu) writes the three
// bf16 pieces of q's and dout's rows and of k's and v's first kv_valid_len
// rows there (q, k, v, dout in that order, each [3, B, H, N, DB]); the
// attention kernel then reads them. lse / delta [B, Hq, nq_pad] f32
// contiguous (nq_pad a multiple of 32, rows past Nq never read as live), dq
// [B, Hq, Nq, D] f32 contiguous, zeroed and added to, dk / dv [B, Hq, Nk, D]
// f32 contiguous per query head (every row written); causal, the window (wl,
// wr; a negative bound is none) and the absolute offsets (q_off, kv_off) as
// in K3's fa_bwd_sm90; segment ids as four pointers or none --
//   seg_q [B, q_tiles * 32] and seg_kv [B, kv_tiles * 64] int32 contiguous,
//     16-byte aligned: the ids of the rows below Nq and of the keys below
//     kv_valid_len, each row padded to whole tiles;
//   q_range [B, q_tiles] and kv_range [B, kv_tiles] int32 (min, max) pairs:
//     each 32-row Q tile's and each 64-key tile's id range,
// with q_tiles = ceil(Nq / 32) and kv_tiles = ceil(kv_valid_len / 64);
// softcap > 0 the forward's cap, 0 none; bias an f32 [B|1, Hq|1, Nq|1, Nk]
// (unit column stride, 4-byte aligned, (batch, head, row) strides in
// elements, 0 on broadcast dims) added to the (capped) scores as the forward
// added it, or null; dbias, with a bias, [B, Hq, Nq, Nk] f32 contiguous or
// null: P (dP - Delta) on every pair of the Q tiles the kernel visits (0 on
// the pairs the masks drop), nothing elsewhere; none of the three options is
// K3's call. Requires kv_valid_len >= 1 (without keys every gradient is 0). Returns a
// cudaError_t (0: success; cudaErrorInvalidValue for arguments it does not
// take, cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or
// refuses a tensor map).
int fa_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dq, void* dk, void* dv, void* pieces, const void* seg_q,
               const void* seg_kv, const void* q_range, const void* kv_range, int batch, int hq,
               int hkv, int nq, int nk, int d, int kv_valid_len, int causal, int wl, int wr,
               int q_off, int kv_off, int nq_pad, float scale, float softcap, int64_t q_sb,
               int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
               int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh,
               int64_t do_sn, const void* bias, void* dbias, int64_t bias_sb, int64_t bias_sh,
               int64_t bias_sn, void* stream) {
  const bool seg = seg_q != nullptr;
  const bool cap = softcap > 0.f;
  const bool has_bias = bias != nullptr;
  if (d < 8 || d > 256 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq > 65535 || hq % hkv != 0 || nq < 1 || nk < 1 ||
      (nk + F32B_BLOCK_N - 1) / F32B_BLOCK_N > 65535 || kv_valid_len < 1 ||
      kv_valid_len > nk || nq_pad < nq || nq_pad % F32B_BLOCK_M || !(softcap >= 0.f) ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) ||
      (seg && (!aligned(seg_q, 16) || !aligned(seg_kv, 16) || !aligned(q_range, 8) ||
               !aligned(kv_range, 8))) ||
      !aligned(pieces, 16) || !aligned(lse, 16) || !aligned(delta, 16) || !aligned(dq, 16) ||
      !aligned(dk, 8) || !aligned(dv, 8) || (dbias != nullptr && !has_bias) ||
      (has_bias && (!aligned(bias, 4) || bias_sb < 0 || bias_sh < 0 || bias_sn < 0)) ||
      !aligned(dbias, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The pieces: q's [3, B, Hq, Nq, DB], k's and v's [3, B, Hkv, kv_valid_len,
  // DB], dout's [3, B, Hq, Nq, DB].
  const int db = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const int64_t q_head = static_cast<int64_t>(db) * nq;
  const int64_t kv_head = static_cast<int64_t>(db) * kv_valid_len;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(pieces);
  __nv_bfloat16* kp = qp + 3 * q_head * hq * batch;
  __nv_bfloat16* vp = kp + 3 * kv_head * hkv * batch;
  __nv_bfloat16* dop = vp + 3 * kv_head * hkv * batch;
  const fa::SplitArg split[4] = {{q, qp, batch, hq, nq, d, q_sb, q_sh, q_sn},
                                 {k, kp, batch, hkv, kv_valid_len, d, k_sb, k_sh, k_sn},
                                 {v, vp, batch, hkv, kv_valid_len, d, v_sb, v_sh, v_sn},
                                 {dout, dop, batch, hq, nq, d, do_sb, do_sh, do_sn}};
  cudaError_t e = fa::split_bf16x3(split, 4, db, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  if (!make_bhnd_map(&tm_q, qp, 3 * batch, hq, nq, d, q_head * hq, q_head, db, F32B_BLOCK_M) ||
      !make_bhnd_map(&tm_k, kp, 3 * batch, hkv, kv_valid_len, d, kv_head * hkv, kv_head, db,
                     F32B_BLOCK_N) ||
      !make_bhnd_map(&tm_v, vp, 3 * batch, hkv, kv_valid_len, d, kv_head * hkv, kv_head, db,
                     F32B_BLOCK_N) ||
      !make_bhnd_map(&tm_do, dop, 3 * batch, hq, nq, d, q_head * hq, q_head, db,
                     F32B_BLOCK_M)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::BwdF32Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.batch = batch;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq_pad;
  p.nk = nk;
  p.kv_valid_len = kv_valid_len;
  p.d = d;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.q_tiles = (nq + F32B_BLOCK_M - 1) / F32B_BLOCK_M;
  p.kv_tiles = (kv_valid_len + F32B_BLOCK_N - 1) / F32B_BLOCK_N;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  p.bias = static_cast<const float*>(bias);
  p.dbias = static_cast<float*>(dbias);
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
  if (has_bias) {
    e = d <= 64    ? bwd_f32_dispatch<64, true>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s)
        : d <= 128 ? bwd_f32_dispatch<128, true>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s)
                   : bwd_f32_dispatch<256, true>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s);
  } else {
    e = d <= 64    ? bwd_f32_dispatch<64, false>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s)
        : d <= 128 ? bwd_f32_dispatch<128, false>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s)
                   : bwd_f32_dispatch<256, false>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, s);
  }
  return static_cast<int>(e);
}


// K8 on f32 inputs, one ring backward step of one rank (ring_bwd.cu's
// fa_ring_bwd_bf16, whose argument list this takes in its order, with the
// pieces after dv): f32 q (q * scale * log2 e) / dout [B, Hq, nq, D] and k /
// v [B, Hkv, nk, D] (unit stride on D, other strides in elements), lse
// (natural log, -inf on a dead row), delta, dq, dk and dv as there: dq added
// to by bulk reductions over its rows, dk / dv [B, Hkv, nk, D] the ring's
// rotating accumulators, read, summed over each KV head's query heads inside
// the CTA and written back. The step runs this file's kernel with RING --
// the band shifted by q_base - kv_off, scale = scale_log2 = 1 (q arrives in
// the log2 domain, so dq comes out x 1/scale and dk x 1/ln2 of the
// gradients) -- on three bf16 pieces per operand: one launch of the split
// writes k's and v's pieces into kv_pieces (3 DB 2 B Hkv nk elements) and,
// with split_q != 0, q's and then dout's into q_pieces (3 DB 2 B Hq nq
// elements); without it q_pieces holds what the rank's first live step
// wrote there (q and dO do not rotate). Both 16-byte aligned; DB as
// fa_ring_fwd_f32's. Requires 8 <= D <= 256 with D % 8 == 0, Hq % Hkv == 0,
// nq and nk multiples of 128, B <= 65535; above D 128 a cluster of two CTAs
// per KV head and 64 keys. Returns a cudaError_t as fa_bwd_f32.
int fa_ring_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, void* dk, void* dv,
                    void* q_pieces, void* kv_pieces, int split_q, int batch, int hq, int hkv,
                    int nq, int nk, int d, int q_base, int kv_off, int causal, int wl, int wr,
                    int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb, int64_t kv_sh,
                    int64_t kv_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn, void* stream) {
  if (batch < 1 || batch > 65535 || d < 8 || d > 256 || d % 8 || hkv < 1 || hq < 1 ||
      hq % hkv || nq < 128 || nk < 128 || nq % 128 || nk % 128 ||
      nk / F32B_BLOCK_N > 65535 || !aligned(q_pieces, 16) || !aligned(kv_pieces, 16) ||
      !aligned(lse, 16) || !aligned(delta, 16) || !aligned(dq, 16) || !aligned(dk, 8) ||
      !aligned(dv, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int db = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const int64_t q_head = static_cast<int64_t>(db) * nq;
  const int64_t kv_head = static_cast<int64_t>(db) * nk;
  __nv_bfloat16* qp = static_cast<__nv_bfloat16*>(q_pieces);
  __nv_bfloat16* dop = qp + 3 * q_head * hq * batch;
  __nv_bfloat16* kp = static_cast<__nv_bfloat16*>(kv_pieces);
  __nv_bfloat16* vp = kp + 3 * kv_head * hkv * batch;
  const fa::SplitArg split[4] = {{k, kp, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn},
                                 {v, vp, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn},
                                 {q, qp, batch, hq, nq, d, q_sb, q_sh, q_sn},
                                 {dout, dop, batch, hq, nq, d, do_sb, do_sh, do_sn}};
  cudaError_t e = fa::split_bf16x3(split, split_q ? 4 : 2, db, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  if (!make_bhnd_map(&tm_q, qp, 3 * batch, hq, nq, d, q_head * hq, q_head, db, F32B_BLOCK_M) ||
      !make_bhnd_map(&tm_k, kp, 3 * batch, hkv, nk, d, kv_head * hkv, kv_head, db,
                     F32B_BLOCK_N) ||
      !make_bhnd_map(&tm_v, vp, 3 * batch, hkv, nk, d, kv_head * hkv, kv_head, db,
                     F32B_BLOCK_N) ||
      !make_bhnd_map(&tm_do, dop, 3 * batch, hq, nq, d, q_head * hq, q_head, db,
                     F32B_BLOCK_M)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::BwdF32Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.batch = batch;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq;
  p.nk = nk;
  p.kv_valid_len = nk;
  p.d = d;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_base) - kv_off);
  p.q_tiles = nq / F32B_BLOCK_M;
  p.kv_tiles = nk / F32B_BLOCK_N;
  p.scale = 1.f;
  p.scale_log2 = 1.f;
  e = d <= 64    ? bwd_f32_launch<64, false, false, false, true>(tm_q, tm_k, tm_v, tm_do, p, s)
      : d <= 128 ? bwd_f32_launch<128, false, false, false, true>(tm_q, tm_k, tm_v, tm_do, p, s)
                 : bwd_f32_launch<256, false, false, false, true>(tm_q, tm_k, tm_v, tm_do, p,
                                                                  s);
  return static_cast<int>(e);
}

}  // extern "C"
