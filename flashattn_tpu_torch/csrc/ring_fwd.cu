// K7, one forward step of ring attention, for Hopper (sm_90a): a warp-
// specialised TMA + wgmma forward of the chunk pair with the LSE merge (or
// the finalize) in its epilogue, and the C entry fa_ring_fwd_bf16 (bf16, D
// <= 256; K7 on f32 is flash_fwd_f32.cu's fa_ring_fwd_f32).
//
// Replaces the TPU kernel flashattn_tpu/parallel/ring_kernel.py::
// _ring_fwd_kernel (K7, :74, with _merge_tile :257 and _finalize_tile :357).
// Each rank of the ring holds one contiguous chunk of Q (nq rows, global rows
// q_base ..) and, at step s, the K/V chunk of rank (rank - s) mod P (nk rows,
// global columns kv_off ..). The TPU kernel runs a device's whole ring in one
// launch and moves the chunks by remote DMA from inside it; here the host
// runs the ring (parallel/ring_kernel.py): one launch per live (rank, step),
// so a chunk wholly outside the causal / window band is never launched, and
// the rotation is a copy or a torch.distributed send / recv between launches.
//
// What one launch computes: the chunk's partial of K1's online softmax in the
// log2 domain (q arrives pre-scaled by scale * log2 e, ring_kernel.py:886),
// with the causal / window band in GLOBAL positions -- row q_base + i sees
// column kv_off + j iff row - lo <= col <= row + hi -- merged into the rank's
// running f32 state (acc [B, Hq, nq, D] unnormalized, m and l [B, Hq, nq], m
// in log2 units) by the LSE rule of ring_kernel.py:317-354; a partial whose
// max is at or below half the mask value is dropped (a row the band leaves
// no column in this chunk). The first live step starts from (m, l, acc) =
// (mask, 0, 0) without reading the state; the last writes O = acc / l (bf16)
// and LSE = (m + log2 l) ln2 instead, O = 0 and LSE = -inf on a row no step
// gave a column (:357-386).
//
// What bounds it: at the LM's attention width (B1 Hq16 Hkv8 D128) a full
// off-diagonal 4096 x 4096 chunk pair is 2 * 2 * 16 * 4096^2 * 128 = 137
// GFLOP against ~70 MB of Q, K / V and f32 state: operations, 0.139 ms at 989
// TFLOP/s. The mma.sync design this replaces (64-row CTAs of 4 warps,
// synchronous K / V loads between two block barriers per tile) ran it at
// ~123 TFLOP/s. This design is K1's bias route (fwd_sm90_tile.cuh) without
// the bias stream:
//
//   * One CTA owns 128 Q rows of one (batch, q head): warpgroup 0 is the
//     producer (one thread issues every TMA; setmaxnreg gives the rest of its
//     registers away), warpgroups 1 and 2 the consumers, 64 rows each.
//   * Q (once) and K / V tiles of 64 keys come by TMA into a 4-stage ring on
//     full / empty mbarriers, through 4-D maps over (D, seq, head, batch)
//     with the 128-byte swizzle whose sequence extents are the CHUNK's nq /
//     nk: a box never reads a neighbouring rank's rows. A head dim below the
//     box (D 40, 96: D pads to 64 or 128) reads zeros past D, so those
//     columns add nothing and O / acc columns >= D are never written.
//   * S = Q K^T by wgmma m64n64k16 from shared memory; O += P V by wgmma with
//     P from registers (the accumulator layout is mma.sync's) and V the
//     N-major B operand. One MUFU.EX2 per exponential; the band's mask only on
//     the tiles it cuts; tiles wholly outside the band are never loaded, and
//     a warpgroup releases unread the tiles that miss its own 64 rows.
//   * With a right bound (causal) the Q tiles that meet the most KV tiles run
//     first, so the diagonal step's grid ends on short CTAs.
//   * The epilogue merges (or finalizes) the rows each thread owns in the
//     accumulator layout straight against the f32 state in global memory
//     (ring_merge.cuh, shared by every form of K7).
//
// At D 136-256 (Gemma 2's heads of 256) this body does not widen: Q and four
// (K, V) stages would take 320 KB of shared memory, and O 128 f32 a thread.
// A full off-diagonal 4096 x 4096 chunk pair at B1 Hq8 Hkv4 D256 is the same
// 137 GFLOP (0.139 ms at 989 TFLOP/s) against ~100 MB of Q, K / V and f32
// state: operations. So the D 256 form, ring_fwd_wide_kernel, runs K1's dense
// body (fwd_sm90_tile.cuh) at its D 256 instantiation with RING -- 128 Q
// rows a CTA, Q 64 KB and two (K, V) stages of 80 keys (80 KB), each tile's
// softmax under the next tile's S and the previous tile's P V, the two
// consumer warpgroups issuing their products in turn, 24 producer and 240
// consumer registers -- on the chunk pair: the band shifted by q_base -
// kv_off (common.cuh band_bounds), q pre-scaled (scale_log2 = 1), the rows'
// state prefetched into L2 by the producer four tiles before the end, and
// this ring's epilogue in place of K1's, reading and writing the state in
// float2 column pairs, so the 128 O registers need no second copy. A chunk
// of 4096 keys ends in a partial 80-key tile, masked as K1's KV tail. Every
// D 136-248 reads zeros past D from the 256-column boxes.

#include "fwd_sm90_tile.cuh"
#include "ring_merge.cuh"

namespace {

using namespace fa;

constexpr int RF_BLOCK_M = 128;  // Q rows per CTA: two consumer warpgroups of 64
constexpr int RF_BLOCK_N = 64;   // keys per KV tile
constexpr int RF_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups

struct RingFwdParams {
  RingState ring;    // the rank's running state and the step's place (ring_merge.cuh)
  __nv_bfloat16* o;  // written on the last step, (batch, head, seq) strides
  float* lse;        // [B, Hq, nq] f32 contiguous, written on the last step
  int64_t o_sb, o_sh, o_sn;
  int hq, rep, nq, nk, d;
  int q_base, kv_off;  // global position of the chunk's first Q row / KV column
  int lo, hi;          // band: row - lo <= col <= row + hi (NO_BOUND: none)
};

// The D 256 form's parameters: K1's dense route's (fwd_sm90_tile.cuh), whose
// body it runs with RING, and the state.
struct RingWideParams : FwdDenseParams {
  RingState ring;
};

// Shared-memory layout (bytes, from a 1024-byte-aligned base): Q (D / 64
// boxes of 128 rows), then per stage K and V (D / 64 boxes of 64 rows each),
// then the mbarriers q_full, full[STAGES], empty[STAGES].
template <int D>
struct RfSmem {
  static constexpr int STAGES = 4;
  static constexpr int Q = RF_BLOCK_M * D * 2;
  static constexpr int KV = RF_BLOCK_N * D * 2;
  static constexpr int STAGE = 2 * KV;
  static constexpr int BARS = Q + STAGES * STAGE;
  static constexpr int BYTES = 1024 + BARS + (1 + 2 * STAGES) * 8;
  static_assert(Q % 1024 == 0 && KV % 1024 == 0, "the 128-byte swizzle repeats every 1024 bytes");
  static_assert(BYTES <= 232448, "a block's shared memory on sm_90");
};

// One tile's scores (log2 domain) to probabilities, sc[4jj + 2r + e] being
// row `row0` + 8r, column `col0` + 8jj + 2t + e (global positions): with
// MASKED, the pairs outside the band take the mask value; then the online max
// and sum. Returns the rescale factor of the earlier tiles' O in alpha.
template <bool MASKED>
__device__ __forceinline__ void ring_softmax_tile(float (&sc)[32], int col0, int row0, int t,
                                                  int lo, int hi, float (&m_i)[2],
                                                  float (&l_i)[2], float (&alpha)[2]) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    if (MASKED) {
      const int col = col0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = row0 + 8 * r;
      if (col - row > hi || row - col > lo) sc[i] = MASK_VALUE;  // K7 band mask
    }
    mx[r] = fmaxf(mx[r], sc[i]);
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
__global__ void __launch_bounds__(RF_THREADS, 1)
    ring_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const RingFwdParams p) {
  static_assert(D == 64 || D == 128, "instantiated for D 64 and 128");
  using S = RfSmem<D>;
  constexpr int BOXES = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + S::STAGES;

  const int h = blockIdx.x;
  // A right bound (causal): the late Q tiles meet the most KV tiles; run them first.
  const int m_tile = p.hi < NO_BOUND ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int m0 = m_tile * RF_BLOCK_M;  // local row of the tile
  const int b = blockIdx.z;
  // The chunk's KV tiles that meet the tile's band: global columns
  // [r0 - lo, r0 + 127 + hi], local tiles from n_begin.
  const int r0 = p.q_base + m0;
  int n_begin = 0;
  int n_end = p.nk;
  if (p.lo < NO_BOUND) n_begin = max(0, r0 - p.lo - p.kv_off) / RF_BLOCK_N * RF_BLOCK_N;
  if (p.hi < NO_BOUND) n_end = min(p.nk, r0 + RF_BLOCK_M + p.hi - p.kv_off);
  const int n_tiles = n_end > n_begin ? (n_end - n_begin + RF_BLOCK_N - 1) / RF_BLOCK_N : 0;
  // An empty partial merges as a no-op: only the first and the last step
  // still have a state to start or to finalize.
  if (n_tiles == 0 && !p.ring.first && !p.ring.last) return;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  auto stage = [&](int j) { return smem + S::Q + (j % S::STAGES) * S::STAGE; };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the TMA thread's expect_tx
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: thread 0 issues the TMA loads.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid == 0 && n_tiles > 0) {
      const int hk = h / p.rep;  // GQA: the BlockSpec index map h // rep
      mbar_expect_tx(q_full, S::Q);
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        tma_load_4d(smem + x * RF_BLOCK_M * SW128_ROW, &tm_q, q_full, 64 * x, m0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S::STAGES;
        const int n0 = n_begin + j * RF_BLOCK_N;
        unsigned char* st = stage(j);
        mbar_wait(&empty[s], ((j / S::STAGES) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * S::KV);
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_4d(st + x * RF_BLOCK_N * SW128_ROW, &tm_k, &full[s], 64 * x, n0, hk, b);
          tma_load_4d(st + S::KV + x * RF_BLOCK_N * SW128_ROW, &tm_v, &full[s], 64 * x, n0, hk,
                      b);
        }
      }
    }
  } else {
    // Consumers: warpgroup 1 owns local rows m0..m0+63, warpgroup 2 m0+64..m0+127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int half = wg - 1;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const int rw = r0 + half * 64;          // global first row of this warpgroup
    const int row0 = rw + warp * 16 + g;    // global row of this thread's row g
    const unsigned char* q_s = smem + half * 64 * SW128_ROW;
    // The CTA's tiles that meet this warpgroup's rows, [j_lo, j_hi): global
    // columns [rw - lo, rw + 63 + hi]; the others are released unread.
    int j_lo = 0;
    int j_hi = n_tiles;
    if (p.lo < NO_BOUND) j_lo = max(0, rw - p.lo - p.kv_off - n_begin) / RF_BLOCK_N;
    if (p.hi < NO_BOUND) {
      const int last_col = rw + 63 + p.hi - p.kv_off - n_begin;
      j_hi = min(n_tiles, last_col < 0 ? 0 : last_col / RF_BLOCK_N + 1);
    }
    auto edge = [&](int j) {  // a tile the band cuts for this warpgroup's rows
      const int c0 = p.kv_off + n_begin + j * RF_BLOCK_N;
      return c0 + RF_BLOCK_N - 1 - rw > p.hi || rw + 63 - c0 > p.lo;
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
    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      mbar_wait(&full[j % S::STAGES], (j / S::STAGES) & 1);
      if (j >= j_lo && j < j_hi) {
        issue_qk<D, RF_BLOCK_M, RF_BLOCK_N>(sc, q_s, stage(j));
        wgmma_wait<0>();
        fence_regs(sc);
        const int col0 = p.kv_off + n_begin + j * RF_BLOCK_N;
        if (edge(j)) {
          ring_softmax_tile<true>(sc, col0, row0, t, p.lo, p.hi, m_i, l_i, alpha);
        } else {
          ring_softmax_tile<false>(sc, col0, row0, t, p.lo, p.hi, m_i, l_i, alpha);
        }
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p(pa, sc);
        issue_pv<D, RF_BLOCK_N>(o, pa, stage(j) + S::KV);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      }
      release(j);
    }

    // Epilogue: merge the chunk partial into the running state, or finalize
    // on the rank's last live step (ring_merge.cuh). Columns >= d hold zeros
    // (the boxes read zeros there) and are not written.
    ring_merge_store<D>(p.ring, p.o, p.o_sb, p.o_sh, p.o_sn, p.lse, p.hq, p.nq, p.d, o, m_i,
                        l_i, b, h, m0 + half * 64 + warp * 16 + g, t);
  }
}

// K7 at D 136-256: K1's dense body (fwd_sm90_tile.cuh, its D 256 form) on the
// chunk pair, with the band shifted by q_base - kv_off and q pre-scaled
// (scale_log2 = 1), and this ring's epilogue in place of K1's.
__global__ void __launch_bounds__(FB_THREADS, 1)
    ring_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const RingWideParams p) {
  fwd_sm90_body<256, false, false, false, true>(tm_q, tm_k, tm_v, p);
}

template <int D>
cudaError_t ring_fwd_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, const RingFwdParams& p, int batch,
                            cudaStream_t stream) {
  auto kernel = ring_fwd_sm90_kernel<D>;
  const cudaError_t e = allow_smem(kernel, RfSmem<D>::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, p.nq / RF_BLOCK_M, batch);
  kernel<<<grid, RF_THREADS, RfSmem<D>::BYTES, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: one ring forward step of one rank. q [B, Hq, nq, D] (q * scale * log2 e)
// and k/v [B, Hkv, nk, D] bf16 with unit stride on D and the given (batch,
// head, seq) strides in elements (k and v share theirs; multiples of 8,
// nonzero on dims of extent > 1; 16-byte-aligned bases: TMA's); acc
// [B, Hq, nq, D] and m, l, lse [B, Hq, nq] f32 contiguous; o like q with its
// own strides (4-byte aligned rows). q_base and kv_off are the global
// positions of the chunks' first row and column; causal != 0 masks col >
// row, the window (wl, wr) col < row - wl (wl >= 0) and col > row + wr (wr >=
// 0). first != 0: start the state instead of reading it; last != 0: write O
// and LSE instead of the state. Requires 8 <= D <= 256, D % 8 == 0, Hq % Hkv
// == 0, nq and nk multiples of 128, B <= 65535; above D 128 the D 256 form
// (K1's dense body, ring_fwd_wide_kernel). Returns a cudaError_t (0:
// success; cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or refuses a
// tensor map).
int fa_ring_fwd_bf16(const void* q, const void* k, const void* v, void* acc, void* m, void* l,
                     void* o, void* lse, int batch, int hq, int hkv, int nq, int nk, int d,
                     int q_base, int kv_off, int causal, int wl, int wr, int first, int last,
                     int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t kv_sb, int64_t kv_sh,
                     int64_t kv_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn, void* stream) {
  if (batch < 1 || batch > 65535 || d < 8 || d > 256 || d % 8 || hkv < 1 || hq < 1 ||
      hq % hkv || nq < RF_BLOCK_M || nk < RF_BLOCK_M || nq % RF_BLOCK_M || nk % RF_BLOCK_M ||
      nq / RF_BLOCK_M > 65535 || !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) ||
      !aligned(o, 4) || !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(kv_sb, batch, kv_sh, hkv, kv_sn, nk) || o_sb % 2 || o_sh % 2 || o_sn % 2 ||
      (!(first && last) && (acc == nullptr || m == nullptr || l == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  // Keys per KV tile: 80 in the D 256 form (K1's dense body's dense_kv_tile).
  const int kv_tile = d > 128 ? dense_kv_tile(d) : RF_BLOCK_N;
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, RF_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn, kv_tile) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nk, d, kv_sb, kv_sh, kv_sn, kv_tile)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const RingState ring = {static_cast<float*>(acc), static_cast<float*>(m),
                          static_cast<float*>(l), first != 0, last != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128) {
    // K1's dense route's parameters: the band in the chunks' local positions
    // (shifted by q_base - kv_off), no tail, no ids, no cap, q pre-scaled.
    RingWideParams p = {};
    p.ring = ring;
    p.o = static_cast<__nv_bfloat16*>(o);
    p.lse = static_cast<float*>(lse);
    p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
    p.hq = hq;
    p.rep = hq / hkv;
    p.nq = nq;
    p.d = d;
    p.kv_valid_len = nk;
    band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_base) - kv_off);
    p.q_tiles = nq / FB_BLOCK_M;
    p.kv_tiles = (nk + kv_tile - 1) / kv_tile;
    p.scale_log2 = 1.f;
    return static_cast<int>(fwd_sm90_launch(ring_fwd_wide_kernel, FbSmem<256, false>::BYTES,
                                            tm_q, tm_k, tm_v, p, batch, s));
  }
  RingFwdParams p;
  p.ring = ring;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.q_base = q_base;
  p.kv_off = kv_off;
  band_bounds(causal, wl, wr, &p.lo, &p.hi);
  const cudaError_t e = d <= 64 ? ring_fwd_launch<64>(tm_q, tm_k, tm_v, p, batch, s)
                                : ring_fwd_launch<128>(tm_q, tm_k, tm_v, p, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
