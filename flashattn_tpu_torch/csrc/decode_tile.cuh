// K1's decode route for Hopper (sm_90a): a split-KV forward for a few query
// rows per KV head, with cp.async pipelining -- the kernel body shared by
// flash_decode.cu (bf16 K/V) and flash_decode_quant.cu (int8 / fp8 K/V).
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) on the calls that decoding makes: a query of at most 32 rows per KV
// head once the GQA fold (flashattn_tpu/ops/flash.py:1052-1077) has put each
// KV head's query heads into the Q rows, non-causal, without segment ids or a
// window, D 64 or 128. It computes K1's function exactly as fwd_sm90_tile.cuh does:
// scores s = q k in f32, x = s * scale * log2 e (with int8 / fp8 K the
// column's k_scale first; with a softcap x = cap * log2 e * tanh(s * scale /
// cap)), + bias * log2 e floored at the finite mask value, keys past
// kv_valid_len at the mask value; online softmax in the log2 domain; P times
// v_scale (quantized V) before its bf16 rounding for P V; O in bf16, LSE in
// natural log; a row whose largest score is at most half the mask value is
// dead (O = 0, LSE = ln2 * mask).
//
// What bounds it: bytes. At the LM's decode shape (q [8, 8, 2, 128] after the
// fold, K/V [8, 8, 8192, 128]) the kernel reads 268 MB of bf16 K/V for 0.27
// GFLOP: 0.080 ms at 3.35 TB/s against 0.0003 ms of tensor-core work; int8 /
// fp8 K/V halve the bytes, 0.041 ms. The dense K1 design (64-row Q tiles, one
// CTA per (Q tile, head), synchronous tile loads) ran 64 CTAs with 2 live rows
// each and no load in flight during the math: 5.9% of HBM's rate. This design
// puts bytes in flight on every SM:
//
//   * Split-KV grid (split, KV head, batch): the wrapper picks the split count
//     (ops/flash_fwd.py::decode_splits) so that there are about four CTAs per SM,
//     each split a whole number of 64-key tiles and never empty. Each CTA
//     writes its split's unnormalized f32 partial (m in log2 units, l, acc)
//     to scratch; decode_merge_kernel, a second launch from the same C entry,
//     merges the splits in LSE space and drops dead partials, as K7's epilogue
//     does (ring.cu). With one split the CTA writes O and LSE itself and
//     there is no second launch.
//   * Small Q tiles: the folded rows (2 at the LM's shape) sit in one 16-row
//     mma.sync tile, zero-padded; 17-32 rows take two tiles. The Q fragments
//     are read from global memory straight into registers.
//   * The 4 warps split the keys, not the Q rows: the split is cut into
//     16-key chunks dealt round-robin to the warps (warp w takes 16 of every
//     64 keys; with two Q tiles, warp pairs share a tile and take 16 of every
//     32 keys). Each warp keeps its own (m, l, acc) and its own pipeline, so
//     the main loop has no block-wide barrier; the warps merge in shared
//     memory at the end of the split.
//   * Asynchronous copies: each warp runs a ring of DEC_STAGES (K, V) chunks
//     in dynamic shared memory, filled by 16-byte cp.async.cg copies (the
//     per-token scales by 4-byte cp.async.ca: their strided views are not
//     16-byte runs), and waits with cp.async.wait_group so that the next
//     chunks are in flight while this one is used. Rows past kv_valid_len are
//     zero-filled by the copy itself (src-size 0). int8 / e4m3 chunks are
//     copied raw, at half the bytes of bf16, and widened (unscaled, exact)
//     into a per-warp bf16 chunk only after they arrive, so the mma.sync body
//     is the bf16 one.
//   * A bias (a caller's f32 [B|1, Hq|1, Nq|1, Nk] mask; decode_step passes
//     none, it hands the kernel only the live slots) is read through its
//     strides, 0 on broadcast dims, before the chunk's copies are waited on.
//   * F32Q (an f32 q over int8 / fp8 K/V, the f32 LM served from an 8-bit
//     cache; flash_decode_quant_f32.cu, C entry fa_decode_f32): the JAX
//     kernel's f32 products at Precision.HIGHEST, where the widened K / V are
//     exact in bf16 and only q and P need three bf16 pieces. q is split
//     into its pieces in registers as its fragments are read from global
//     memory (no split launch), S is three mma.sync a k-step (q0 K + q1 K +
//     q2 K), P (with its v_scale) is split in registers and O += P V is three
//     mma.sync a k-step; O is f32, written by the CTA or the merge. The
//     extra products are ~0.8 GFLOP at the f32 LM's decode: still bytes.

#pragma once

#include "common.cuh"

namespace fa {

struct DecodeParams {
  const void* q;  // bf16, or f32 with f32 (F32Q)
  const void* k;  // bf16, int8 or e4m3 bytes
  const void* v;
  void* o;        // q's type
  float* lse;            // [B, Hq, Nq] contiguous
  const float* bias;     // f32, unit column stride, or null
  const float* k_scale;  // [B, Hkv, Nk] f32 per-token scales (quantized K/V)
  const float* v_scale;
  float* part_acc;  // [B, Hkv, splits, rows, D] f32 (splits > 1)
  float* part_ml;   // [B, Hkv, splits, rows, 2] f32: m (log2 units), l
  int64_t q_sb, q_sh, q_sn;
  int64_t k_sb, k_sh, k_sn;
  int64_t v_sb, v_sh, v_sn;
  int64_t o_sb, o_sh, o_sn;
  int64_t bias_sb, bias_sh, bias_sn;  // 0 on broadcast dims
  int64_t ks_sb, ks_sh, ks_sn;
  int64_t vs_sb, vs_sh, vs_sn;
  int hq, hkv, rep, nq, rows, d, kv_valid_len, splits, split_len;
  float scale_log2;  // softmax scale * log2(e)
  float cap_scale;   // softcap: softmax scale / cap
  float cap_log2;    // softcap: cap * log2(e)
  bool f32;          // q and o f32 (F32Q; int8 / fp8 K/V only)
};

// One launch of the family over D 64 / 128 (then the merge when splits > 1);
// defined in the source that instantiates the family.
cudaError_t decode_bf16(const DecodeParams& p, int batch, cudaStream_t stream);   // flash_decode.cu
cudaError_t decode_quant(const DecodeParams& p, int batch, int kv_dtype,
                         cudaStream_t stream);  // flash_decode_quant.cu
cudaError_t decode_quant_f32(const DecodeParams& p, int batch, int kv_dtype,
                             cudaStream_t stream);  // flash_decode_quant_f32.cu
cudaError_t decode_merge(const DecodeParams& p, int batch, cudaStream_t stream);  // flash_decode.cu

}  // namespace fa

namespace {

using namespace fa;

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = 4;
constexpr int DEC_CHUNK = 16;  // keys per warp per pipeline step
constexpr int DEC_STAGES = 3;  // chunks in the ring of each warp

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one CTA (bytes). Per warp: DEC_STAGES stages of a
// raw K chunk and a raw V chunk [16 keys][D] with row stride RS (16-byte
// aligned; 16 extra bytes put the 8 rows of a fragment load on distinct
// banks), plus, for int8 / e4m3, the chunk's 16 K and 16 V scales and a bf16
// copy of the widened K and V chunk (row stride D + 8 elements). After the
// loop the same memory holds each warp's (acc, m, l) for the merge.
template <int D, int KV>
struct DecSmem {
  static constexpr bool QUANT = KV != KV_BF16;
  static constexpr int ESIZE = QUANT ? 1 : 2;
  static constexpr int RS = D * ESIZE + 16;
  static constexpr int RAW = DEC_CHUNK * RS;
  static constexpr int SCALES = QUANT ? 2 * DEC_CHUNK * 4 : 0;
  static constexpr int STAGE = 2 * RAW + SCALES;
  static constexpr int WS = D + 8;  // bf16 row stride (elements) the mma reads
  static constexpr int WIDE = QUANT ? 2 * DEC_CHUNK * WS * 2 : 0;
  static constexpr int WARP = DEC_STAGES * STAGE + WIDE;
  static constexpr int MERGE = DEC_WARPS * 16 * (D + 2) * 4;
  static constexpr int BYTES = DEC_WARPS * WARP > MERGE ? DEC_WARPS * WARP : MERGE;
  static_assert(RS % 16 == 0 && STAGE % 16 == 0 && WARP % 16 == 0, "16-byte alignment");
  static_assert(DEC_CHUNK * D * ESIZE / 16 % 32 == 0, "whole copy rounds per lane");
};

// Four int8 / e4m3 elements (the bytes of `raw`) as four bf16, exact, with
// full-rate integer and f32 operations (I2F and the fp8 conversions run at a
// quarter of that rate). int8: the byte x + 128 becomes the low mantissa byte
// of the f32 2^23 + 128 + x, minus 2^23 + 128 gives x. e4m3: its sign and
// exponent-mantissa bits moved to their bf16 places make a bf16 of value x
// 2^-120 (subnormals included, the f32 multiply keeps them), times 2^120.
// Either way the f32 holds at most 8 significant bits, so its high half is
// the bf16 exactly.
template <int KV>
__device__ __forceinline__ uint2 widen4(uint32_t raw) {
  uint32_t f[4];
  if constexpr (KV == KV_INT8) {
    const uint32_t u = raw ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) -
                             8388736.0f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b8 = (raw >> (8 * i)) & 0xffu;
      f[i] = __float_as_uint(__uint_as_float((b8 & 0x80u) << 24 | (b8 & 0x7fu) << 20) * 0x1p120f);
    }
  }
  return make_uint2(__byte_perm(f[0], f[1], 0x7632u), __byte_perm(f[2], f[3], 0x7632u));
}

// D: head dim (64 or 128); KV: K/V element type; BIAS: additive bias; CAP:
// logit soft-capping (bf16 K/V only); F32Q: an f32 q and O (8-bit K/V only).
template <int D, int KV, bool BIAS, bool CAP, bool F32Q = false>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecodeParams p) {
  using S = DecSmem<D, KV>;
  using KVT = typename KvElem<KV>::type;
  constexpr bool QUANT = S::QUANT;
  static_assert(!(CAP && QUANT), "softcap takes bf16 K/V only (the JAX ValueError)");
  static_assert(!F32Q || QUANT, "an f32 q over bf16 K/V is K1's f32 route");
  constexpr int QPC = F32Q ? 3 : 1;  // q's bf16 pieces
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NT_O = D / 8;  // n-tiles of the output
  constexpr int PIECES = D * S::ESIZE / 16;  // 16-byte pieces per K/V row
  constexpr int PIECE_ELEMS = 16 / S::ESIZE;
  constexpr int WS = S::WS;

  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  // Two 16-row Q tiles when the folded rows exceed 16: warp pairs share one.
  const int n_mt = p.rows > 16 ? 2 : 1;
  const int mt = warp % n_mt;
  const int cg = warp / n_mt;  // this warp's column group
  const int groups = DEC_WARPS / n_mt;

  const int n_lo = split * p.split_len;
  const int n_hi = min(n_lo + p.split_len, p.kv_valid_len);
  const int n_chunks = n_hi > n_lo ? (n_hi - n_lo + DEC_CHUNK - 1) / DEC_CHUNK : 0;
  const int my_chunks = n_chunks > cg ? (n_chunks - cg + groups - 1) / groups : 0;

  // Rows g and g + 8 of this warp's Q tile: folded row r is query i = r % nq
  // of head hk * rep + r / nq.
  int64_t q_off[2];
  bool live_row[2];
  const float* bias_row[2] = {nullptr, nullptr};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = mt * 16 + g + 8 * e;
    live_row[e] = r < p.rows;
    const int h = hk * p.rep + (live_row[e] ? r / p.nq : 0);
    const int i = live_row[e] ? r % p.nq : 0;
    q_off[e] = b * p.q_sb + h * p.q_sh + i * p.q_sn;
    if (BIAS && live_row[e]) bias_row[e] = p.bias + b * p.bias_sb + h * p.bias_sh + i * p.bias_sn;
  }
  // Q A-fragments of the warp's tile, straight from global memory (zero rows
  // past p.rows); F32Q: each f32 pair split into its three bf16 pieces,
  // qa[pc] piece pc's fragments.
  uint32_t qa[QPC][KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (F32Q) {
        const float* qr = static_cast<const float*>(p.q) + q_off[e] + c;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {  // columns c, c + 1, then c + 8, c + 9
          const float2 x = live_row[e] ? __ldg(reinterpret_cast<const float2*>(qr + 8 * hf))
                                       : make_float2(0.f, 0.f);
          uint32_t w[3];
          split3_pair(x.x, x.y, w);  // decode f32 q pieces
#pragma unroll
          for (int pc = 0; pc < 3; ++pc) qa[pc][ks][2 * hf + e] = w[pc];
        }
      } else {
        const uint32_t* qr = reinterpret_cast<const uint32_t*>(
            static_cast<const __nv_bfloat16*>(p.q) + q_off[e] + c);
        qa[0][ks][e] = live_row[e] ? __ldg(qr) : 0u;
        qa[0][ks][2 + e] = live_row[e] ? __ldg(qr + 4) : 0u;
      }
    }
  }

  const KVT* k_g = static_cast<const KVT*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const KVT* v_g = static_cast<const KVT*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const float* ks_g = QUANT ? p.k_scale + b * p.ks_sb + hk * p.ks_sh : nullptr;
  const float* vs_g = QUANT ? p.v_scale + b * p.vs_sb + hk * p.vs_sh : nullptr;
  unsigned char* ring = smem + warp * S::WARP;
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(ring + DEC_STAGES * S::STAGE);

  // Issue the copies of this warp's chunk i into its stage.
  auto issue = [&](int i) {
    unsigned char* st = ring + (i % DEC_STAGES) * S::STAGE;
    const int n0 = n_lo + (cg + i * groups) * DEC_CHUNK;
    const int rows_valid = min(DEC_CHUNK, n_hi - n0);
#pragma unroll
    for (int j = 0; j < DEC_CHUNK * PIECES / 32; ++j) {
      const int idx = lane + 32 * j;
      const int r = idx / PIECES;
      const int c = idx % PIECES;
      const int64_t n = n0 + min(r, rows_valid - 1);
      const int bytes = r < rows_valid ? 16 : 0;
      cp_async_16(st + r * S::RS + c * 16, k_g + n * p.k_sn + c * PIECE_ELEMS, bytes);
      cp_async_16(st + S::RAW + r * S::RS + c * 16, v_g + n * p.v_sn + c * PIECE_ELEMS, bytes);
    }
    if constexpr (QUANT) {
      const int r = lane % DEC_CHUNK;
      const int64_t n = n0 + min(r, rows_valid - 1);
      const float* src = lane < DEC_CHUNK ? ks_g + n * p.ks_sn : vs_g + n * p.vs_sn;
      cp_async_4(st + 2 * S::RAW + lane * 4, src, r < rows_valid ? 4 : 0);
    }
  };

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // (m, l) of rows g and g + 8 in log2 units; l is this thread's partial sum
  // over its columns (reduced over the quad at the end).
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};
  // ldmatrix.trans lane -> (row, col) of the 16x16 V block it addresses.
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

#pragma unroll
  for (int s = 0; s < DEC_STAGES - 1; ++s) {
    if (s < my_chunks) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < my_chunks; ++i) {
    if (i + DEC_STAGES - 1 < my_chunks) issue(i + DEC_STAGES - 1);
    cp_async_commit();
    const int n0 = n_lo + (cg + i * groups) * DEC_CHUNK;
    // The bias of this chunk, read while its copies land.
    float bv[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        bv[nt][e] = (BIAS && bias_row[e >> 1] != nullptr && col < n_hi)
                        ? __ldg(bias_row[e >> 1] + col)
                        : 0.f;
      }
    }
    cp_async_wait<DEC_STAGES - 1>();
    __syncwarp();
    const unsigned char* st = ring + (i % DEC_STAGES) * S::STAGE;
    const __nv_bfloat16* kc;
    const __nv_bfloat16* vc;
    const float* s_ks = reinterpret_cast<const float*>(st + 2 * S::RAW);
    const float* s_vs = s_ks + DEC_CHUNK;
    if constexpr (QUANT) {
      // Widen the raw chunk to bf16, unscaled: 16 raw bytes -> 16 bf16.
#pragma unroll
      for (int j = 0; j < 2 * DEC_CHUNK * PIECES / 32; ++j) {
        const int idx = lane + 32 * j;
        const int which = idx / (DEC_CHUNK * PIECES);  // 0: K, 1: V
        const int r = idx / PIECES % DEC_CHUNK;
        const int c = idx % PIECES;
        const uint4 raw = *reinterpret_cast<const uint4*>(st + which * S::RAW + r * S::RS + c * 16);
        __nv_bfloat16* dst = wide + which * DEC_CHUNK * WS + r * WS + c * 16;
        const uint2 w0 = widen4<KV>(raw.x), w1 = widen4<KV>(raw.y);
        const uint2 w2 = widen4<KV>(raw.z), w3 = widen4<KV>(raw.w);
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(w0.x, w0.y, w1.x, w1.y);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(w2.x, w2.y, w3.x, w3.y);
      }
      __syncwarp();
      kc = wide;
      vc = wide + DEC_CHUNK * WS;
    } else {
      kc = reinterpret_cast<const __nv_bfloat16*>(st);
      vc = reinterpret_cast<const __nv_bfloat16*>(st + S::RAW);
    }

    // S = Q K^T for 16 rows x this chunk's 16 keys.
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* kr = kc + (nt * 8 + g) * WS + ks * 16 + 2 * t;
        const uint32_t kb0 = ld_b32(kr), kb1 = ld_b32(kr + 8);
#pragma unroll
        for (int pc = QPC - 1; pc >= 0; --pc) {  // decode f32 S pieces
          mma_bf16_16816(s[nt], qa[pc][ks], kb0, kb1);
        }
      }
    }
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1);
        const int col = n0 + cl;
        float x;
        if constexpr (CAP) {
          x = p.cap_log2 * tanhf(s[nt][e] * p.cap_scale);
        } else {
          x = QUANT ? s[nt][e] * s_ks[cl] * p.scale_log2 : s[nt][e] * p.scale_log2;
        }
        if (BIAS && bias_row[e >> 1] != nullptr && col < n_hi) {
          // Floored at the mask value, as in fwd_sm90_tile.cuh.
          x = fmaxf(x + bv[nt][e] * LOG2E, MASK_VALUE);
        }
        if (col >= n_hi) x = MASK_VALUE;
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
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_i[e >> 1]);
        l_i[e >> 1] += pe;
        // Quantized V: P diag(v_scale) V, the scale on P before its bf16 rounding.
        s[nt][e] = QUANT ? pe * s_vs[nt * 8 + 2 * t + (e & 1)] : pe;
      }
    }
#pragma unroll
    for (int i2 = 0; i2 < NT_O; ++i2) {
      acc[i2][0] *= alpha[0];
      acc[i2][1] *= alpha[0];
      acc[i2][2] *= alpha[1];
      acc[i2][3] *= alpha[1];
    }
    // O += P V: the two score n-tiles are the A fragment of one k-step
    // (F32Q: of each of P's three bf16 pieces).
    uint32_t pa[QPC][4];
    if constexpr (F32Q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t w[3];
        // decode f32 P pieces
        split3_pair(s[i >> 1][2 * (i & 1)], s[i >> 1][2 * (i & 1) + 1], w);
#pragma unroll
        for (int pc = 0; pc < 3; ++pc) pa[pc][i] = w[pc];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[0][i] = pack_bf16(s[i >> 1][2 * (i & 1)], s[i >> 1][2 * (i & 1) + 1]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vc + v_row * WS + dt * 16 + v_col);
#pragma unroll
      for (int pc = QPC - 1; pc >= 0; --pc) {
        mma_bf16_16816(acc[2 * dt], pa[pc], vb[0], vb[1]);
        mma_bf16_16816(acc[2 * dt + 1], pa[pc], vb[2], vb[3]);
      }
    }
    __syncwarp();  // this stage is consumed before the next issue refills it
  }
  cp_async_wait<0>();

  // Merge the warps of each Q tile: each stores (acc, m, l) of its 16 rows.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
  __syncthreads();  // every warp is done with its ring
  float* mrg = reinterpret_cast<float*>(smem) + warp * 16 * (D + 2);
#pragma unroll
  for (int nt = 0; nt < NT_O; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(mrg + g * D + col) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(mrg + (g + 8) * D + col) = make_float2(acc[nt][2], acc[nt][3]);
  }
  if (t == 0) {
    mrg[16 * D + g] = m_i[0];
    mrg[16 * D + g + 8] = m_i[1];
    mrg[16 * D + 16 + g] = l_i[0];
    mrg[16 * D + 16 + g + 8] = l_i[1];
  }
  __syncthreads();

  const float* base = reinterpret_cast<const float*>(smem);
  const int64_t part_row0 = ((static_cast<int64_t>(b) * p.hkv + hk) * p.splits + split) * p.rows;
  for (int idx = threadIdx.x; idx < p.rows * D; idx += DEC_THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    const int tile = r / 16;
    const int rr = r % 16;
    // The warps of this row's tile: tile, tile + n_mt, ...
    float m_max = -INFINITY;
    for (int w = tile; w < DEC_WARPS; w += n_mt) {
      m_max = fmaxf(m_max, base[w * 16 * (D + 2) + 16 * D + rr]);
    }
    float l = 0.f, a = 0.f;
    if (m_max != -INFINITY) {  // -inf: no warp saw a key (an empty split)
      for (int w = tile; w < DEC_WARPS; w += n_mt) {
        const float* wm = base + w * 16 * (D + 2);
        const float sc = exp2f(wm[16 * D + rr] - m_max);
        l += wm[16 * D + 16 + rr] * sc;
        a += wm[rr * D + d] * sc;
      }
    }
    if (p.splits == 1) {
      const bool dead = !(m_max > MASK_VALUE * 0.5f);
      const int h = hk * p.rep + r / p.nq;
      const int i = r % p.nq;
      const float l_safe = l == 0.f ? 1.f : l;
      const int64_t o_at = b * p.o_sb + h * p.o_sh + i * p.o_sn + d;
      if constexpr (F32Q) {
        static_cast<float*>(p.o)[o_at] = dead ? 0.f : a / l_safe;
      } else {
        static_cast<__nv_bfloat16*>(p.o)[o_at] = __float2bfloat16(dead ? 0.f : a / l_safe);
      }
      if (d == 0) {
        p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + i] =
            dead ? LN2 * MASK_VALUE : m_max * LN2 + logf(l_safe);
      }
    } else {
      p.part_acc[(part_row0 + r) * D + d] = a;
      if (d == 0) {
        p.part_ml[(part_row0 + r) * 2] = m_max;
        p.part_ml[(part_row0 + r) * 2 + 1] = l;
      }
    }
  }
}

template <int D, int KV, bool BIAS, bool CAP, bool F32Q>
cudaError_t decode_launch_d(const DecodeParams& p, int batch, cudaStream_t stream) {
  using S = DecSmem<D, KV>;
  auto kernel = decode_kernel<D, KV, BIAS, CAP, F32Q>;
  const cudaError_t e = allow_smem(kernel, S::BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.splits, p.hkv, batch);
  kernel<<<grid, DEC_THREADS, S::BYTES, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  return decode_merge(p, batch, stream);
}

// One instantiation per head dim (64 or 128; the wrapper routes no other).
template <int KV, bool BIAS, bool CAP, bool F32Q = false>
cudaError_t decode_launch(const DecodeParams& p, int batch, cudaStream_t s) {
  return p.d == 64 ? decode_launch_d<64, KV, BIAS, CAP, F32Q>(p, batch, s)
                   : decode_launch_d<128, KV, BIAS, CAP, F32Q>(p, batch, s);
}

}  // namespace
