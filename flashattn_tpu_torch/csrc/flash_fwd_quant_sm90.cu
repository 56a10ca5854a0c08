// K1's quantized route for Hopper (sm_90a): the C entry fa_fwd_quant_sm90
// and the 24 instantiations (D 64, 128 and 256, int8 and e4m3 K/V, without
// and with a bias, without and with segment ids) of fwd_sm90_tile.cuh's
// quantized body, fwd_quant_sm90_kernel<D, KV, BIAS, SEG>; every D <= 256 that
// is a multiple of 8 runs in the D 64, 128 or 256 one, its TMA boxes reading
// zeros past D.
//
// Replaces, for int8 / fp8 K/V with per-token f32 scales, the TPU kernel
// flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1, :115; the scales at
// :304-309 and :342-345, reached through fwd_padded :1017-1030 and
// flashattn_tpu/ops/quant.py::flash_attention_quantized) and, with causal or
// a window, the banded K2 (:516). It computes what they compute: K_q and V_q
// widened unscaled to bf16 (int8 -> bf16 and e4m3 -> bf16 are exact), Q in
// bf16, k_scale[col] on the f32 score column (with the softmax scale, one
// multiply), v_scale[col] on P after the row sum and before P's bf16 rounding -- the
// scales never folded into K / V, no fp8 or int8 product on a requantized Q
// or P (those would compute other numbers) -- with the dense route's options:
// the KV tail, a ragged Nq, the band (causal, a window, q / kv offsets),
// segment ids, GQA, strided views and an additive f32 bias [B|1, Hq|1, Nq|1,
// Nk]. There is no softcap: the JAX package has none with quantized K/V.
//
// What bounds it: at the LM's prefill (B1 Hq16 Hkv8 N2048 D128 causal) the
// two bf16 products are 17.2 GFLOP, 0.0174 ms at 989 TFLOP/s; the 8-bit K/V
// are half the bf16 bytes. fwd_tile.cuh (mma.sync, deleted with this route)
// ran it at ~60 TFLOP/s: 16 rows per warp, synchronous loads between two
// block barriers, K/V widened in the same barrier-bound loop. This design is
// the dense route's (TMA + wgmma, 128 Q rows a CTA, two consumer
// warpgroups) with the widening in its producer warpgroup: thread 0 keeps a
// ring of 8-bit tiles filled by TMA (half the bytes of a bf16 stage, so the
// ring runs ahead of the bf16 stages), and all 128 producer threads widen
// each tile into a bf16 stage in the swizzled layout the consumers' wgmma
// descriptors read -- the pattern of FlashAttention-3's fp8 forward, whose
// producer rewrites V in shared memory -- then fence.proxy.async and arrive
// on the stage's full barrier. The producer threads store the tile's scales
// beside it, read through the scales' own strides (the k scales times scale
// * log2 e, so that a score takes one multiply), and the ids come by a bulk
// copy on the same barrier; a bias is
// read from L2 by each consumer thread into its scores' layout (no room for
// a bias stage beside the two rings at D 128 and 256). The route (ops/flash_fwd.py::quant_route) is decided in Python;
// decode-shaped quantized calls at D 64 / 128 take the decode kernel.
//
// The same C code serves an f32 q (fa_fwd_quant_f32, whose 24 instantiations
// of the body's F32Q form are in flash_fwd_quant_f32.cu): it splits q alone
// into three bf16 pieces (split_bf16x3.cu) -- never K / V, whose 8-bit values
// widen exactly to bf16, so that each f32 product is three bf16 products --
// and maps the pieces in place of q.

#include "fwd_sm90_tile.cuh"
#include "split_bf16x3.cuh"

namespace {

template <int D, int KV, bool BIAS, bool SEG>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fwd_quant_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k8,
                          const __grid_constant__ CUtensorMap tm_v8, const FwdQuantParams p) {
  fwd_quant_sm90_body<D, KV, BIAS, SEG>(tm_q, tm_k8, tm_v8, p);
}

template <int D, int KV>
cudaError_t fwd_quant_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k8,
                               const CUtensorMap& tm_v8, const FwdQuantParams& p, int batch,
                               cudaStream_t s) {
  constexpr int smem = FqSmem<D>::BYTES;
  const bool bias = p.bias != nullptr, seg = p.seg_q != nullptr;
  return bias ? (seg ? fwd_sm90_launch(fwd_quant_sm90_kernel<D, KV, true, true>, smem, tm_q,
                                       tm_k8, tm_v8, p, batch, s)
                     : fwd_sm90_launch(fwd_quant_sm90_kernel<D, KV, true, false>, smem, tm_q,
                                       tm_k8, tm_v8, p, batch, s))
              : (seg ? fwd_sm90_launch(fwd_quant_sm90_kernel<D, KV, false, true>, smem, tm_q,
                                       tm_k8, tm_v8, p, batch, s)
                     : fwd_sm90_launch(fwd_quant_sm90_kernel<D, KV, false, false>, smem, tm_q,
                                       tm_k8, tm_v8, p, batch, s));
}

template <int D>
cudaError_t fwd_quant_kv(const CUtensorMap& tm_q, const CUtensorMap& tm_k8,
                         const CUtensorMap& tm_v8, const FwdQuantParams& p, int kv_dtype,
                         int batch, cudaStream_t s) {
  return kv_dtype == fa::KV_INT8
             ? fwd_quant_dispatch<D, fa::KV_INT8>(tm_q, tm_k8, tm_v8, p, batch, s)
             : fwd_quant_dispatch<D, fa::KV_FP8>(tm_q, tm_k8, tm_v8, p, batch, s);
}

// TMA's strides for an 8-bit tensor: positive multiples of 16 bytes on dims
// of extent > 1.
bool tma_strides_u8(int64_t sb, int b, int64_t sh, int h, int64_t sn, int n) {
  auto ok = [](int64_t s, int extent) { return extent == 1 || (s > 0 && s % 16 == 0); };
  return ok(sb, b) && ok(sh, h) && ok(sn, n);
}

// The argument checks, the maps and the launch of both C entries: q bf16
// (pieces null) or f32 (pieces: its bf16 scratch).
int quant_entry(const void* q, const void* k, const void* v, void* o, void* lse, void* pieces,
                const void* k_scale, const void* v_scale, const void* bias, const void* seg_q,
                const void* seg_kv, const void* q_range, const void* kv_range, int kv_dtype,
                int batch, int hq, int hkv, int nq, int d, int kv_valid_len, int causal, int wl,
                int wr, int q_off, int kv_off, float scale, int64_t q_sb, int64_t q_sh,
                int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
                int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, int64_t ks_sb,
                int64_t ks_sh, int64_t ks_sn, int64_t vs_sb, int64_t vs_sh, int64_t vs_sn,
                int64_t seg_q_sb, void* stream) {
  const bool f32q = pieces != nullptr;
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  const bool seg = seg_q != nullptr;
  const int box = d <= 64 ? 64 : d <= 128 ? 128 : 256;  // the instantiation's D
  const int cta_rows = f32q && box == 256 ? 64 : FB_BLOCK_M;  // FqSmem<D, F32Q>::BM
  const bool q_ok = f32q ? aligned(pieces, 16) && aligned(o, 8) && (o_sb | o_sh | o_sn) % 2 == 0
                         : aligned(q, 16) && tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) &&
                               aligned(o, 4) && (o_sb | o_sh | o_sn) % 2 == 0;
  if (d < 8 || d > 256 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || (nq + cta_rows - 1) / cta_rows > 65535 ||
      kv_valid_len < 0 || (kv_dtype != fa::KV_INT8 && kv_dtype != fa::KV_FP8) ||
      k_scale == nullptr || v_scale == nullptr || !aligned(k_scale, 4) ||
      !aligned(v_scale, 4) || !q_ok || !aligned(k, 16) || !aligned(v, 16) ||
      !tma_strides_u8(k_sb, batch, k_sh, hkv, k_sn, nkv) ||
      !tma_strides_u8(v_sb, batch, v_sh, hkv, v_sn, nkv) ||
      (bias != nullptr && (!aligned(bias, 16) || bias_sb % 4 || bias_sh % 4 || bias_sn % 4)) ||
      seg != (seg_kv != nullptr) || seg != (q_range != nullptr) ||
      seg != (kv_range != nullptr) || (seg && !aligned(seg_kv, 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k8;
  alignas(64) CUtensorMap tm_v8;
  bool q_map;
  if (f32q) {
    // q's pieces [3, B, Hq, Nq, box], one launch of the split (q alone).
    const fa::SplitArg split = {q, pieces, batch, hq, nq, d, q_sb, q_sh, q_sn};
    const cudaError_t e = fa::split_bf16x3(&split, 1, box, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t q_head = static_cast<int64_t>(box) * nq;
    q_map = make_bhnd_map(&tm_q, pieces, 3 * batch, hq, nq, d, q_head * hq, q_head, box,
                          cta_rows);
  } else {
    q_map = make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, FB_BLOCK_M);
  }
  if (!q_map ||
      !make_bhnd_map_u8(&tm_k8, k, batch, hkv, nkv, d, k_sb, k_sh, k_sn, box, FB_BLOCK_N) ||
      !make_bhnd_map_u8(&tm_v8, v, batch, hkv, nkv, d, v_sb, v_sh, v_sn, box, FB_BLOCK_N)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::FwdQuantParams p;
  p.o = static_cast<__nv_bfloat16*>(o);  // f32 with an f32 q (fwd_sm90_store's F32O)
  p.lse = static_cast<float*>(lse);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.seg_q_sb = seg_q_sb;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  band_bounds(causal, wl, wr, &p.lo, &p.hi, static_cast<int64_t>(q_off) - kv_off);
  p.q_tiles = (nq + FB_BLOCK_M - 1) / FB_BLOCK_M;
  p.kv_tiles = (kv_valid_len + FB_BLOCK_N - 1) / FB_BLOCK_N;
  p.scale_log2 = scale * fa::LOG2E;
  p.cap_scale = p.cap_log2 = 0.f;
  p.bias = static_cast<const float*>(bias);
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.ks_sb = ks_sb; p.ks_sh = ks_sh; p.ks_sn = ks_sn;
  p.vs_sb = vs_sb; p.vs_sh = vs_sh; p.vs_sn = vs_sn;
  if (f32q) return static_cast<int>(fa::fwd_quant_f32(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, s));
  const cudaError_t e =
      d <= 64    ? fwd_quant_kv<64>(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, s)
      : d <= 128 ? fwd_quant_kv<128>(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, s)
                 : fwd_quant_kv<256>(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// O and LSE for q [B, Hq, Nq, D] bf16 and k/v [B, Hkv, Nk, D] int8 or e4m3
// (kv_dtype fa::KV_INT8 or KV_FP8; unit stride on D, other strides in
// elements, which are bytes here); o has q's shape, lse is [B, Hq, Nq] f32
// contiguous.
//   k_scale / v_scale: f32 per-token scales [B, Hkv, Nk] with the given
//     (batch, head, seq) strides, read below kv_valid_len only;
//   bias: f32 [B|1, Hq|1, Nq|1, Nk] with unit column stride and the given
//     (batch, head, row) strides, 0 on broadcast dims, or null.
// The other arguments are fa_fwd_sm90's (flash_fwd_sm90.cu), with their
// meaning: causal, the window (wl, wr) and the offsets (q_off, kv_off) in
// absolute positions, the segment ids (seg_q, seg_kv, q_range, kv_range at
// 128-row Q tiles and 64-key KV tiles: all four or none). A row that sees no
// key, or whose every score is at the mask value, is dead (O = 0, LSE = ln2
// * mask). Requires 8 <= D <= 256 with D % 8 == 0, Hq % Hkv == 0, 1 <= Nq,
// 0 <= kv_valid_len <= Nk, B <= 65535; q 16-byte aligned with strides that
// are multiples of 8 elements, k and v 16-byte aligned with strides that are
// multiples of 16 bytes (TMA's; a D % 16 == 8 row needs a padded copy), all
// nonzero on dims of extent > 1; o 4-byte aligned with even strides; bias and
// seg_kv 16-byte aligned, the bias's strides multiples of 4. Returns
// a cudaError_t (0 on success; cudaErrorInvalidValue for arguments it does
// not take, cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or
// refuses a tensor map).
int fa_fwd_quant_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                      const void* k_scale, const void* v_scale, const void* bias,
                      const void* seg_q,
                      const void* seg_kv, const void* q_range, const void* kv_range,
                      int kv_dtype, int batch, int hq, int hkv, int nq, int d, int kv_valid_len,
                      int causal, int wl, int wr, int q_off, int kv_off, float scale,
                      int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh,
                      int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb,
                      int64_t o_sh, int64_t o_sn, int64_t bias_sb, int64_t bias_sh,
                      int64_t bias_sn, int64_t ks_sb, int64_t ks_sh, int64_t ks_sn,
                      int64_t vs_sb, int64_t vs_sh, int64_t vs_sn, int64_t seg_q_sb,
                      void* stream) {
  return quant_entry(q, k, v, o, lse, nullptr, k_scale, v_scale, bias, seg_q, seg_kv, q_range,
                     kv_range, kv_dtype, batch, hq, hkv, nq, d, kv_valid_len, causal, wl, wr,
                     q_off, kv_off, scale, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
                     o_sb, o_sh, o_sn, bias_sb, bias_sh, bias_sn, ks_sb, ks_sh, ks_sn, vs_sb,
                     vs_sh, vs_sn, seg_q_sb, stream);
}

// The same on an f32 q [B, Hq, Nq, D] (unit stride on D, other strides in
// elements, any alignment) with o [B, Hq, Nq, D] f32 (8-byte aligned, even
// strides), and after lse `pieces`: bf16 scratch of 3 DB B Hq Nq elements,
// 16-byte aligned (DB = 64 for D <= 64, 128 for D <= 128, else 256), into
// which one launch of the split (split_bf16x3.cu) writes q's three pieces
// before the kernel (the body's F32Q form: above D 128 64 Q rows a CTA; the
// id ranges stay those of 128-row tiles). K / V, the scales and every other
// argument as fa_fwd_quant_sm90's.
int fa_fwd_quant_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                     void* pieces, const void* k_scale, const void* v_scale, const void* bias,
                     const void* seg_q, const void* seg_kv, const void* q_range,
                     const void* kv_range, int kv_dtype, int batch, int hq, int hkv, int nq,
                     int d, int kv_valid_len, int causal, int wl, int wr, int q_off, int kv_off,
                     float scale, int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb,
                     int64_t k_sh, int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                     int64_t o_sb, int64_t o_sh, int64_t o_sn, int64_t bias_sb, int64_t bias_sh,
                     int64_t bias_sn, int64_t ks_sb, int64_t ks_sh, int64_t ks_sn,
                     int64_t vs_sb, int64_t vs_sh, int64_t vs_sn, int64_t seg_q_sb,
                     void* stream) {
  if (pieces == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return quant_entry(q, k, v, o, lse, pieces, k_scale, v_scale, bias, seg_q, seg_kv, q_range,
                     kv_range, kv_dtype, batch, hq, hkv, nq, d, kv_valid_len, causal, wl, wr,
                     q_off, kv_off, scale, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
                     o_sb, o_sh, o_sn, bias_sb, bias_sh, bias_sn, ks_sb, ks_sh, ks_sn, vs_sb,
                     vs_sh, vs_sn, seg_q_sb, stream);
}

}  // extern "C"
