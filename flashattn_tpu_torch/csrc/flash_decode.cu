// K1's decode route for Hopper (sm_90a): the split-KV decode kernel on bf16
// K/V (with or without a bias, with or without a softcap), the kernel that
// merges its splits, and the C entry of every decode variant.
//
// The kernel body, what it replaces (flashattn_tpu/ops/flash_fwd.py::
// _fwd_kernel on the calls that decoding makes), what bounds it (bytes: 0.080
// ms for bf16 K/V at the LM's decode shape, 0.041 ms for int8 / fp8) and how
// the design addresses that are in decode_tile.cuh. flash_decode_quant.cu
// instantiates the int8 / e4m3 K/V variants and flash_decode_quant_f32.cu
// their f32-q form (C entry fa_decode_f32), each compiled by its own nvcc.

#include "decode_tile.cuh"

namespace {

// Merge the splits' unnormalized f32 partials of one (KV head, batch) in LSE
// space: a partial whose max is at most half the mask value (every key of its
// split masked) is dropped, as K7's epilogue drops a dead step; a row with no
// live partial is dead (O = 0, LSE = ln2 * mask).
__global__ void __launch_bounds__(DEC_THREADS) decode_merge_kernel(const DecodeParams p) {
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t row0 = (static_cast<int64_t>(b) * p.hkv + hk) * p.splits * p.rows;
  for (int idx = threadIdx.x; idx < p.rows * p.d; idx += DEC_THREADS) {
    const int r = idx / p.d;
    const int d = idx % p.d;
    float m_max = -INFINITY;
    for (int s = 0; s < p.splits; ++s) {
      const float m = p.part_ml[(row0 + static_cast<int64_t>(s) * p.rows + r) * 2];
      if (m > MASK_VALUE * 0.5f) m_max = fmaxf(m_max, m);
    }
    const bool dead = m_max == -INFINITY;
    float l = 0.f, a = 0.f;
    if (!dead) {
      for (int s = 0; s < p.splits; ++s) {
        const int64_t pr = row0 + static_cast<int64_t>(s) * p.rows + r;
        const float m = p.part_ml[pr * 2];
        if (m > MASK_VALUE * 0.5f) {
          const float sc = exp2f(m - m_max);
          l += p.part_ml[pr * 2 + 1] * sc;
          a += p.part_acc[pr * p.d + d] * sc;
        }
      }
    }
    const int h = hk * p.rep + r / p.nq;
    const int i = r % p.nq;
    const int64_t o_at = b * p.o_sb + h * p.o_sh + i * p.o_sn + d;
    if (p.f32) {
      static_cast<float*>(p.o)[o_at] = dead ? 0.f : a / l;
    } else {
      static_cast<__nv_bfloat16*>(p.o)[o_at] = __float2bfloat16(dead ? 0.f : a / l);
    }
    if (d == 0) {
      p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.nq + i] =
          dead ? LN2 * MASK_VALUE : m_max * LN2 + logf(l);
    }
  }
}

}  // namespace

cudaError_t fa::decode_merge(const DecodeParams& p, int batch, cudaStream_t stream) {
  decode_merge_kernel<<<dim3(p.hkv, batch), DEC_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t fa::decode_bf16(const DecodeParams& p, int batch, cudaStream_t stream) {
  const bool bias = p.bias != nullptr;
  if (p.cap_log2 > 0.f) {
    return bias ? decode_launch<KV_BF16, true, true>(p, batch, stream)
                : decode_launch<KV_BF16, false, true>(p, batch, stream);
  }
  return bias ? decode_launch<KV_BF16, true, false>(p, batch, stream)
              : decode_launch<KV_BF16, false, false>(p, batch, stream);
}

namespace {

// Both C entries: q and o bf16, or (f32) f32 over int8 / e4m3 K/V.
int decode_entry(bool f32, const void* q, const void* k, const void* v, void* o, void* lse,
                 const void* bias, const void* k_scale, const void* v_scale, void* part_acc,
                 void* part_ml, int kv_dtype, int batch, int hq, int hkv, int nq, int d,
                 int kv_valid_len, int splits, int split_len, float scale, float softcap,
                 int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh,
                 int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb,
                 int64_t o_sh, int64_t o_sn, int64_t bias_sb, int64_t bias_sh, int64_t bias_sn,
                 int64_t ks_sb, int64_t ks_sh, int64_t ks_sn, int64_t vs_sb, int64_t vs_sh,
                 int64_t vs_sn, void* stream) {
  const bool quant = kv_dtype != fa::KV_BF16;
  const int rows = hkv > 0 && hq % hkv == 0 ? hq / hkv * nq : 0;
  const bool splits_ok =
      split_len > 0 && split_len % 64 == 0 && splits >= 1 && splits <= 65535 &&
      (kv_valid_len == 0 ? splits == 1
                         : static_cast<int64_t>(splits - 1) * split_len < kv_valid_len &&
                               static_cast<int64_t>(splits) * split_len >= kv_valid_len);
  if ((d != 64 && d != 128) || rows < 1 || rows > 32 || kv_valid_len < 0 || !splits_ok ||
      batch < 1 || batch > 65535 || hkv > 65535 ||
      (kv_dtype != fa::KV_BF16 && kv_dtype != fa::KV_INT8 &&
       kv_dtype != fa::KV_FP8) ||
      quant != (k_scale != nullptr) || quant != (v_scale != nullptr) || softcap < 0.f ||
      (softcap > 0.f && quant) || (f32 && !quant) ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fa::DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.bias = static_cast<const float*>(bias);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
  p.ks_sb = ks_sb; p.ks_sh = ks_sh; p.ks_sn = ks_sn;
  p.vs_sb = vs_sb; p.vs_sh = vs_sh; p.vs_sn = vs_sn;
  p.hq = hq;
  p.hkv = hkv;
  p.rep = hq / hkv;
  p.nq = nq;
  p.rows = rows;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  p.splits = splits;
  p.split_len = split_len;
  p.scale_log2 = scale * fa::LOG2E;
  p.cap_scale = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_log2 = softcap * fa::LOG2E;
  p.f32 = f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = f32     ? fa::decode_quant_f32(p, batch, kv_dtype, s)
                        : quant ? fa::decode_quant(p, batch, kv_dtype, s)
                                : fa::decode_bf16(p, batch, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// O and LSE of K1's decode route for q [B, Hq, Nq, D] bf16 and k/v [B, Hkv,
// Nk, D] of kv_dtype (fa::KV_BF16, KV_INT8 or KV_FP8; unit stride
// on D, other strides in elements, rows and base 16-byte aligned); o has q's
// shape, lse is [B, Hq, Nq] f32 contiguous.
//   bias: f32 [B|1, Hq|1, Nq|1, Nk] with unit column stride and the given
//     (batch, head, row) strides, 0 on broadcast dims (null: no bias).
//   k_scale / v_scale: f32 per-token scales [B, Hkv, Nk] with the given
//     strides; required for int8 / fp8 K/V, null for bf16.
//   part_acc [B, Hkv, splits, rows, D] / part_ml [B, Hkv, splits, rows, 2]:
//     f32 scratch for the splits' partials (unused, may be null, when
//     splits == 1), rows = (Hq / Hkv) * Nq.
// Keys [s * split_len, min((s + 1) * split_len, kv_valid_len)) form split s;
// requires D of 64 or 128, rows <= 32, 1 <= splits <= 65535 with every split
// non-empty (or kv_valid_len == 0 and one split), split_len % 64 == 0.
// softcap > 0 caps the scaled scores at softcap * tanh(s / softcap) (bf16 K/V
// only; 0: no cap). Launches the decode kernel, then, when splits > 1, the
// merge kernel. Returns a cudaError_t (0 on success).
int fa_decode(const void* q, const void* k, const void* v, void* o, void* lse, const void* bias,
              const void* k_scale, const void* v_scale, void* part_acc, void* part_ml,
              int kv_dtype, int batch, int hq, int hkv, int nq, int d, int kv_valid_len,
              int splits, int split_len, float scale, float softcap,
              int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
              int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
              int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, int64_t ks_sb, int64_t ks_sh,
              int64_t ks_sn, int64_t vs_sb, int64_t vs_sh, int64_t vs_sn, void* stream) {
  return decode_entry(false, q, k, v, o, lse, bias, k_scale, v_scale, part_acc, part_ml,
                      kv_dtype, batch, hq, hkv, nq, d, kv_valid_len, splits, split_len, scale,
                      softcap, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh,
                      o_sn, bias_sb, bias_sh, bias_sn, ks_sb, ks_sh, ks_sn, vs_sb, vs_sh, vs_sn,
                      stream);
}

// The same for an f32 q and o (K1's decode route's f32-q form, F32Q in
// decode_tile.cuh) over int8 / e4m3 K/V (kv_dtype KV_INT8 or KV_FP8; bf16
// K/V return cudaErrorInvalidValue: an f32 q over them is K1's f32 route);
// q's strides even (8-byte pairs), o f32 with q's shape. The other
// arguments and the launches as fa_decode's.
int fa_decode_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                  const void* bias, const void* k_scale, const void* v_scale, void* part_acc,
                  void* part_ml, int kv_dtype, int batch, int hq, int hkv, int nq, int d,
                  int kv_valid_len, int splits, int split_len, float scale, float softcap,
                  int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh,
                  int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb,
                  int64_t o_sh, int64_t o_sn, int64_t bias_sb, int64_t bias_sh, int64_t bias_sn,
                  int64_t ks_sb, int64_t ks_sh, int64_t ks_sn, int64_t vs_sb, int64_t vs_sh,
                  int64_t vs_sn, void* stream) {
  return decode_entry(true, q, k, v, o, lse, bias, k_scale, v_scale, part_acc, part_ml,
                      kv_dtype, batch, hq, hkv, nq, d, kv_valid_len, splits, split_len, scale,
                      softcap, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn, o_sb, o_sh,
                      o_sn, bias_sb, bias_sh, bias_sn, ks_sb, ks_sh, ks_sn, vs_sb, vs_sh, vs_sn,
                      stream);
}

}  // extern "C"
