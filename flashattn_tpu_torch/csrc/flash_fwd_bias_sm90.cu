// K1's bias route for Hopper (sm_90a): the C entry fa_fwd_bias_sm90 and the
// twelve instantiations (D 64, 128 and 256, without and with segment ids,
// without and with the logit softcap) of fwd_sm90_tile.cuh's body with the
// bias, as fwd_bias_sm90_kernel<D, SEG, CAP>; every D <= 256 that is a
// multiple of 8 runs in the D 64, 128 or 256 one, its TMA boxes reading
// zeros past D. Below D 256 the bias streams through each stage by cp.async;
// at D 256 it has one slot of its own, filled by TMA from the bias map (the
// kernel's fourth tensor map, unused below). The band (causal, a window, q /
// kv offsets) is runtime ints, as in the dense route (flash_fwd_sm90.cu),
// whose argument list this entry's extends by the bias. What it replaces,
// what bounds it and its design are in fwd_sm90_tile.cuh; the route
// (ops/flash_fwd.py::bias_route) is decided in Python, and the other K1 calls
// with a bias go to the decode kernel (decode_tile.cuh) or, on quantized K/V,
// to fwd_tile.cuh (fa_fwd, flash_fwd.cu).

#include "fwd_sm90_tile.cuh"

namespace {

template <int D, bool SEG, bool CAP>
__global__ void __launch_bounds__(FB_THREADS, 1)
    fwd_bias_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_bias, const FwdBiasParams p) {
  fwd_sm90_body<D, true, SEG, CAP>(tm_q, tm_k, tm_v, p, &tm_bias);
}

template <int D, bool SEG, bool CAP>
cudaError_t fwd_bias_sm90_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                 const CUtensorMap& tm_v, const CUtensorMap& tm_bias,
                                 const FwdBiasParams& p, int batch, cudaStream_t stream) {
  auto kernel = fwd_bias_sm90_kernel<D, SEG, CAP>;
  constexpr int smem = FbSmem<D>::BYTES;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nq + FB_BLOCK_M - 1) / FB_BLOCK_M, batch);  // the head fastest
  kernel<<<grid, FB_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_bias, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd_bias_sm90_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                   const CUtensorMap& tm_v, const CUtensorMap& tm_bias,
                                   const FwdBiasParams& p, bool cap, int batch,
                                   cudaStream_t s) {
  const bool seg = p.seg_q != nullptr;
  return cap ? (seg ? fwd_bias_sm90_launch<D, true, true>(tm_q, tm_k, tm_v, tm_bias, p, batch, s)
                    : fwd_bias_sm90_launch<D, false, true>(tm_q, tm_k, tm_v, tm_bias, p, batch,
                                                           s))
             : (seg ? fwd_bias_sm90_launch<D, true, false>(tm_q, tm_k, tm_v, tm_bias, p, batch,
                                                           s)
                    : fwd_bias_sm90_launch<D, false, false>(tm_q, tm_k, tm_v, tm_bias, p, batch,
                                                            s));
}

}  // namespace

extern "C" {

// O and LSE for q [B, Hq, Nq, D] and k/v [B, Hkv, Nk, D] bf16 (unit stride on
// D, other strides in elements) with an additive f32 bias [B|1, Hq|1, Nq|1,
// Nk] (unit column stride, (batch, head, row) strides in elements, 0 on
// broadcast dims); o has q's shape, lse is [B, Hq, Nq] f32 contiguous. The
// other arguments are fa_fwd_sm90's (flash_fwd_sm90.cu), with their meaning:
// causal, the window (wl, wr) and the offsets (q_off, kv_off) in absolute
// positions, the segment ids (seg_q, seg_kv, q_range, kv_range at 128-row Q
// tiles and 64-key KV tiles: all four or none), the softcap (> 0 caps the
// scaled scores at softcap * tanh(s / softcap) before the bias is added, 0
// none); a row that sees no key, or whose every score is at the mask value,
// is dead (O = 0, LSE = ln2 * mask). Requires 8 <= D <= 256 with D % 8 == 0,
// Hq % Hkv == 0, 1 <= Nq, 0 <= kv_valid_len <= Nk, B <= 65535; q, k, v and
// bias 16-byte aligned, q / k / v strides multiples of 8 elements and the
// bias's of 4 (16-byte bias rows), o 4-byte aligned with even strides,
// seg_kv 16-byte aligned. Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or refuses a
// tensor map).
int fa_fwd_bias_sm90(const void* q, const void* k, const void* v, void* o, void* lse,
                     const void* bias, const void* seg_q, const void* seg_kv,
                     const void* q_range, const void* kv_range, int batch, int hq, int hkv,
                     int nq, int d, int kv_valid_len, int causal, int wl, int wr, int q_off,
                     int kv_off, float scale, float softcap, int64_t q_sb, int64_t q_sh,
                     int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                     int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
                     int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, int64_t seg_q_sb,
                     void* stream) {
  // The K/V maps' sequence extent (at least 1: a map has no empty dim; with
  // kv_valid_len 0 no KV tile is loaded).
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  const bool seg = seg_q != nullptr;
  if (d < 8 || d > 256 || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || (nq + FB_BLOCK_M - 1) / FB_BLOCK_M > 65535 ||
      kv_valid_len < 0 || !(softcap >= 0.f) || bias == nullptr || !aligned(q, 16) ||
      !aligned(k, 16) ||
      !aligned(v, 16) || !aligned(bias, 16) || !aligned(o, 4) ||
      !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(k_sb, batch, k_sh, hkv, k_sn, nkv) ||
      !tma_strides(v_sb, batch, v_sh, hkv, v_sn, nkv) || bias_sb % 4 || bias_sh % 4 ||
      bias_sn % 4 || o_sb % 2 || o_sh % 2 || o_sn % 2 || seg != (seg_kv != nullptr) ||
      seg != (q_range != nullptr) || seg != (kv_range != nullptr) ||
      (seg && !aligned(seg_kv, 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_bias = {};  // D 256's bias slot (FbSmem::SLOT) only
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, FB_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nkv, d, k_sb, k_sh, k_sn, FB_BLOCK_N) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nkv, d, v_sb, v_sh, v_sn, FB_BLOCK_N) ||
      (d > 128 && !make_bias_map(&tm_bias, bias, batch, hq, nq, nkv, bias_sb, bias_sh, bias_sn,
                                 bias_sn ? FB_BLOCK_M : 1))) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  fa::FwdBiasParams p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.bias = static_cast<const float*>(bias);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
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
  const bool cap = softcap > 0.f;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * fa::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      d <= 64    ? fwd_bias_sm90_dispatch<64>(tm_q, tm_k, tm_v, tm_bias, p, cap, batch, s)
      : d <= 128 ? fwd_bias_sm90_dispatch<128>(tm_q, tm_k, tm_v, tm_bias, p, cap, batch, s)
                 : fwd_bias_sm90_dispatch<256>(tm_q, tm_k, tm_v, tm_bias, p, cap, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
