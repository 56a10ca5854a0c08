// K5 + K6 without a bias for Hopper (sm_90a): bwd_sm90_tile.cuh's TMA + wgmma
// body without the bias stage, with segment ids (SEG) and / or the logit
// softcap (CAP), as bwd_split_sm90_kernel (D 64 and 128; every D <= 128 that
// is a multiple of 8 by the TMA boxes' zero fill), its D 256 form on
// bwd_sm90_wide.cuh's body (bwd_split_sm90_kernel<256, SEG, CAP>: 64 keys a
// CTA, the two consumers splitting D; every D 136-256 by the zero fill), and
// the C entry fa_bwd_split_sm90.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5,
// :139) and _dq_kernel (K6, :234), the pair that the JAX package's
// _flash_core_bwd runs whenever its fused kernel cannot (flash.py:773): with
// segment ids or a softcap, with or without causal, a window, GQA, a KV tail
// or a ragged Q tail. The TPU pair recomputes P twice, once per kernel, so
// that each can keep its output in VMEM over a sequential grid (dK / dV per
// KV tile, dQ per Q tile): 7 products per tile pair. One launch here does the
// 5 of K3 (dV = P^T dO, dP^T, dK = dS^T Q, S^T, dQ = dS K): each KV-major CTA
// adds its dQ tile into a zeroed f32 dQ by one bulk reduction, so dQ is no
// longer written once and its sums are not bitwise deterministic. The
// formulas, the masks and the design are in bwd_sm90_tile.cuh; the window
// stays runtime ints (lo, hi), as in K3, and only the options are template
// parameters, in a source of their own so that nvcc builds it beside K3's,
// whose instantiations stay as they are.
//
// What bounds it: at the packed LM's attention (B2 Hq16 Hkv8 N4096 D128, 8
// documents per row, causal) the five products over the ~33.6 M attended
// pairs are 43 GFLOP, 0.044 ms at 989 TFLOP/s: operations, as K3 at the LM;
// K5 + K6 on mma.sync (dkv_tile.cuh / dq_tile.cuh: synchronous loads between
// block barriers, 7 products) took 1.12-1.15 ms there. With the softcap one
// accurate tanhf per attended pair (~20 instructions on the FMA and MUFU
// pipes) sits beside the products.

#include "bwd_sm90_wide.cuh"

namespace {

template <int D, bool SEG, bool CAP>
__global__ void __launch_bounds__(BB_THREADS, 1)
    bwd_split_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const BwdSplitParams p) {
  if constexpr (D == BW_D) {
    bwd_wide_body<SEG, CAP>(tm_q, tm_k, tm_v, tm_do, p);
  } else {
    bwd_sm90_body<D, false, false, SEG, CAP>(tm_q, tm_k, tm_v, tm_do, nullptr, p);
  }
}

template <int D, bool SEG, bool CAP>
cudaError_t split_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
                         const CUtensorMap& tm_do, const BwdSplitParams& p, int batch,
                         cudaStream_t stream) {
  auto kernel = bwd_split_sm90_kernel<D, SEG, CAP>;
  constexpr int smem = bwd_smem_bytes<D, SEG>();
  constexpr int block_n = bwd_block_n(D);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nk + block_n - 1) / block_n, batch);
  kernel<<<grid, BB_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t split_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                           const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                           const BwdSplitParams& p, bool seg, bool cap, int batch,
                           cudaStream_t stream) {
  if (seg && cap) return split_launch<D, true, true>(tm_q, tm_k, tm_v, tm_do, p, batch, stream);
  if (seg) return split_launch<D, true, false>(tm_q, tm_k, tm_v, tm_do, p, batch, stream);
  return split_launch<D, false, true>(tm_q, tm_k, tm_v, tm_do, p, batch, stream);
}

}  // namespace

extern "C" {

// K5 + K6 without a bias: dQ, dK, dV of attention with segment ids and / or a
// logit softcap. The arguments of K3's fa_bwd_sm90 (flash_bwd_sm90.cu) --
// q / dout [B, Hq, Nq, D] and k / v [B, Hkv, Nk, D] bf16 with TMA's strides,
// lse / delta [B, Hq, nq_pad] f32, dq zeroed and added to, dk / dv per query
// head, causal, the window (wl, wr) and the offsets (q_off, kv_off) -- and:
//   seg_q [B, q_tiles * 64] and seg_kv [B, kv_tiles * 128] int32 contiguous,
//     16-byte aligned: the ids of the rows below Nq and of the keys below
//     kv_valid_len, each row padded to whole tiles (the padding is never
//     compared);
//   q_range [B, q_tiles] and kv_range [B, kv_tiles] int32 pairs (min, max),
//     contiguous: the id range of each 64-row Q tile's rows below Nq and of
//     each 128-key tile's keys below kv_valid_len,
// with q_tiles = ceil(Nq / 64) <= 4096 and kv_tiles = ceil(kv_valid_len /
// 128) at every head dim (the D 256 form's 64-key CTAs read their 128-key
// tile's range): all four pointers or none (pair (i, j) attends iff seg_q[i] ==
// seg_kv[j]); softcap > 0 the forward's logit cap, 0 none. At least one of
// the two: the call with neither is K3's. Returns a cudaError_t (0: success;
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or refuses a
// tensor map).
int fa_bwd_split_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,
                      const void* seg_q, const void* seg_kv, const void* q_range,
                      const void* kv_range, int batch, int hq, int hkv, int nq, int nk, int d,
                      int kv_valid_len, int causal, int wl, int wr, int q_off, int kv_off,
                      int nq_pad, float scale, float softcap, int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb,
                      int64_t k_sh, int64_t k_sn, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                      int64_t do_sb, int64_t do_sh, int64_t do_sn, void* stream) {
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  const bool seg = seg_q != nullptr;
  const bool cap = softcap > 0.f;
  const int q_tiles = (nq + BB_BLOCK_M - 1) / BB_BLOCK_M;
  const int box_d = bwd_box_d(d);
  const int kv_rows = bwd_block_n(box_d);  // keys a CTA (the K / V boxes' rows)
  if (d < 8 || d > BW_D || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || nk < 1 || (nk + kv_rows - 1) / kv_rows > 65535 ||
      kv_valid_len < 0 || kv_valid_len > nk || nq_pad < nq || nq_pad % BB_BLOCK_M ||
      !(softcap >= 0.f) || (!seg && !cap) || seg != (seg_kv != nullptr) ||
      seg != (q_range != nullptr) || seg != (kv_range != nullptr) ||
      (seg && (q_tiles > BB_SEG_LIST || !aligned(seg_q, 16) || !aligned(seg_kv, 16) ||
               !aligned(q_range, 8) || !aligned(kv_range, 8))) ||
      !aligned(q, 16) || !aligned(k, 16) || !aligned(v, 16) || !aligned(dout, 16) ||
      !aligned(lse, 16) || !aligned(delta, 16) || !aligned(dq, 16) || !aligned(dk, 8) ||
      !aligned(dv, 8) || !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
      !tma_strides(k_sb, batch, k_sh, hkv, k_sn, nkv) ||
      !tma_strides(v_sb, batch, v_sh, hkv, v_sn, nkv) ||
      !tma_strides(do_sb, batch, do_sh, hq, do_sn, nq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  alignas(64) CUtensorMap tm_q;
  alignas(64) CUtensorMap tm_k;
  alignas(64) CUtensorMap tm_v;
  alignas(64) CUtensorMap tm_do;
  if (!make_bhnd_map(&tm_q, q, batch, hq, nq, d, q_sb, q_sh, q_sn, BB_BLOCK_M) ||
      !make_bhnd_map(&tm_k, k, batch, hkv, nkv, d, k_sb, k_sh, k_sn, kv_rows) ||
      !make_bhnd_map(&tm_v, v, batch, hkv, nkv, d, v_sb, v_sh, v_sn, kv_rows) ||
      !make_bhnd_map(&tm_do, dout, batch, hq, nq, d, do_sb, do_sh, do_sn, BB_BLOCK_M)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  BwdSplitParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.nq_pad = nq_pad;
  p.nk = nk;
  p.kv_valid_len = kv_valid_len;
  p.d = d;
  band_bounds(causal, wl, wr, &p.lo, &p.hi,
              static_cast<int64_t>(q_off) - kv_off);
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_kv = static_cast<const int*>(seg_kv);
  p.q_range = static_cast<const int2*>(q_range);
  p.kv_range = static_cast<const int2*>(kv_range);
  p.q_tiles = q_tiles;
  p.kv_tiles = (kv_valid_len + BB_BLOCK_N - 1) / BB_BLOCK_N;
  p.cap_scale = cap ? scale / softcap : 0.f;
  p.cap_log2 = softcap * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      box_d == 64    ? split_dispatch<64>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, batch, s)
      : box_d == 128 ? split_dispatch<128>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, batch, s)
                     : split_dispatch<BW_D>(tm_q, tm_k, tm_v, tm_do, p, seg, cap, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
