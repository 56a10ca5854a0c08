// K3, the single-pass FlashAttention backward, for Hopper (sm_90a):
// bwd_sm90_tile.cuh's TMA + wgmma body without the bias stage, as
// bwd_sm90_kernel (D 64 and 128; every D <= 128 that is a multiple of 8 by the
// TMA boxes' zero fill), its D 256 form on bwd_sm90_wide.cuh's body
// (bwd_sm90_kernel<256>: 64 keys a CTA, the two consumers splitting D; every
// D 136-256 by the zero fill), and the C entry fa_bwd_sm90.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd_fused.py::
// _bwd_fused_kernel (K3, :110) and, with causal or a sliding window, the
// banded whole-sequence _bwd_causal_resident_kernel (K4, :336) and its
// long-sequence windowed route _bwd_macro_windowed (:651): the single-pass
// 5-product backward from the forward's row LSE and Delta = rowsum(dO * O),
// with the KV tail, a ragged Q tail, GQA, and the causal / window band of
// K1's dense route as runtime ints (lo, hi: ring_fwd.cu's band), P exactly 0
// on masked pairs, tails and dead rows (the formulas and the design are in
// bwd_sm90_tile.cuh). The TPU grid runs in order, so K3 keeps a
// whole-sequence f32 dQ in VMEM and adds into it race-free; CTAs run in
// parallel here, so each KV-major CTA adds its dQ tile into a zeroed f32 dQ
// by one bulk reduction per (Q tile, query head).
//
// What bounds it: at the LM's attention (B1 Hq16 Hkv8 N2048 D128 causal) the
// five products are 43 GFLOP, 0.043 ms at 989 TFLOP/s: operations. The
// mma.sync design this replaces (dkv_tile.cuh: 64 KV rows a CTA, 32-row Q
// steps at D 128 with synchronous loads between block barriers, dQ by one
// scalar f32 atomicAdd per element from every KV tile, dK / dV per query
// head) ran it at ~59 TFLOP/s. The grid: one CTA per (query head, KV tile
// of 128, batch), dK / dV per query head, summed over each KV head's group
// by the caller. Under causal the first KV tile meets every Q tile, so a
// grid of KV heads (LM: 8 x 16 = 128 CTAs on 132 SMs, each CTA over its KV
// head's query heads) waits about twice the average CTA's time on it; the
// grid of query heads (256 CTAs, the longest first) fills the SMs again as
// CTAs finish. chip_variants.py k3 times the KV-head grid as a patch.

#include "bwd_sm90_wide.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(BB_THREADS, 1)
    bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const BwdDenseParams p) {
  if constexpr (D == BW_D) {
    bwd_wide_body<false, false>(tm_q, tm_k, tm_v, tm_do, p);
  } else {
    bwd_sm90_body<D, false, false>(tm_q, tm_k, tm_v, tm_do, nullptr, p);
  }
}

template <int D>
cudaError_t bwd_sm90_launch(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                            const CUtensorMap& tm_v, const CUtensorMap& tm_do,
                            const BwdDenseParams& p, int batch, cudaStream_t stream) {
  auto kernel = bwd_sm90_kernel<D>;
  constexpr int smem = bwd_smem_bytes<D>();
  constexpr int block_n = bwd_block_n(D);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.hq, (p.nk + block_n - 1) / block_n, batch);
  kernel<<<grid, BB_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3: dQ, dK, dV of attention. q / dout [B, Hq, Nq, D] and k / v [B, Hkv, Nk,
// D] bf16, unit stride on D, the given (batch, head, seq) strides in elements
// (multiples of 8, nonzero on dims of extent > 1; 16-byte-aligned bases:
// TMA's); lse (natural log, from the forward) and delta [B, Hq, nq_pad] f32
// contiguous, nq_pad a multiple of 64 >= Nq (the rows past Nq are read and
// not used), 16-byte aligned; dq [B, Hq, Nq, D] f32 contiguous, zeroed (added
// to), 16-byte aligned; dk / dv [B, Hq, Nk, D] f32 contiguous, written,
// 8-byte aligned, per query head. Positions are absolute, q_pos = q_off +
// row and kv_pos = kv_off + key: causal != 0 masks kv_pos > q_pos; the
// window (wl, wr) masks kv_pos < q_pos - wl (wl >= 0) and kv_pos > q_pos + wr
// (wr >= 0), a negative bound being none. A KV tile that no row reaches
// writes zero dK / dV rows.
// Requires 8 <= D <= 256 with D % 8 == 0, Hq % Hkv == 0, Nq, Nk >= 1,
// 0 <= kv_valid_len <= Nk, B <= 65535. Returns a cudaError_t (0: success;
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorNotSupported when cuTensorMapEncodeTiled is missing or refuses a
// tensor map).
int fa_bwd_sm90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int batch, int hq, int hkv,
                int nq, int nk, int d, int kv_valid_len, int causal, int wl, int wr, int q_off,
                int kv_off, int nq_pad, float scale, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb, int64_t v_sh,
                int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn, void* stream) {
  // The K/V maps' key extent (at least 1: a map has no empty dim; with
  // kv_valid_len 0 no tile is loaded).
  const int nkv = kv_valid_len > 0 ? kv_valid_len : 1;
  const int box_d = bwd_box_d(d);
  const int kv_rows = bwd_block_n(box_d);  // keys a CTA (the K / V boxes' rows)
  if (d < 8 || d > BW_D || d % 8 || batch < 1 || batch > 65535 || hkv < 1 || hq < 1 ||
      hq % hkv != 0 || nq < 1 || nk < 1 || (nk + kv_rows - 1) / kv_rows > 65535 ||
      kv_valid_len < 0 || kv_valid_len > nk ||
      nq_pad < nq || nq_pad % BB_BLOCK_M || !aligned(q, 16) || !aligned(k, 16) ||
      !aligned(v, 16) || !aligned(dout, 16) || !aligned(lse, 16) || !aligned(delta, 16) ||
      !aligned(dq, 16) || !aligned(dk, 8) || !aligned(dv, 8) ||
      !tma_strides(q_sb, batch, q_sh, hq, q_sn, nq) ||
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
  BwdDenseParams p;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      box_d == 64    ? bwd_sm90_launch<64>(tm_q, tm_k, tm_v, tm_do, p, batch, s)
      : box_d == 128 ? bwd_sm90_launch<128>(tm_q, tm_k, tm_v, tm_do, p, batch, s)
                     : bwd_sm90_launch<BW_D>(tm_q, tm_k, tm_v, tm_do, p, batch, s);
  return static_cast<int>(e);
}

}  // extern "C"
