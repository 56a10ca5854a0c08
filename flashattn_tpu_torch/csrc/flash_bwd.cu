// FlashAttention-2 backward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd_fused.py::
// _bwd_fused_kernel (K3, :110) and, with causal or a sliding window, the banded
// whole-sequence flashattn_tpu/ops/flash_bwd_fused.py::_bwd_causal_resident_kernel
// (K4, :336) and its long-sequence windowed route _bwd_macro_windowed (:651).
// It computes what they compute -- the single-pass 5-product backward, given
// the forward's row LSE and Delta = rowsum(dO * O) -- with the KV-tile body of
// dkv_tile.cuh (its header gives the formulas, the warp layout and the
// masks), instantiated with dQ. It is not a block-by-block copy:
//
//   * The TPU grid runs in order, so K3 keeps a whole-sequence f32 dQ
//     accumulator in VMEM and adds into it race-free. CTAs run in parallel
//     here, and a plain read-modify-write of dQ would race. This is the
//     FlashAttention-2 design instead: one CTA per (64-row KV tile, q-head,
//     batch) keeps dK and dV in registers and loops over the Q tiles that can
//     see its KV tile (with causal or a window, only those that meet the band
//     -- K4's band, and its macro route's KV slabs at long N); dQ is added
//     with f32 atomicAdd, from the visited tiles only, into a zeroed
//     [B, Hq, Nq, D] scratch that the wrapper allocates and casts once. (K5 + K6, csrc/flash_bwd_split.cu,
//     give a deterministic dQ in a second pass instead.)
//   * dQ and dK each carry `scale` exactly once (a dQ that came out x log2e
//     would be the reference's quirk, SURVEY.md section 6).
//
// What bounds it: the dQ atomics (Nk/64 adds per dQ element, through L2), the
// recomputed Q K^T (5 products instead of the forward's 2), and synchronous
// global->shared loads of each Q/dO tile behind a barrier, with little
// tensor-core work per barrier at D=128 (32-row Q tiles). Left for later PRs:
// wgmma on warpgroup tiles, TMA / cp.async pipelining of the Q/dO tiles, a
// larger KV tile per CTA (fewer atomics).

#include "dkv_tile.cuh"

extern "C" {

// dQ, dK, dV for q/do [B, Hq, Nq, D], k/v [B, Hkv, Nk, D] (bf16, unit stride
// on D, other strides in elements), lse/delta [B, Hq, Nq] f32 contiguous.
// dq [B, Hq, Nq, D] f32 contiguous must be zeroed (it is accumulated
// atomically); dk/dv [B, Hq, Nk, D] f32 contiguous are written per query
// head. Requires 8 <= D <= 128 with D % 8 == 0, Hq % Hkv == 0,
// 0 <= kv_valid_len <= Nk, Nq >= 1, Nk >= 1. causal != 0 masks kv_pos > q_pos
// (zero offsets); the window (wl, wr) masks kv_pos < q_pos - wl (wl >= 0) and
// kv_pos > q_pos + wr (wr >= 0). Returns a cudaError_t (0 on success).
int fa_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dq, void* dk, void* dv, int batch, int hq, int hkv,
                int nq, int nk, int d, int kv_valid_len, int causal, int wl, int wr,
                float scale, int64_t q_sb,
                int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh,
                int64_t do_sn, void* stream) {
  if (!bwd_args_ok(d, hq, hkv, nq, nk, kv_valid_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[14] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb,
                               v_sh, v_sn, do_sb, do_sh, do_sn, 0, 0};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, nullptr, nullptr, hq, hkv, nq, nk, d,
                           kv_valid_len, causal, wl, wr, scale, 0.f, strides);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool win = wl >= 0 || wr >= 0;
  return static_cast<int>(dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return win ? launch_dkv<DP, true, false, true>(p, batch, s)
               : launch_dkv<DP, true, false, false>(p, batch, s);
  }));
}

}  // extern "C"
