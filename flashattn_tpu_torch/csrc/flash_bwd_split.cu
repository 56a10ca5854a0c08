// FlashAttention-2 two-kernel backward for Hopper (sm_90a), bf16 tensor cores.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5,
// :139) and flashattn_tpu/ops/flash_bwd.py::_dq_kernel (K6, :234), the pair
// that the JAX package's _flash_core_bwd runs whenever the single-pass K3
// cannot (here: with segment ids, logit soft-capping or a bias; later also
// dynamic offsets). Both recompute P and dS from the forward's
// row LSE (natural log) and Delta = rowsum(dO * O), as
// flash_bwd.py::_recompute_p_ds does:
//
//   S = Q K^T      P = exp2(S * scale * log2e - LSE * log2e), 0 where masked
//   dP = dO V^T    dS = P * (dP - Delta) * scale
//
// so `scale` enters dK once (K5) and dQ once (K6). With softcap
// (flash_bwd.py:92-96, 220, 304): t = tanh(S * scale / cap),
// P = exp2(cap * log2e * t - LSE * log2e) and dS = P * (dP - Delta) *
// (1 - t^2) * scale; the soft-capped instantiations are kernels of their own
// name (dkv_softcap_kernel, dq_softcap_kernel). Masks: causal and the sliding
// window (the band of fwd_tile.cuh: absolute positions, zero offsets), the
// KV tail, and segments -- pair (i, j) attends iff seg_q[i] == seg_kv[j] --
// AND-composed; masked pairs get P = 0 explicitly. As in K1, the window is a
// template parameter: its instantiations (dkv_window_kernel,
// dq_window_kernel, with or without softcap) are in
// flash_bwd_split_window.cu, so that nvcc builds them in parallel with this
// source; K6's body is in dq_tile.cuh, K5's in dkv_tile.cuh. So are the
// bias instantiations (dkv_bias_kernel, dq_bias_kernel, with or without
// softcap), in flash_bwd_split_bias.cu: K5 and K6 read the forward's f32 bias
// [B|1, H|1, Nq|1, Nk] through strides that are 0 on broadcast dims, add it
// in the forward's log2 domain, and K6 writes dbias = P * (dP - Delta)
// [B, Hq, Nq, Nk] in f32 when it is wanted (dq_tile.cuh).
// A dead row (no key of its segment) has LSE = ln2 * mask from the forward,
// and a mask-valued score would give exp2(mask - mask) = 1, so the mask is
// never left to underflow. Tiles whose id ranges are disjoint are skipped
// (flash.py::_seg_block_flags, computed per tile in the kernel from the ids),
// so a row whose every tile is skipped gets dQ = 0 and gives dK/dV nothing.
//
//   * K5 (dK, dV): the KV-tile body of dkv_tile.cuh without dQ -- one CTA per
//     (b, q-head, 64-row KV tile) keeps dK and dV in registers and loops over
//     the Q tiles that can see its KV tile: those that meet the band when
//     causal or windowed, skipping Q tiles of other documents. dK/dV are written per query head
//     in f32, as K3 writes them; ops/flash.py sums each KV head's group.
//   * K6 (dQ): one CTA per (b, q-head, 64-row Q tile), 16 Q rows per warp,
//     loops over the KV tiles that meet the band (as K1 does), skipping KV
//     tiles of other documents. It recomputes S = Q K^T and dP = dO V^T as the forward
//     computes S, turns the score accumulators into dS (bf16, as the TPU
//     kernel feeds the MXU) and uses them as the A operand of dQ += dS K
//     straight from registers (K's B fragments transposed by ldmatrix). dQ
//     stays in registers and is written once: no atomics, so dQ is
//     deterministic, unlike K3's.
//   * Segment ids are int32 [B, N] with unit stride along the sequence and
//     are read only below Nq and kv_valid_len, so the TPU's -1/-2 padding
//     sentinels have no counterpart.
//
// What bounds it: the recomputation -- 7 products per tile pair across the
// two kernels against K3's 5 -- and synchronous global->shared tile loads
// behind a barrier (as K1 and K3). At 8 documents per row most tile pairs
// are skipped, so the work follows the per-document areas; with a window it
// follows the band's area. Softcap adds a tanhf per pair to each kernel; a
// bias adds a 4-byte read per pair to each (from L2 when it broadcasts over
// heads), and dbias a 4-byte write per pair to K6 -- with dbias, K6 moves
// B * Hq * Nq * Nk * 4 bytes, which at N2048 outweighs its Q/K/V/dO reads.
// Left for later PRs: a bias with a window or segments, dynamic offsets,
// wgmma and TMA/cp.async pipelining.

#include "dq_tile.cuh"

namespace {

// The checks of both entries: bwd_args_ok, ids in pairs, a bias without
// segments or a window (as K1 takes it), softcap >= 0.
bool split_args_ok(int d, int hq, int hkv, int nq, int nk, int kv_valid_len, const void* seg_q,
                   const void* seg_kv, const void* bias, int wl, int wr, float softcap) {
  return bwd_args_ok(d, hq, hkv, nq, nk, kv_valid_len) && (seg_q == nullptr) == (seg_kv == nullptr) &&
         softcap >= 0.f && (bias == nullptr || (seg_q == nullptr && wl < 0 && wr < 0));
}

void set_bias(BwdParams* p, const void* bias, int64_t sb, int64_t sh, int64_t sn) {
  p->bias = static_cast<const float*>(bias);
  p->bias_sb = sb;
  p->bias_sh = sh;
  p->bias_sn = sn;
}

}  // namespace

extern "C" {

// Common arguments of both entries: q/do [B, Hq, Nq, D], k/v [B, Hkv, Nk, D]
// (bf16, unit stride on D, other strides in elements), lse/delta [B, Hq, Nq]
// f32 contiguous, seg_q [B, Nq] / seg_kv [B, Nk] int32 segment ids with unit
// stride along the sequence (both null: no segments), bias f32 with unit
// column stride and (batch, head, row) strides bias_sb/sh/sn, 0 on broadcast
// dims (null: no bias; not with segments or a window). Requires
// 8 <= D <= 128 with D % 8 == 0, Hq % Hkv == 0, 0 <= kv_valid_len <= Nk,
// Nq >= 1, Nk >= 1. causal != 0 masks kv_pos > q_pos (zero offsets); the
// window (wl, wr) masks kv_pos < q_pos - wl (wl >= 0) and kv_pos > q_pos + wr
// (wr >= 0); softcap > 0 is the forward's logit cap (0: none). Each returns a
// cudaError_t (0 on success).

// K5: dk/dv [B, Hq, Nk, D] f32 contiguous, written per query head.
int fa_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* seg_q, const void* seg_kv,
                    const void* bias, void* dk, void* dv, int batch, int hq, int hkv, int nq, int nk, int d,
                    int kv_valid_len, int causal, int wl, int wr, float scale, float softcap,
                    int64_t q_sb, int64_t q_sh,
                    int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                    int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                    int64_t seg_q_sb, int64_t seg_kv_sb, int64_t bias_sb, int64_t bias_sh,
                    int64_t bias_sn, void* stream) {
  if (!split_args_ok(d, hq, hkv, nq, nk, kv_valid_len, seg_q, seg_kv, bias, wl, wr, softcap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[14] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,  v_sb,
                               v_sh, v_sn, do_sb, do_sh, do_sn, seg_q_sb, seg_kv_sb};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, seg_q, seg_kv, hq, hkv, nq, nk, d,
                           kv_valid_len, causal, wl, wr, scale, softcap, strides);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  set_bias(&p, bias, bias_sb, bias_sh, bias_sn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (bias != nullptr) return static_cast<int>(fa::dkv_bias_bf16(p, batch, s, cap));
  if (wl >= 0 || wr >= 0) return static_cast<int>(fa::dkv_window_bf16(p, batch, s, cap));
  return static_cast<int>(dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return cap ? launch_dkv<DP, true, false>(p, batch, s)
               : launch_dkv<DP, false, false>(p, batch, s);
  }));
}

// K6: dq [B, Hq, Nq, D] f32 contiguous, written once (no atomics, no zeroing);
// with a bias, dbias [B, Hq, Nq, Nk] f32 contiguous (null: not wanted), written
// for the tiles K6 visits -- the caller zero-fills it when causal or
// kv_valid_len < Nk leave tiles unvisited.
int fa_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg_q, const void* seg_kv,
                   const void* bias, void* dq, void* dbias, int batch, int hq, int hkv, int nq, int nk, int d,
                   int kv_valid_len, int causal, int wl, int wr, float scale, float softcap,
                   int64_t q_sb, int64_t q_sh,
                   int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                   int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                   int64_t seg_q_sb, int64_t seg_kv_sb, int64_t bias_sb, int64_t bias_sh,
                   int64_t bias_sn, void* stream) {
  if (!split_args_ok(d, hq, hkv, nq, nk, kv_valid_len, seg_q, seg_kv, bias, wl, wr, softcap) ||
      (dbias != nullptr && bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[14] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,  v_sb,
                               v_sh, v_sn, do_sb, do_sh, do_sn, seg_q_sb, seg_kv_sb};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, seg_q, seg_kv, hq, hkv, nq, nk, d,
                           kv_valid_len, causal, wl, wr, scale, softcap, strides);
  p.dq = static_cast<float*>(dq);
  p.dbias = static_cast<float*>(dbias);
  set_bias(&p, bias, bias_sb, bias_sh, bias_sn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  if (bias != nullptr) return static_cast<int>(fa::dq_bias_bf16(p, batch, s, cap));
  if (wl >= 0 || wr >= 0) return static_cast<int>(fa::dq_window_bf16(p, batch, s, cap));
  return static_cast<int>(dispatch_head_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return cap ? launch_dq<DP, true, false>(p, batch, s) : launch_dq<DP, false, false>(p, batch, s);
  }));
}

}  // extern "C"
