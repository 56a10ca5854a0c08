// FlashAttention-2 two-kernel backward with an additive bias for Hopper
// (sm_90a), bf16 tensor cores: the C entries of K5 (dK, dV) and K6 (dQ, and
// dbias) for the bias calls that the Hopper bias route (bwd_bias_sm90.cu)
// refuses -- a bias with the logit softcap, the GQA decode fold, D 96.
//
// Replaces the TPU kernels flashattn_tpu/ops/flash_bwd.py::_dkv_kernel (K5,
// :139) and flashattn_tpu/ops/flash_bwd.py::_dq_kernel (K6, :234) for those
// calls. Without a bias K5 + K6 run as one launch of bwd_sm90_tile.cuh's
// TMA + wgmma body (flash_bwd_split_sm90.cu), with segment ids and the
// softcap; these entries take a bias only. Both recompute P and dS from the
// forward's row LSE (natural log) and Delta = rowsum(dO * O), as
// flash_bwd.py::_recompute_p_ds does:
//
//   S = Q K^T      x = S * scale * log2e + bias * log2e (floored at the mask)
//   P = exp2(x - LSE * log2e), 0 where masked
//   dP = dO V^T    dS = P * (dP - Delta) * scale
//
// so `scale` enters dK once (K5) and dQ once (K6). With softcap
// (flash_bwd.py:92-96, 220, 304): t = tanh(S * scale / cap), x = cap * log2e
// * t + bias * log2e and dS = P * (dP - Delta) * (1 - t^2) * scale. K5 and K6
// read the forward's f32 bias [B|1, H|1, Nq|1, Nk] through strides that are 0
// on broadcast dims, and K6 writes dbias = P * (dP - Delta) [B, Hq, Nq, Nk]
// in f32 when it is wanted (dq_tile.cuh). Masks: causal and the KV tail;
// masked pairs get P = 0 explicitly, and so do the pairs of a row the bias
// masks wholly (LSE = ln2 * mask from the forward: a mask-valued score would
// give exp2(mask - mask) = 1). The instantiations (dkv_bias_kernel,
// dq_bias_kernel, with or without softcap) are in flash_bwd_split_bias.cu;
// K5's body is dkv_tile.cuh, K6's dq_tile.cuh.
//
//   * K5 (dK, dV): one CTA per (b, q-head, 64-row KV tile) keeps dK and dV in
//     registers and loops over the Q tiles that can see its KV tile. dK/dV
//     are written per query head in f32; ops/flash.py sums each KV head's
//     group.
//   * K6 (dQ): one CTA per (b, q-head, 64-row Q tile), 16 Q rows per warp,
//     loops over the KV tiles that meet its rows. It recomputes S = Q K^T and
//     dP = dO V^T, turns the score accumulators into dS (bf16, as the TPU
//     kernel feeds the MXU) and uses them as the A operand of dQ += dS K
//     straight from registers (K's B fragments transposed by ldmatrix). dQ
//     stays in registers and is written once: no atomics.
//
// What bounds it: the recomputation -- 7 products per tile pair across the
// two kernels against the 5 of one launch -- and synchronous global->shared
// tile loads behind a barrier; a bias adds a 4-byte read per pair to each
// (from L2 when it broadcasts over heads), and dbias a 4-byte write per pair
// to K6 -- with dbias, K6 moves B * Hq * Nq * Nk * 4 bytes, which at N2048
// outweighs its Q/K/V/dO reads. Left for later PRs: these calls on the TMA +
// wgmma body (a bias with the softcap, the decode fold, D 96).

#include "dq_tile.cuh"

namespace {

// The checks of both entries: bwd_args_ok, a bias, softcap >= 0.
bool split_args_ok(int d, int hq, int hkv, int nq, int nk, int kv_valid_len, const void* bias,
                   float softcap) {
  return bwd_args_ok(d, hq, hkv, nq, nk, kv_valid_len) && bias != nullptr && softcap >= 0.f;
}

}  // namespace

extern "C" {

// Common arguments of both entries: q/do [B, Hq, Nq, D], k/v [B, Hkv, Nk, D]
// (bf16, unit stride on D, other strides in elements), lse/delta [B, Hq, Nq]
// f32 contiguous, bias f32 with unit column stride and (batch, head, row)
// strides bias_sb/sh/sn, 0 on broadcast dims (required: without a bias the
// backward is fa_bwd_split_sm90's). Requires 8 <= D <= 128 with D % 8 == 0,
// Hq % Hkv == 0, 0 <= kv_valid_len <= Nk, Nq >= 1, Nk >= 1. causal != 0
// masks kv_pos > q_pos (zero offsets); softcap > 0 is the forward's logit cap
// (0: none). Each returns a cudaError_t (0 on success).

// K5: dk/dv [B, Hq, Nk, D] f32 contiguous, written per query head.
int fa_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, const void* bias, void* dk, void* dv,
                    int batch, int hq, int hkv, int nq, int nk, int d, int kv_valid_len,
                    int causal, float scale, float softcap, int64_t q_sb, int64_t q_sh,
                    int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                    int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                    int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, void* stream) {
  if (!split_args_ok(d, hq, hkv, nq, nk, kv_valid_len, bias, softcap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[15] = {q_sb,  q_sh,  q_sn,  k_sb,    k_sh,    k_sn,   v_sb,   v_sh,
                               v_sn,  do_sb, do_sh, do_sn, bias_sb, bias_sh, bias_sn};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, bias, hq, hkv, nq, nk, d, kv_valid_len,
                           causal, scale, softcap, strides);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return static_cast<int>(
      fa::dkv_bias_bf16(p, batch, static_cast<cudaStream_t>(stream), softcap > 0.f));
}

// K6: dq [B, Hq, Nq, D] f32 contiguous, written once (no atomics, no zeroing);
// dbias [B, Hq, Nq, Nk] f32 contiguous (null: not wanted), written for the
// tiles K6 visits -- the caller zero-fills it when causal or kv_valid_len < Nk
// leave tiles unvisited.
int fa_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* bias, void* dq, void* dbias,
                   int batch, int hq, int hkv, int nq, int nk, int d, int kv_valid_len,
                   int causal, float scale, float softcap, int64_t q_sb, int64_t q_sh,
                   int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn, int64_t v_sb,
                   int64_t v_sh, int64_t v_sn, int64_t do_sb, int64_t do_sh, int64_t do_sn,
                   int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, void* stream) {
  if (!split_args_ok(d, hq, hkv, nq, nk, kv_valid_len, bias, softcap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t strides[15] = {q_sb,  q_sh,  q_sn,  k_sb,    k_sh,    k_sn,   v_sb,   v_sh,
                               v_sn,  do_sb, do_sh, do_sn, bias_sb, bias_sh, bias_sn};
  BwdParams p = bwd_params(q, k, v, dout, lse, delta, bias, hq, hkv, nq, nk, d, kv_valid_len,
                           causal, scale, softcap, strides);
  p.dq = static_cast<float*>(dq);
  p.dbias = static_cast<float*>(dbias);
  return static_cast<int>(
      fa::dq_bias_bf16(p, batch, static_cast<cudaStream_t>(stream), softcap > 0.f));
}

}  // extern "C"
