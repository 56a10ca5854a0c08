// K1 on the mma.sync body fwd_tile.cuh for Hopper (sm_90a): the C entry
// fa_fwd of the calls that no TMA + wgmma route takes -- int8 / fp8 K/V that
// are not decode-shaped, at every D (flash_fwd_int8.cu, flash_fwd_fp8.cu,
// with or without a bias). A bf16 call is K1's dense route's (fa_fwd_sm90,
// flash_fwd_sm90.cu) or, with a bias, its bias route's (fa_fwd_bias_sm90,
// flash_fwd_bias_sm90.cu), at every D up to 256, and fa_fwd refuses it.
// Segment ids, a window, q / kv offsets and the softcap are the Hopper
// routes' options: fa_fwd takes none of them.
//
// The kernel body, what it replaces (flashattn_tpu/ops/flash_fwd.py::
// _fwd_kernel, and by causal _fwd_causal_resident_kernel) and what bounds it
// are in fwd_tile.cuh. Each instantiation family lives in its own source so
// that one nvcc per source builds them in parallel.

#include "fwd_tile.cuh"

extern "C" {

// O and LSE for q [B, Hq, Nq, D] bf16 and k/v [B, Hkv, Nk, D] of kv_dtype
// (fa::KV_INT8 or KV_FP8; unit stride on D, other strides in elements); o
// has q's shape, lse is [B, Hq, Nq] f32 contiguous.
//   bias: f32 [B|1, Hq|1, Nq|1, Nk] with unit column stride and the given
//     (batch, head, row) strides, 0 on broadcast dims (null: no bias).
//   k_scale / v_scale: f32 per-token scales [B, Hkv, Nk] with the given
//     strides, required.
// Requires 8 <= D <= 256 with D % 8 == 0, Hq % Hkv == 0, 0 <= kv_valid_len
// <= Nk, Nq >= 1, int8 / fp8 K/V rows 8-byte aligned, softcap 0 (no cap:
// flash_attention_quantized has none); kv_dtype fa::KV_BF16 is refused
// (fa_fwd_sm90 and fa_fwd_bias_sm90 take every bf16 call). causal != 0
// masks kv_pos > q_pos (zero offsets). Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue for arguments it does not take).
int fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* bias, const void* k_scale, const void* v_scale, int kv_dtype,
           int batch, int hq, int hkv, int nq, int d, int kv_valid_len, int causal,
           float scale, float softcap,
           int64_t q_sb, int64_t q_sh, int64_t q_sn, int64_t k_sb, int64_t k_sh, int64_t k_sn,
           int64_t v_sb, int64_t v_sh, int64_t v_sn, int64_t o_sb, int64_t o_sh, int64_t o_sn,
           int64_t bias_sb, int64_t bias_sh, int64_t bias_sn, int64_t ks_sb, int64_t ks_sh,
           int64_t ks_sn, int64_t vs_sb, int64_t vs_sh, int64_t vs_sn, void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || hkv <= 0 || hq % hkv != 0 || nq <= 0 ||
      kv_valid_len < 0 || (kv_dtype != fa::KV_INT8 && kv_dtype != fa::KV_FP8) ||
      k_scale == nullptr || v_scale == nullptr || softcap != 0.f) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fa::FwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = k;
  p.v = v;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.bias = static_cast<const float*>(bias);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.bias_sb = bias_sb; p.bias_sh = bias_sh; p.bias_sn = bias_sn;
  p.ks_sb = ks_sb; p.ks_sh = ks_sh; p.ks_sn = ks_sn;
  p.vs_sb = vs_sb; p.vs_sh = vs_sh; p.vs_sn = vs_sn;
  p.hq = hq;
  p.rep = hq / hkv;
  p.nq = nq;
  p.d = d;
  p.kv_valid_len = kv_valid_len;
  p.causal = causal != 0;
  p.scale_log2 = scale * fa::LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      kv_dtype == fa::KV_INT8 ? fa::fwd_int8(p, batch, s) : fa::fwd_fp8(p, batch, s);
  return static_cast<int>(e);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
