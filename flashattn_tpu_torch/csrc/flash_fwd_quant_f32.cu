// K1's quantized route on an f32 q for Hopper (sm_90a): the 24
// instantiations (D 64, 128 and 256, int8 and e4m3 K/V, without and with a
// bias, without and with segment ids) of fwd_sm90_tile.cuh's quantized body
// in its F32Q form, fwd_quant_f32_kernel<D, KV, BIAS, SEG>, in a source of
// their own so that their nvcc runs beside flash_fwd_quant_sm90.cu's, which
// holds the C entry fa_fwd_quant_f32 (the split of q, the maps).
//
// Replaces the TPU kernel flashattn_tpu/ops/flash_fwd.py::_fwd_kernel (K1,
// :115) on an f32 q over int8 / fp8 K/V (and, with causal or a window, K2,
// :516): there mm_dtype is f32 at Precision.HIGHEST (:232-238), k_scale goes
// on the f32 score columns (:304-309) and v_scale on P before P V
// (:341-350). It computes that: q as its three bf16 pieces (x = x0 + x1 +
// x2, ops/f32_split.py), the 8-bit K / V widened exactly to bf16 (one piece
// each: splitting them would triple the bytes of a cache whose point is to
// halve them), S = q0 K + q1 K + q2 K, x = s k_scale[col] scale log2 e in
// f32, the online softmax by exp2f, P v_scale[col] split into three bf16
// pieces, O += P0 V + P1 V + P2 V, O and the LSE in f32. No softcap, as in
// the JAX package with quantized K/V.
//
// What bounds it: operations. At the f32 LM's prefill (B1 Hq16 Hkv8 N2048
// D128 causal) the two products are 17.2 GFLOP, three bf16 products each:
// 0.052 ms at 989 TFLOP/s, half the f32 route's 0.104 ms (six products).
// The design is the bf16-q quantized body's (its notes in
// flash_fwd_quant_sm90.cu) with Q's three pieces in shared memory: at D 64 /
// 128 a CTA keeps 128 Q rows (96 KB of pieces at D 128, beside 2 bf16 stages
// and 6 8-bit slots); at D 256 it takes 64 Q rows with one consumer
// warpgroup (FqSmem), as K1's f32 route's D 256 form does.

#include "fwd_sm90_tile.cuh"

namespace {

template <int D, int KV, bool BIAS, bool SEG>
__global__ void __launch_bounds__(FqSmem<D, true>::THREADS, 1)
    fwd_quant_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k8,
                         const __grid_constant__ CUtensorMap tm_v8, const FwdQuantParams p) {
  fwd_quant_sm90_body<D, KV, BIAS, SEG, true>(tm_q, tm_k8, tm_v8, p);
}

template <int D, int KV>
cudaError_t fwd_quant_f32_dispatch(const CUtensorMap& tm_q, const CUtensorMap& tm_k8,
                                   const CUtensorMap& tm_v8, const FwdQuantParams& p, int batch,
                                   cudaStream_t s) {
  using S = FqSmem<D, true>;
  const bool bias = p.bias != nullptr, seg = p.seg_q != nullptr;
  auto kernel = bias ? (seg ? fwd_quant_f32_kernel<D, KV, true, true>
                            : fwd_quant_f32_kernel<D, KV, true, false>)
                     : (seg ? fwd_quant_f32_kernel<D, KV, false, true>
                            : fwd_quant_f32_kernel<D, KV, false, false>);
  return fwd_sm90_launch(kernel, S::BYTES, tm_q, tm_k8, tm_v8, p, batch, s, S::BM, S::THREADS);
}

template <int D>
cudaError_t fwd_quant_f32_kv(const CUtensorMap& tm_q, const CUtensorMap& tm_k8,
                             const CUtensorMap& tm_v8, const FwdQuantParams& p, int kv_dtype,
                             int batch, cudaStream_t s) {
  return kv_dtype == KV_INT8
             ? fwd_quant_f32_dispatch<D, KV_INT8>(tm_q, tm_k8, tm_v8, p, batch, s)
             : fwd_quant_f32_dispatch<D, KV_FP8>(tm_q, tm_k8, tm_v8, p, batch, s);
}

}  // namespace

cudaError_t fa::fwd_quant_f32(const CUtensorMap& tm_q, const CUtensorMap& tm_k8,
                              const CUtensorMap& tm_v8, const FwdQuantParams& p, int kv_dtype,
                              int batch, cudaStream_t stream) {
  return p.d <= 64    ? fwd_quant_f32_kv<64>(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, stream)
         : p.d <= 128 ? fwd_quant_f32_kv<128>(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, stream)
                      : fwd_quant_f32_kv<256>(tm_q, tm_k8, tm_v8, p, kv_dtype, batch, stream);
}
