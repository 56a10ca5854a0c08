// K5 (dK, dV) and K6 (dQ, and dbias) with an additive bias, with or without
// logit soft-capping: the instantiations of dkv_tile.cuh's and dq_tile.cuh's
// bodies as dkv_bias_kernel and dq_bias_kernel that bias-gradient training
// runs (flashattn_tpu/ops/flash_bwd.py:139, :234 with the bias of
// flash_bwd.py:97-98 and the dbias of :300-302). In a source of their own so
// that nvcc builds them in parallel with flash_bwd_split.cu, whose C entries
// call them and whose header says what K5 and K6 replace and what bounds
// them. Causal and the KV tail stay runtime; there is no bias x window and no
// bias x segments, because K1 takes neither (ops/flash_fwd.py).

#include "dq_tile.cuh"

cudaError_t fa::dkv_bias_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap) {
  return dispatch_head_dim(p.d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return cap ? launch_dkv<DP, false, true, false, true>(p, batch, stream)
               : launch_dkv<DP, false, false, false, true>(p, batch, stream);
  });
}

cudaError_t fa::dq_bias_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap) {
  return dispatch_head_dim(p.d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return cap ? launch_dq<DP, true, false, true>(p, batch, stream)
               : launch_dq<DP, false, false, true>(p, batch, stream);
  });
}
