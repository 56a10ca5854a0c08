// K5 (dK, dV) and K6 (dQ) with a sliding window, with or without logit
// soft-capping: the instantiations of dkv_tile.cuh's and dq_tile.cuh's
// bodies as dkv_window_kernel and dq_window_kernel that soft-capped
// sliding-window training runs (flashattn_tpu/ops/flash_bwd.py:139, :234 with
// the window of flash_fwd.py:54-74). In a source of their own so that nvcc
// builds them in parallel with flash_bwd_split.cu, whose C entries call them
// and whose header says what K5 and K6 replace and what bounds them.

#include "dq_tile.cuh"

cudaError_t fa::dkv_window_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap) {
  return dispatch_head_dim(p.d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return cap ? launch_dkv<DP, true, true>(p, batch, stream)
               : launch_dkv<DP, false, true>(p, batch, stream);
  });
}

cudaError_t fa::dq_window_bf16(const BwdParams& p, int batch, cudaStream_t stream, bool cap) {
  return dispatch_head_dim(p.d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return cap ? launch_dq<DP, true, true>(p, batch, stream)
               : launch_dq<DP, false, true>(p, batch, stream);
  });
}
