// K1 with logit soft-capping and an additive bias on bf16 K/V
// (flashattn_tpu/ops/flash_fwd.py:310-320, Gemma-2's attn_logit_softcapping
// with a bias) at head dims above 128 (below, K1's bias route in
// flash_fwd_bias_sm90.cu takes these calls; without a bias, K1's dense route
// in flash_fwd_sm90.cu takes every head dim): the instantiations of
// fwd_tile.cuh's body as fwd_softcap_kernel. In a source of its own so that
// nvcc builds it in parallel with the other K1 families. Reached through
// fa_fwd (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_softcap_bias_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  return fwd_launch_wide<true>(p, batch, stream);
}
