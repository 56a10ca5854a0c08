// K1 with an additive bias on bf16 K/V (flashattn_tpu/ops/flash_fwd.py:319-320):
// the instantiations of fwd_tile.cuh's kernel that a call with a bias and
// without a softcap runs at head dims above 128 (below, K1's bias route in
// flash_fwd_bias_sm90.cu takes it), in a source of their own so that nvcc
// builds them in parallel with the other K1 families. Reached through fa_fwd
// (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_bias_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  return fwd_launch_wide<false>(p, batch, stream);
}
