// K1 with an additive bias on bf16 K/V (flashattn_tpu/ops/flash_fwd.py:319-320):
// the instantiations of fwd_tile.cuh's kernel that a dense call with a bias
// and without a softcap runs when ops/flash_fwd.py::bias_route refuses it (a
// head dim other than 64 or 128; path A's calls take the wgmma kernel of
// flash_fwd_bias_sm90.cu), in a source of their own
// so that nvcc builds them in parallel with the other K1 families. Reached
// through fa_fwd (flash_fwd.cu).

#include "fwd_tile.cuh"

cudaError_t fa::fwd_bias_bf16(const FwdParams& p, int batch, cudaStream_t stream) {
  return fwd_launch<false, true, KV_BF16>(p, batch, stream);
}
